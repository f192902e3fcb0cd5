"""Training driver, one process or data-parallel over several (PyTorch
port of ``daft_exprt_tpu/train.py``).

The loop follows the JAX driver: dynamic per-speaker stats refreshed every
``stats_refresh_interval`` iterations, the normalised batch plus the raw
frame prosody for the consistency losses, per-iteration loss logging
(Python logging and, where a writer imports, TensorBoard), validation
every ``iters_check_for_model_improvement`` iterations with a best-model
checkpoint, a checkpoint every ``iters_per_checkpoint`` iterations and at
the end, and resume from ``hparams.checkpoint``. Batches are made on the
host and moved to the device per step.

Data parallel (``mesh``, or any initialised process group): one process a
rank, each reading the sampler shard ``host_id::num_hosts`` of every epoch
at a local batch of ``batch_size * (replicas // num_hosts)``, the step
reducing gradients once a step (``parallel/train_step.py``); only the chief
(host 0) logs, writes TensorBoard and saves checkpoints, and every rank
waits at a barrier after each save; validation takes each global batch's
losses, as JAX's does (the ranks' b-th batches together, global
denominators), and averages them over the batches.

Precision: float32 matmuls run in full float32 (PyTorch's default); cuDNN's
TF32 for float32 convolutions stays at PyTorch's default (on), as the JAX
package leaves XLA's default precision for the same convs on the TPU. The
parity tests run on the CPU, where there is no TF32.
"""
import json
import logging
import math
import os
import time

import numpy as np
import torch.distributed as dist

from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.data import (
    DynamicSpeakerStatsManager, prepare_data_iterators,
)
from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.loss import loss_cfg_from_hparams
from daft_exprt_torch.models.daft_exprt import DaftExprt
from daft_exprt_torch.models.pitch_predictor import PitchPredictor
from daft_exprt_torch.parallel.mesh import make_mesh, mesh_device
from daft_exprt_torch.parallel.train_step import (
    make_eval_step, make_optimizer, make_train_step, to_device,
)
from daft_exprt_torch.utils.logger import DaftExprtLogger

_logger = logging.getLogger(__name__)


def check_train_config(hparams):
    """Feature-config consistency between preprocessing and training."""
    ok = True
    with open(hparams.training_files, 'r', encoding='utf-8') as f:
        feature_dirs = {line.strip().split('|')[0] for line in f
                        if line.strip()}
    for d in feature_dirs:
        cfg_path = os.path.join(d, 'config.json')
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                ok &= hparams.features_config_matches(json.load(f))
    if not ok:
        raise ValueError('feature extraction config mismatch — re-run '
                         'pre_process or align hyper-parameters')


def load_frozen_pitch_predictor(hparams, device=None):
    """The frozen pitch predictor of the consistency loss on ``device``, or
    None when ``pitch_predictor_path`` is empty or its weight is 0. The
    file (loaded with ``weights_only=True``) holds the port's
    ``PitchPredictor`` state dict, or the reference predictor's
    (``conv_layers.*``), bare or under 'state_dict'."""
    path = getattr(hparams, 'pitch_predictor_path', '')
    weight = getattr(hparams, 'pitch_consistency_weight', 0.0)
    if not path or weight <= 0:
        return None
    sd = ckpt.torch_load_guarded(path)
    sd = sd.get('state_dict', sd)
    sd = {(k[len('module.'):] if k.startswith('module.') else k): v
          for k, v in sd.items()}
    if any(k.startswith('conv_layers.') for k in sd):
        sd = ckpt.convert_reference_pitch_predictor(sd)
    model = PitchPredictor(n_mel_channels=hparams.n_mel_channels)
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).frozen()


def init_model_and_state(hparams, device=None, seed=None):
    """The model (seeded random parameters, in training mode) and its
    optimizer, on ``device`` (default cuda)."""
    model = DaftExprt.from_hparams(
        hparams, device=device,
        seed=seed if seed is not None else hparams.seed).train()
    return model, make_optimizer(model, hparams)


def train(hparams, num_iterations=None, device=None, log_every=1, mesh=None,
          host_id=None, num_hosts=None):
    """Run the training loop on ``device`` (default cuda; raises without it
    unless given 'cpu'); returns (model, final metrics as floats).

    ``mesh``: a data mesh (``make_mesh(n_model=1)``); where a process group
    is initialised and none is given, one over the whole world. ``host_id``
    and ``num_hosts`` default to the process group's rank and world size
    (0 and 1 without one)."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(n_model=1, device=device)
    dev = mesh_device(mesh, device)
    if mesh is not None and mesh.n_model != 1:
        raise ValueError('the acoustic step is data-parallel only: make the '
                         f'mesh with n_model=1, not {mesh.n_model}')
    distributed = dist.is_initialized()
    if host_id is None:
        host_id = dist.get_rank() if distributed else 0
    if num_hosts is None:
        num_hosts = dist.get_world_size() if distributed else 1
    is_chief = host_id == 0
    group = None if mesh is None else mesh.data_group
    n_replicas = 1 if mesh is None else mesh.size
    local_batch = hparams.batch_size * max(1, n_replicas // num_hosts)
    check_train_config(hparams)
    os.makedirs(hparams.output_directory, exist_ok=True)

    model, optimizer = init_model_and_state(hparams, dev)
    lr_fn = optimizer.lr_fn
    loss_cfg = loss_cfg_from_hparams(hparams)
    pitch_predictor = load_frozen_pitch_predictor(hparams, dev)

    iteration, best_val_loss = 0, float('inf')
    if hparams.checkpoint:
        payload, meta = ckpt.load_checkpoint(hparams.checkpoint)
        model.load_state_dict(payload['model'])
        if payload.get('optimizer') is not None:
            optimizer.load_state_dict(payload['optimizer'])
        iteration = int(meta.get('iteration', 0))
        best_val_loss = float(meta.get('best_val_loss', float('inf')))
        if is_chief:
            _logger.info(f'resumed from {hparams.checkpoint} at iteration '
                         f'{iteration}')

    train_step = make_train_step(
        model, optimizer, loss_cfg, pitch_predictor,
        accumulation_steps=hparams.accumulation_steps,
        grad_clip=hparams.grad_clip_thresh, mesh=mesh)
    eval_step = make_eval_step(model, loss_cfg, pitch_predictor, mesh=mesh)

    train_it, val_it, nb_examples = prepare_data_iterators(
        hparams, batch_size=local_batch * hparams.accumulation_steps,
        host_id=host_id, num_hosts=num_hosts)
    if is_chief:
        _logger.info(
            f'{nb_examples} training examples; effective batch '
            f'{hparams.batch_size * hparams.accumulation_steps * n_replicas}'
            f' ({hparams.batch_size}/replica x {hparams.accumulation_steps} '
            f'accum x {n_replicas} replicas)')

    stats_manager = DynamicSpeakerStatsManager(hparams)
    refresh_interval = getattr(hparams, 'stats_refresh_interval', 100)
    tb = DaftExprtLogger(os.path.join(hparams.output_directory, 'logs')) \
        if is_chief else None

    def save(name):
        if is_chief:
            _save(hparams, name, model, optimizer, iteration, lr_fn,
                  best_val_loss)
        if group is not None:
            dist.barrier(group=group)

    num_iterations = num_iterations or hparams.nb_iterations
    epochs = max(1, math.ceil((num_iterations - iteration)
                              / max(1, len(train_it))))
    start = time.time()
    metrics = {}
    done = iteration >= num_iterations
    for epoch in range(epochs):
        if done:
            break
        train_it.set_epoch(epoch)
        for batch, _, _ in train_it:
            if iteration % refresh_interval == 0:
                stats_manager.refresh_stats()
            norm_batch = stats_manager.process_batch(batch)
            raw_frames = {'frames_energy': batch['frames_energy'],
                          'frames_pitch': batch['frames_pitch']}
            metrics = train_step(to_device(norm_batch, dev),
                                 to_device(raw_frames, dev), iteration,
                                 hparams.seed)
            iteration += 1

            if is_chief and iteration % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                duration = time.time() - start
                start = time.time()
                lr = lr_fn(iteration)
                _logger.info(
                    f"Train loss [{iteration}]: {m['loss']:.6f} "
                    f"Grad Norm {m['grad_norm']:.6f} {duration:.2f}s/it "
                    f"(LR {lr:.6f})")
                tb.log_training(
                    m['loss'], {k: v for k, v in m.items()
                                if k not in ('loss', 'grad_norm')},
                    m['grad_norm'], lr, duration, iteration)

            if iteration % hparams.iters_check_for_model_improvement == 0:
                val_loss = validate(eval_step, val_it, stats_manager, dev,
                                    tb, iteration, mesh, is_chief)
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    save('best_model')

            if iteration % hparams.iters_per_checkpoint == 0:
                save(f'DaftExprt_{iteration}')

            if iteration >= num_iterations:
                done = True
                break

    save(f'DaftExprt_{iteration}')
    if tb is not None:
        tb.close()
    return model, {k: float(v) for k, v in metrics.items()}


def validate(eval_step, val_it, stats_manager, device, tb=None, iteration=0,
             mesh=None, log=True):
    """Mean validation loss over ``val_it``'s batches (inf when there are
    none), as JAX's validate. With a ``mesh`` (``eval_step`` made with
    it), each batch's losses are the global batch's: the ranks' b-th
    batches together. Where the shards differ by a batch, a rank whose
    shard has ended joins the others with no rows until every shard has,
    so every rank averages the same global batches. ``log``: write the
    loss to the logger (and ``tb``)."""
    losses, indiv_acc = [], None
    batches = iter(val_it)
    while True:
        item = next(batches, None)
        if item is not None:
            norm_batch = stats_manager.process_batch(item[0])
            raw = {'frames_energy': item[0]['frames_energy'],
                   'frames_pitch': item[0]['frames_pitch']}
            metrics, _ = eval_step(to_device(norm_batch, device),
                                   to_device(raw, device))
        elif mesh is not None:
            metrics, _ = eval_step(None, None)
        else:
            metrics = None
        if metrics is None:
            break
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m.pop('loss'))
        indiv_acc = m if indiv_acc is None else \
            {k: indiv_acc[k] + v for k, v in m.items()}
    if not losses:
        return float('inf')
    val_loss = float(np.mean(losses))
    indiv = {k: v / len(losses) for k, v in indiv_acc.items()}
    if log:
        _logger.info(f'Validation loss [{iteration}]: {val_loss:.6f}')
    if tb is not None:
        tb.log_validation(val_loss, indiv, iteration)
    return val_loss


def _save(hparams, name, model, optimizer, iteration, lr_fn, best_val_loss):
    path = os.path.join(hparams.output_directory, 'checkpoints', name)
    config_params = {k: v for k, v in hparams.__dict__.items()
                     if isinstance(v, (int, float, str, bool, list, dict))}
    ckpt.save_checkpoint(path, model.state_dict(), optimizer.state_dict(),
                         iteration=iteration,
                         learning_rate=float(lr_fn(iteration)),
                         best_val_loss=best_val_loss,
                         config_params=config_params)
    _logger.info(f'saved checkpoint {path}')


def launch_training(hparams, **kwargs):
    """Entry point of a training run: a ``training.log`` handler on the
    ``daft_exprt_torch`` logger and ``config.json`` in the output directory
    (the chief only), then :func:`train` with ``kwargs``. The handler is
    removed when ``train`` returns, so launches in one process do not stack
    handlers."""
    host_id = kwargs.get('host_id')
    if host_id is None:
        host_id = dist.get_rank() if dist.is_initialized() else 0
    handler = None
    if host_id == 0:
        os.makedirs(hparams.output_directory, exist_ok=True)
        handler = logging.FileHandler(
            os.path.join(hparams.output_directory, 'training.log'))
        handler.setLevel(logging.INFO)
        logging.getLogger('daft_exprt_torch').addHandler(handler)
        hparams.save_hyper_params(
            os.path.join(hparams.output_directory, 'config.json'))
    try:
        return train(hparams, **kwargs)
    finally:
        if handler is not None:
            logging.getLogger('daft_exprt_torch').removeHandler(handler)
            handler.close()

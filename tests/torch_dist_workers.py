"""Rank functions of the port's multi-process CPU tests, run through
``daft_exprt_torch.parallel.launch.run_ranks`` (gloo, one torch thread a
rank). They import torch and the port only, so a spawned rank does not
load JAX; everything they return is host data."""
import contextlib
import io
import logging

import numpy as np
import torch
import torch.distributed as dist

from daft_exprt_torch.bridge import (
    acoustic_state_from_jax, generator_from_jax, pitch_predictor_from_jax,
)
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.loss import compute_loss, loss_cfg_from_hparams
from daft_exprt_torch.models.daft_exprt import DaftExprt
from daft_exprt_torch.models.pitch_predictor import PitchPredictor
from daft_exprt_torch.parallel import train_step as pts
from daft_exprt_torch.parallel.mesh import (
    data_rows, grid_coords, make_mesh, shard_batch,
)
from daft_exprt_torch.train import validate


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _local(batch, mesh):
    """This rank's rows of a global batch (a dict of arrays)."""
    lo, hi = data_rows(len(next(iter(batch.values()))), mesh)
    return {k: v[lo:hi] for k, v in batch.items()}


class _Normalised:
    """A stats manager whose ``process_batch`` hands back the normalised
    batch made beside each validation batch."""

    def __init__(self, norm):
        self.norm = norm

    def process_batch(self, batch):
        return self.norm[id(batch)]


def val_batches(pairs):
    """(val_it, stats_manager) for a ``validate`` (the port's or JAX's)
    over ``pairs`` of (normalised batch, raw frames): each item is the
    batch with its raw frames, from which the manager gives back the
    normalised batch."""
    items, norm = [], {}
    for batch, raw in pairs:
        item = dict(batch, **raw)
        norm[id(item)] = batch
        items.append((item, None, None))
    return items, _Normalised(norm)


def port_acoustic(hp_kw, np_params, ppv, n_mel):
    """The port's model (JAX params bridged), its optimizer and the frozen
    pitch predictor, on the CPU."""
    hp = HyperParams(**hp_kw)
    model = DaftExprt.from_hparams(hp, device='cpu').load_bridged(
        acoustic_state_from_jax(np_params))
    pp = PitchPredictor(n_mel)
    pp.load_state_dict(pitch_predictor_from_jax(ppv['params'],
                                                ppv['batch_stats']))
    return hp, model, pts.make_optimizer(model, hp), pp.frozen()


def ddp_train_step(rank, hp_kw, np_params, ppv, n_mel, batch, raw, runs,
                   iterations, val):
    """For each (accumulation_steps, n_steps) of ``runs``: the data-parallel
    step over a data mesh of the world on this rank's rows of the global
    ``batch``; each step's metrics and parameters, the first step's
    gradients, the eval step's metrics over the mesh, ``validate`` over
    this rank's (normalised batch, raw frames) pairs ``val[rank]``, and
    this rank's loss computed on its own rows alone (no group: what an
    average of per-replica losses would take), the last three at the
    initial parameters."""
    mesh = make_mesh(device='cpu')
    out = {}
    for accum, n_steps in runs:
        hp, model, opt, pp = port_acoustic(
            dict(hp_kw, accumulation_steps=accum), np_params, ppv, n_mel)
        cfg = loss_cfg_from_hparams(hp)
        b = shard_batch(_local(batch, mesh), mesh)
        r = shard_batch(_local(raw, mesh), mesh)
        with torch.no_grad():
            res = model(**{k: b[k] for k in pts.MODEL_INPUT_KEYS})
            local_loss = float(compute_loss(res, pts._targets(b, r),
                                            iterations[0], cfg, pp)[0])
        eval_step = pts.make_eval_step(model, cfg, pp, mesh=mesh)
        evaluated = {k: float(v) for k, v in eval_step(b, r)[0].items()}
        val_loss = validate(eval_step, *val_batches(val[rank]), 'cpu',
                            mesh=mesh, log=False)
        step = pts.make_train_step(model, opt, cfg, pp, accum, mesh=mesh)
        steps = []
        for n, it in enumerate(iterations[:n_steps]):
            m = step(b, r, it, 0)
            rec = {'metrics': {k: float(v) for k, v in m.items()},
                   'params': {k: _numpy(p) for k, p in
                              model.named_parameters()}}
            if n == 0:
                rec['grads'] = {k: _numpy(p.grad) for k, p in
                                model.named_parameters()}
            steps.append(rec)
        out[accum] = {'local_loss': local_loss, 'eval': evaluated,
                      'validate': val_loss, 'steps': steps}
    return out


def mesh_layout(rank, n_global):
    """This rank's (2, 2) mesh: coordinates, the ranks of its data and
    model groups, its rows of a global batch (``data_rows``, then
    ``shard_batch``), and the errors of a grid too large and of rows that
    do not divide; then a (1, 2) mesh, which leaves ranks 2 and 3 outside;
    then what ``dryrun_multichip`` over the world printed on this rank."""
    mesh = make_mesh(n_data=2, n_model=2, device='cpu')
    glob = {'x': np.arange(n_global * 3, dtype=np.float32).reshape(
        n_global, 3), 'ids': np.arange(n_global, dtype=np.int64)}
    out = {
        'coords': (mesh.data_rank, mesh.model_rank),
        'grid_coords': grid_coords(rank, 2, 2),
        'shape': (mesh.n_data, mesh.n_model),
        'data_ranks': dist.get_process_group_ranks(mesh.data_group),
        'model_ranks': dist.get_process_group_ranks(mesh.model_group),
        'rows': {k: v.numpy() for k, v in shard_batch(
            _local(glob, mesh), mesh).items()},
    }
    for name, call in (
            ('too_large', lambda: make_mesh(n_data=3, n_model=2,
                                            device='cpu')),
            ('not_dividing', lambda: data_rows(n_global + 1, mesh)),
            ('ragged', lambda: shard_batch(
                {'x': np.zeros((2, 1)), 'y': np.zeros((3, 1))}, mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out['small'] = make_mesh(n_data=1, n_model=2, device='cpu') is not None
    out['dryrun'] = dryrun(dist.get_world_size())
    return out


def dryrun(n):
    """``dryrun_multichip(n)`` on this rank; returns what it printed."""
    from daft_exprt_torch.parallel.dryrun import dryrun_multichip
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(n, device='cpu')
    return buf.getvalue()


def tp_vocoder(rank, np_params, config, mel):
    """The specs of the full params on a (2, 2) mesh, this rank's leaf
    shapes after sharding, and the tensor-parallel waveform of this rank's
    rows (``rows``: lo, hi) of the global batch ``mel``."""
    from daft_exprt_torch.parallel.vocoder_sharding import (
        generator_param_specs, make_sharded_vocoder, shard_generator_params,
    )
    mesh = make_mesh(n_data=2, n_model=2, device='cpu')
    params = generator_from_jax(np_params)
    sharded = shard_generator_params(params, mesh)
    lo, hi = data_rows(len(mel), mesh)
    with torch.no_grad():
        wav = make_sharded_vocoder(mesh, config)(sharded, mel[lo:hi])
    shapes = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                shapes['/'.join(path + (k,))] = tuple(v.shape)
    walk(sharded)
    return {'specs': generator_param_specs(params, mesh), 'shapes': shapes,
            'wav': wav.numpy(), 'rows': (lo, hi)}


def _gan_state(config, seed, mel, y, mesh=None):
    """One d_step and one g_step of the port's GAN steps on the CPU from
    seeded weights (the generator ``seed``, the discriminators ``seed +
    1``), on the global batch (``mesh=None``) or this rank's rows of it.
    Returns the losses, the generator's weight-norm leaves and their
    gradients, the first and last leaf of each sub-discriminator and
    theirs (the whole 70.7 M floats would cost seconds to pickle), by path
    key, and MSD's first spectral state."""
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    from daft_exprt_torch.models.hifigan import init_generator_params
    from daft_exprt_torch.vocoder_finetune import (
        generator_to_weight_norm, make_gan_steps,
    )
    d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
        config, lr=1e-4, device='cpu', mesh=mesh)
    g_wn = generator_to_weight_norm(init_generator_params(seed, config,
                                                          device='cpu'))
    mpd = init_mpd_params(seed + 1, 'cpu')
    msd = init_msd_params(seed + 1, 'cpu')
    d_opt, g_opt = optim_d(mpd, msd), optim_g(g_wn)
    mel, y = torch.from_numpy(mel), torch.from_numpy(y)
    if mesh is not None:
        lo, hi = data_rows(len(mel), mesh)
        mel, y = mel[lo:hi], y[lo:hi]
    with torch.no_grad():
        y_mel = loss_mel_fn(y[:, 0])
    d_loss = float(d_step(mpd, msd, d_opt, g_wn, mel, y))
    g_loss, mel_l1 = g_step(g_wn, g_opt, mpd, msd, mel, y, y_mel)
    g = dict(_paths(g_wn))
    d = {}
    for root, module in (('mpd', mpd), ('msd', msd)):
        for sub_name, sub in module.named_children():
            params = list(sub.named_parameters())
            for name, p in (params[0], params[-1]):
                d[(root, sub_name) + tuple(name.split('.'))] = p
    return {'losses': (d_loss, float(g_loss), float(mel_l1)),
            'g': {k: _numpy(p) for k, p in g.items()},
            'g_grad': {k: _numpy(p.grad) for k, p in g.items()},
            'd': {k: _numpy(p) for k, p in d.items()},
            'd_grad': {k: _numpy(p.grad) for k, p in d.items()},
            'u': _numpy(msd.scale_0.conv_0.u)}


def _paths(tree, prefix=()):
    """(path tuple, leaf) of a nested dict, in sorted-path order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def gan_steps(config, seed, mel, y):
    """:func:`_gan_state` on one process."""
    return _gan_state(config, seed, mel, y)


def gan_dp(rank, config, seed, mel, y, ft_config, ft_dir):
    """:func:`_gan_state` over a data mesh of the world; then ``finetune``
    at a global batch that does not divide the data axis, whose error is
    returned; then :func:`finetune_run` of ``ft_config`` over the mesh into
    ``ft_dir``/dp."""
    mesh = make_mesh(device='cpu')
    out = _gan_state(config, seed, mel, y, mesh)
    try:
        finetune_run(ft_config, seed, ft_dir, 'odd', mesh, batch_size=3)
        out['error'] = None
    except ValueError as e:
        out['error'] = str(e)
    out['finetune'] = finetune_run(ft_config, seed, ft_dir, 'dp', mesh)
    return out


def finetune_run(config, seed, data_dir, name, mesh=None, batch_size=2):
    """``finetune`` on the pairs of ``data_dir`` (one step and its
    checkpoint) into ``data_dir``/``name``; the generator it returns, in
    sorted-path order."""
    from daft_exprt_torch.models.hifigan import init_generator_params
    from daft_exprt_torch.vocoder_finetune import finetune, param_leaves
    gen = finetune(data_dir, f'{data_dir}/{name}',
                   init_generator_params(seed, config, device='cpu'),
                   config=config, training_steps=1, batch_size=batch_size,
                   checkpoint_interval=1, log_interval=1, seed=seed,
                   device='cpu', mesh=mesh)
    return [_numpy(p) for p in param_leaves(gen)]


class _Recorder:
    """A train iterator that keeps every batch it yields."""

    def __init__(self, inner, seen):
        self.inner, self.seen = inner, seen

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for item in self.inner:
            self.seen.append({k: np.array(v) for k, v in item[0].items()})
            yield item


def train_multiprocess(rank, hp_kw, num_iterations):
    """``launch_training`` on this rank over a data mesh of the world;
    returns the final metrics and parameters, the train batches it read,
    and the messages of the port's loggers on this rank."""
    import daft_exprt_torch.train as tr
    seen, messages = [], []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    log = logging.getLogger('daft_exprt_torch')
    log.setLevel(logging.INFO)
    log.addHandler(Keep())
    make_iterators = tr.prepare_data_iterators

    def recording(*a, **kw):
        train_it, val_it, n = make_iterators(*a, **kw)
        return _Recorder(train_it, seen), val_it, n

    tr.prepare_data_iterators = recording
    model, metrics = tr.launch_training(HyperParams(**hp_kw),
                                        num_iterations=num_iterations,
                                        device='cpu')
    return {'metrics': metrics, 'batches': seen, 'messages': messages,
            'params': {k: _numpy(p) for k, p in model.named_parameters()}}

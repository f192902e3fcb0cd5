"""Few-shot speaker adaptation (the port's ``scripts/adapt_speaker.py``).

    python -m daft_exprt_torch.scripts.adapt_speaker -chk CKPT -out OUT \
        -tf train.txt [--tier 1|2|3] [--epochs 20] [--device cuda]

The averaged ECAPA embedding of the adaptation data is stored as
``memorized_spk_emb`` in the output checkpoint's ``extra``, and a tiered
subset of modules (spk_projection -> style_adapter -> frame_decoder) is
fine-tuned with Adam at a constant learning rate. Every other parameter
stays exactly as it was: the optimiser holds the unfrozen ones only. The
frozen ones keep their gradients, so the logged grad norm is the whole
model's, as in the JAX script. (That script's ``optax.masked`` passes the
raw gradient through on its masked-out leaves, which then move by +g every
step; the port does what the tool says.)
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)

TIERS = {
    1: ['spk_projection'],
    2: ['spk_projection', 'style_adapter'],
    3: ['spk_projection', 'style_adapter', 'frame_decoder'],
}


def make_freeze_mask(params, unfrozen_roots):
    """{parameter name: True where it is fine-tuned} for a module or a
    mapping keyed by state-dict names: a parameter is unfrozen when the
    first part of its name is one of ``unfrozen_roots``."""
    names = [n for n, _ in params.named_parameters()] \
        if hasattr(params, 'named_parameters') else list(params)
    return {n: n.split('.', 1)[0] in unfrozen_roots for n in names}


def adaptation_optimizer(model, unfrozen_roots, learning_rate):
    """Adam (optax.adam's defaults) over the unfrozen parameters only."""
    import torch

    mask = make_freeze_mask(model, unfrozen_roots)
    return torch.optim.Adam(
        [p for n, p in model.named_parameters() if mask[n]],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def adaptation_run(args, unfrozen, on_batch=None):
    """The shared loop of the adaptation tools: the checkpoint's model on
    ``args.device``, ``args.epochs`` epochs of the training step over
    ``args.training_files`` with the unfrozen roots' optimiser;
    ``on_batch(model, norm_batch, epoch)`` runs before each step. Returns
    (model, hparams, iterations)."""
    from daft_exprt_torch.data import (
        DynamicSpeakerStatsManager, prepare_data_iterators,
    )
    from daft_exprt_torch.loss import loss_cfg_from_hparams
    from daft_exprt_torch.parallel import train_step as ts
    from daft_exprt_torch.scripts.synthesize import load_model_for_synthesis

    model, hparams, _extra = load_model_for_synthesis(args.checkpoint,
                                                      device=args.device)
    hparams.training_files = args.training_files
    hparams.validation_files = args.validation_files or args.training_files
    step_fn = ts.make_train_step(
        model, adaptation_optimizer(model, unfrozen, args.learning_rate),
        loss_cfg_from_hparams(hparams), None, accumulation_steps=1)

    train_it, _, n = prepare_data_iterators(hparams,
                                            batch_size=args.batch_size)
    stats_manager = DynamicSpeakerStatsManager(hparams)
    _logger.info(f'{n} adaptation examples; unfrozen: {unfrozen}')

    iteration = 0
    for epoch in range(args.epochs):
        train_it.set_epoch(epoch)
        for batch, _, _ in train_it:
            norm = stats_manager.process_batch(batch)
            raw = {'frames_energy': batch['frames_energy'],
                   'frames_pitch': batch['frames_pitch']}
            if on_batch is not None:
                on_batch(model, norm, epoch)
            metrics = step_fn(ts.to_device(norm, args.device),
                              ts.to_device(raw, args.device),
                              float(iteration), hparams.seed)
            iteration += 1
            if iteration % args.log_every == 0:
                _logger.info(f"[{iteration}] loss {float(metrics['loss']):.4f}"
                             f" grad norm {float(metrics['grad_norm']):.4f}")
    return model, hparams, iteration


def save_adapted(path, model, hparams, iteration, extra):
    """The adapted checkpoint: the model, no optimizer state, the config
    and ``extra``."""
    from daft_exprt_torch import checkpoint as ckpt

    ckpt.save_checkpoint(path, model.state_dict(), iteration=iteration,
                         config_params={k: v for k, v in
                                        hparams.__dict__.items()
                                        if isinstance(v, (int, float, str,
                                                          bool, list, dict))},
                         extra=extra)


def memorized_speaker_embedding(training_files):
    """The mean of the list's ``<features_dir>/<file>.spk_emb.npy`` (None
    where there is none)."""
    embs = []
    with open(training_files) as f:
        for line in f:
            parts = line.strip().split('|')
            if len(parts) >= 2:
                p = os.path.join(parts[0], f'{parts[1]}.spk_emb.npy')
                if os.path.isfile(p):
                    embs.append(np.load(p).reshape(-1))
    return np.mean(np.stack(embs), axis=0) if embs else None


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-out', '--output_checkpoint', type=str,
                        required=True)
    parser.add_argument('-tf', '--training_files', type=str, required=True)
    parser.add_argument('-vf', '--validation_files', type=str, default='')
    parser.add_argument('--tier', type=int, default=2, choices=[1, 2, 3])
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--learning_rate', type=float, default=1e-5)
    parser.add_argument('--log_every', type=int, default=10)
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Adapt and save; returns the output checkpoint's path."""
    args = parse_args(build_parser(), argv)
    unfrozen = TIERS[args.tier]
    _logger.info(f'unfrozen modules (tier {args.tier}): {unfrozen}')
    memorized = memorized_speaker_embedding(args.training_files)
    model, hparams, iteration = adaptation_run(args, unfrozen)
    extra = {} if memorized is None else {'memorized_spk_emb': memorized}
    save_adapted(args.output_checkpoint, model, hparams, iteration, extra)
    _logger.info(f'adapted checkpoint saved to {args.output_checkpoint}')
    return args.output_checkpoint


if __name__ == '__main__':
    main()

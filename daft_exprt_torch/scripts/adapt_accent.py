"""Accent adaptation (the port's ``scripts/adapt_accent.py``).

    python -m daft_exprt_torch.scripts.adapt_accent -chk CKPT -out OUT \
        -tf train.txt [--unfreeze_decoder] [--epochs 20] [--device cuda]

The average accent embedding of the adaptation corpus (through the accent
encoder, over the first epoch's batches) is stored as
``memorized_accent_emb`` in the output checkpoint's ``extra``, and
style_adapter (and with ``--unfreeze_decoder`` frame_decoder) is
fine-tuned on that corpus; every other parameter stays exactly as it was
(``adapt_speaker``'s module note).
"""
import argparse
import logging

import numpy as np
import torch

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-out', '--output_checkpoint', type=str,
                        required=True)
    parser.add_argument('-tf', '--training_files', type=str, required=True)
    parser.add_argument('-vf', '--validation_files', type=str, default='')
    parser.add_argument('--unfreeze_decoder', action='store_true')
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--learning_rate', type=float, default=1e-5)
    parser.add_argument('--log_every', type=int, default=10)
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Adapt and save; returns the output checkpoint's path."""
    from daft_exprt_torch.parallel.train_step import to_device
    from daft_exprt_torch.scripts.adapt_speaker import (
        adaptation_run, save_adapted,
    )

    args = parse_args(build_parser(), argv)
    unfrozen = ['style_adapter']
    if args.unfreeze_decoder:
        unfrozen.append('frame_decoder')
    accent_embs = []

    def encode(model, norm, epoch):
        """The first epoch's accent embeddings, deterministic, with the
        parameters as they are before the batch's step."""
        if epoch != 0:
            return
        b = to_device({k: norm[k] for k in (
            'frames_energy', 'frames_pitch', 'mel_specs',
            'output_lengths')}, args.device)
        model.eval()
        with torch.no_grad():
            emb = model.encode_accent(b['frames_energy'], b['frames_pitch'],
                                      b['mel_specs'], b['output_lengths'])
        accent_embs.append(emb.float().cpu().numpy())

    model, hparams, iteration = adaptation_run(args, unfrozen, encode)
    extra = {'memorized_accent_emb': np.concatenate(accent_embs).mean(
        axis=0)} if accent_embs else {}
    save_adapted(args.output_checkpoint, model, hparams, iteration, extra)
    _logger.info(f'accent-adapted checkpoint saved to '
                 f'{args.output_checkpoint}')
    return args.output_checkpoint


if __name__ == '__main__':
    main()

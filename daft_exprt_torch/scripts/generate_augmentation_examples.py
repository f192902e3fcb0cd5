"""Mel-domain augmentation demos -> vocoded wavs (the port's
``scripts/generate_augmentation_examples.py``).

    python -m daft_exprt_torch.scripts.generate_augmentation_examples \
        -w IN.wav -out OUT --vocoder_checkpoint GENERATOR [--device cuda]

Bin-shift pitch augmentation, time stretch by linear interpolation along
the frame axis and energy scaling as a log-domain offset, each vocoded by
the HiFi-GAN generator of a reference-format checkpoint on its float32
plain route (the JAX script's default tier); the log-mel and the
generator on ``--device``.
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def pitch_shift_mel(mel, n_bins):
    """Shift mel bins (positive = up) with edge replication."""
    shifted = np.empty_like(mel)
    if n_bins > 0:
        shifted[n_bins:] = mel[:-n_bins]
        shifted[:n_bins] = mel[0]
    elif n_bins < 0:
        shifted[:n_bins] = mel[-n_bins:]
        shifted[n_bins:] = mel[-1]
    else:
        shifted[:] = mel
    return shifted


def time_stretch_mel(mel, factor):
    """Stretch along the frame axis by linear interpolation."""
    T = mel.shape[1]
    new_T = max(2, int(round(T * factor)))
    src = np.linspace(0, T - 1, new_T)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    frac = src - lo
    return mel[:, lo] * (1 - frac)[None, :] + mel[:, hi] * frac[None, :]


def energy_scale_mel(mel, factor):
    """Scale energy as a log-domain additive offset."""
    return mel + np.log(factor)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-w', '--wav_file', type=str, required=True)
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('--vocoder_checkpoint', type=str, required=True)
    parser.add_argument('--mel_shifts', type=int, nargs='*', default=[-3, 3])
    parser.add_argument('--stretches', type=float, nargs='*',
                        default=[0.8, 1.2])
    parser.add_argument('--energy_scales', type=float, nargs='*',
                        default=[0.7, 1.3])
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Returns {tag: (mel, audio)} of every variant written."""
    args = parse_args(build_parser(), argv)
    from daft_exprt_torch.frontend.audio import load_wav, save_wav
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.hifigan import load_hifigan_vocoder
    from daft_exprt_torch.ops.mel import MelExtractor

    hparams = HyperParams(verbose=False, training_files='unused',
                          validation_files='unused',
                          output_directory=args.output_dir,
                          language='english', speakers=['spk'])
    os.makedirs(args.output_dir, exist_ok=True)
    wav, _ = load_wav(args.wav_file, target_sr=hparams.sampling_rate)
    mel = MelExtractor(hparams, device=args.device)(wav)
    vocoder = load_hifigan_vocoder(args.vocoder_checkpoint,
                                   device=args.device)
    name = os.path.basename(args.wav_file).replace('.wav', '')

    variants = [('orig', mel)]
    variants += [(f'pitch{sh:+d}', pitch_shift_mel(mel, sh))
                 for sh in args.mel_shifts]
    variants += [(f'stretch{st}', time_stretch_mel(mel, st))
                 for st in args.stretches]
    variants += [(f'energy{sc}', energy_scale_mel(mel, sc))
                 for sc in args.energy_scales]
    out = {}
    for tag, m in variants:
        m = m.astype(np.float32)
        audio = vocoder.infer(m)
        save_wav(os.path.join(args.output_dir, f'{name}_{tag}.wav'),
                 audio, hparams.sampling_rate)
        _logger.info(f'{tag}: {m.shape[1]} frames')
        out[tag] = (m, audio)
    return out


if __name__ == '__main__':
    main()

"""Vocode a saved mel (.npy, or an .npz with 'mel_spec') to a wav (the
port's ``scripts/verify_mel_spec.py``).

    python -m daft_exprt_torch.scripts.verify_mel_spec -m MEL.npy \
        -out OUT.wav --vocoder_checkpoint GENERATOR [--device cuda]

The HiFi-GAN generator of a reference-format checkpoint on its float32
plain route (the JAX script's default tier), on ``--device``.
"""
import argparse

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-m', '--mel_file', type=str, required=True)
    parser.add_argument('-out', '--output_file', type=str, required=True)
    parser.add_argument('--vocoder_checkpoint', type=str, required=True)
    parser.add_argument('--sampling_rate', type=int, default=22050)
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Returns the audio written."""
    args = parse_args(build_parser(), argv)
    from daft_exprt_torch.frontend.audio import save_wav
    from daft_exprt_torch.models.hifigan import load_hifigan_vocoder

    if args.mel_file.endswith('.npz'):
        mel = np.load(args.mel_file)['mel_spec']
    else:
        mel = np.load(args.mel_file)
    print(f'mel: {mel.shape}, range [{mel.min():.2f}, {mel.max():.2f}]')
    vocoder = load_hifigan_vocoder(args.vocoder_checkpoint,
                                   device=args.device)
    audio = vocoder.infer(mel)
    save_wav(args.output_file, audio, args.sampling_rate)
    print(f'wrote {args.output_file} ({len(audio) / args.sampling_rate:.2f}s)')
    return audio


if __name__ == '__main__':
    main()

"""Ground-truth wav -> mel -> vocoder -> wav round trip, to tell vocoder
artifacts from mel mismatches (the port's ``scripts/hifigan_sanity_check.py``).

    python -m daft_exprt_torch.scripts.hifigan_sanity_check -w IN.wav \
        -out OUT --vocoder_checkpoint GENERATOR [--device cuda]

The log-mel on ``--device``, then the HiFi-GAN generator of a
reference-format checkpoint on its float32 plain route (the JAX script's
default tier); writes the copy synthesis and the original cut to its
length, and logs a naive SNR.
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-w', '--wav_file', type=str, required=True)
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('--vocoder_checkpoint', type=str, required=True)
    parser.add_argument('-l', '--language', type=str, default='english')
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Returns (copy-synthesis audio, naive SNR in dB)."""
    args = parse_args(build_parser(), argv)
    from daft_exprt_torch.frontend.audio import load_wav, save_wav
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.hifigan import load_hifigan_vocoder
    from daft_exprt_torch.ops.mel import MelExtractor

    hparams = HyperParams(verbose=False, training_files='unused',
                          validation_files='unused',
                          output_directory=args.output_dir,
                          language=args.language, speakers=['spk'])
    os.makedirs(args.output_dir, exist_ok=True)
    wav, fs = load_wav(args.wav_file, target_sr=hparams.sampling_rate)
    mel = MelExtractor(hparams, device=args.device)(wav)
    _logger.info(f'GT mel: {mel.shape}, range [{mel.min():.2f}, '
                 f'{mel.max():.2f}]')
    vocoder = load_hifigan_vocoder(args.vocoder_checkpoint,
                                   device=args.device)
    audio = vocoder.infer(mel)
    name = os.path.basename(args.wav_file).replace('.wav', '')
    save_wav(os.path.join(args.output_dir, f'{name}_copy_synthesis.wav'),
             audio, hparams.sampling_rate)
    save_wav(os.path.join(args.output_dir, f'{name}_original_trimmed.wav'),
             wav[:len(audio)], hparams.sampling_rate)
    n = min(len(audio), len(wav))
    snr = 10 * np.log10(
        np.sum(wav[:n] ** 2) / (np.sum((wav[:n] - audio[:n]) ** 2) + 1e-12))
    _logger.info(f'copy-synthesis written -- naive SNR {snr:.2f} dB '
                 f'(phase differences make this pessimistic)')
    return audio, float(snr)


if __name__ == '__main__':
    main()

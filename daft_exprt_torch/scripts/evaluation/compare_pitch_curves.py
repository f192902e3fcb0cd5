"""Pearson correlation between two audio files' pitch curves (the port's
``scripts/evaluation/compare_pitch_curves.py``).

    python -m daft_exprt_torch.scripts.evaluation.compare_pitch_curves \
        A.wav B.wav [--pitch_method auto] [--device cuda]

Unvoiced frames removed, the shorter curve resampled onto the longer one's
grid, Pearson r; the pitch tracker runs on ``--device``.
"""
import argparse
import tempfile

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args


def pitch_curve_correlation(pitch_a, pitch_b):
    """Voiced-only Pearson r with linear time-normalized resampling (None
    when either curve has fewer than two voiced frames or is constant)."""
    a = np.asarray(pitch_a, dtype=np.float64)
    b = np.asarray(pitch_b, dtype=np.float64)
    a = a[a > 0]
    b = b[b > 0]
    if len(a) < 2 or len(b) < 2:
        return None
    n = max(len(a), len(b))
    a_rs = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(a)), a)
    b_rs = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(b)), b)
    if a_rs.std() == 0 or b_rs.std() == 0:
        return None
    return float(np.corrcoef(a_rs, b_rs)[0, 1])


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('wav_a')
    parser.add_argument('wav_b')
    parser.add_argument('--pitch_method', type=str, default='auto')
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Prints and returns the correlation (None: undefined)."""
    args = parse_args(build_parser(), argv)
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.hparams import HyperParams

    with tempfile.TemporaryDirectory() as td:
        hp = HyperParams(verbose=False, training_files='unused',
                         validation_files='unused', output_directory=td,
                         language='english', speakers=['spk'])
    curves = []
    for path in (args.wav_a, args.wav_b):
        wav, fs = load_wav(path, target_sr=hp.sampling_rate)
        curves.append(extract_pitch(wav, fs, hp, method=args.pitch_method,
                                    device=args.device))
    r = pitch_curve_correlation(*curves)
    print(f'pitch PCC: {r if r is not None else "undefined"}')
    return r


if __name__ == '__main__':
    main()

"""Shape check of the PitchPredictor (the port's
``scripts/verify_pitch_predictor_shape.py``).

    python -m daft_exprt_torch.scripts.verify_pitch_predictor_shape \
        [--device cuda]

A seeded predictor in eval mode on ``--device`` over a (2, 80, 123) mel
must give (2, 123); exit code 0 on success, 1 on failure.
"""
import argparse
import sys

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args


def build_parser():
    parser = argparse.ArgumentParser()
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Returns the exit code: 0 when the output is (2, 123), else 1."""
    args = parse_args(build_parser(), argv)
    import torch

    from daft_exprt_torch.models.pitch_predictor import PitchPredictor

    model = PitchPredictor(n_mel_channels=80).init_random_(0).to(
        args.device).frozen()
    mel = np.random.randn(2, 80, 123).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(mel).to(args.device))
    ok = tuple(out.shape) == (2, 123)
    print(f'output shape: {tuple(out.shape)} -- '
          f'{"SUCCESS" if ok else "FAILURE"}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

"""Ground-truth against predicted pitch, from a PitchPredictor checkpoint
(the port's ``scripts/visualize_pitch_prediction.py``).

    python -m daft_exprt_torch.scripts.visualize_pitch_prediction \
        -chk CKPT -fd FEATURES -out OUT [--nb_files 10] [--device cuda]

``-chk``: a port checkpoint of ``train_pitch_predictor``, or a reference
``.pt`` state dict (``checkpoint.convert_reference_pitch_predictor``). The
predictor runs in eval mode on ``--device`` over the first ``--nb_files``
(mel, .frames_f0) pairs of the features directory; each pair's voiced MSE
is logged and, where matplotlib imports, its overlay written as
``<name>_pitch.png`` (skipped without it, with a warning).
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def load_pitch_predictor(path, n_mel_channels=80, device=None):
    """The PitchPredictor of a port checkpoint or a reference ``.pt``, in
    eval mode on ``device``."""
    from daft_exprt_torch import checkpoint as ckpt
    from daft_exprt_torch.device import resolve_device
    from daft_exprt_torch.models.pitch_predictor import PitchPredictor

    if path.endswith('.pt'):
        sd = ckpt.convert_reference_pitch_predictor(
            ckpt.strip_ddp_prefix(ckpt.torch_load_guarded(path)))
    else:
        payload, _ = ckpt.load_checkpoint(path)
        sd = payload['model']
    model = PitchPredictor(n_mel_channels=n_mel_channels)
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).frozen()


def run(args):
    """{pair's base path: voiced MSE (None without voiced frames)}."""
    import torch

    from daft_exprt_torch.scripts.train_pitch_predictor import collect_files
    from daft_exprt_torch.utils.plots import have_matplotlib, plot_1d_overlay

    model = load_pitch_predictor(args.checkpoint, args.n_mel_channels,
                                 args.device)
    pairs = collect_files(args.features_dir)[:args.nb_files]
    os.makedirs(args.output_dir, exist_ok=True)
    plots = have_matplotlib()
    if not plots:
        _logger.warning('matplotlib not installed: no overlays written')
    out = {}
    for base in pairs:
        mel = np.load(base + '.npy').astype(np.float32)
        with open(base + '.frames_f0') as f:
            gt = np.array([float(x) for x in f], dtype=np.float32)
        with torch.no_grad():
            pred = model(torch.from_numpy(mel[None]).to(args.device))
        pred = pred[0].cpu().numpy()
        name = os.path.basename(base)
        T = min(len(gt), len(pred))
        if plots:
            plot_1d_overlay([gt[:T], pred[:T]], labels=['GT', 'Predicted'],
                            filename=os.path.join(args.output_dir,
                                                  f'{name}_pitch.png'),
                            title=name)
        voiced = gt[:T] != 0
        out[base] = None
        if voiced.any():
            out[base] = float(np.mean((pred[:T][voiced] - gt[:T][voiced])
                                      ** 2))
            _logger.info(f'{name}: voiced MSE {out[base]:.5f}')
    _logger.info(f'{len(pairs)} pairs'
                 + (f', overlays written to {args.output_dir}' if plots
                    else ''))
    return out


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-fd', '--features_dir', type=str, required=True)
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('--nb_files', type=int, default=10)
    parser.add_argument('--n_mel_channels', type=int, default=80)
    add_device_flag(parser)
    return parser


def main(argv=None):
    return run(parse_args(build_parser(), argv))


if __name__ == '__main__':
    main()

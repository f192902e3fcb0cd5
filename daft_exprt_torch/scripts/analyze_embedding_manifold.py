"""Embedding-manifold diagnostics of an acoustic checkpoint (the port's
``scripts/analyze_embedding_manifold.py``).

    python -m daft_exprt_torch.scripts.analyze_embedding_manifold -chk CKPT \
        [-fd FEATURES] [--device cuda]

The singular values of the ECAPA projection's weight (as (in, out), the
JAX layout: ``nn.Linear`` keeps it (out, in)) and, given precomputed
``.spk_emb.npy`` files, the norm and pairwise-cosine statistics of the
projected, unit-normalized embeddings.
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def projection(model):
    """The speaker projection's (W (in, out), b) as float64 numpy."""
    layer = model.spk_projection.linear_layer
    return (layer.weight.detach().cpu().double().numpy().T,
            layer.bias.detach().cpu().double().numpy())


def manifold_stats(W, b, embs):
    """Norms and off-diagonal pairwise cosines of ``embs`` (N, in) after
    unit normalization and the projection x @ W + b."""
    E = np.stack([np.asarray(e, np.float64).reshape(-1) for e in embs])
    E_norm = E / np.linalg.norm(E, axis=1, keepdims=True)
    proj = E_norm @ W + b
    norms = np.linalg.norm(proj, axis=1)
    cos = (proj @ proj.T) / np.outer(norms, norms)
    off = cos[~np.eye(len(cos), dtype=bool)]
    return norms, off


def run(args):
    """{'singular_values': ..., and with embeddings 'norms', 'cosines'}."""
    from daft_exprt_torch.scripts.synthesize import load_model_for_synthesis

    model, _hparams, _extra = load_model_for_synthesis(args.checkpoint,
                                                       device=args.device)
    W, b = projection(model)
    sv = np.linalg.svd(W, compute_uv=False)
    print(f'spk_projection: {W.shape}, singular values '
          f'max={sv.max():.3f} min={sv.min():.4f} '
          f'cond={sv.max() / max(sv.min(), 1e-9):.1f}')
    out = {'singular_values': sv}
    if args.features_dir:
        embs = []
        for root, _, files in os.walk(args.features_dir):
            for f in files:
                if f.endswith('.spk_emb.npy'):
                    embs.append(np.load(os.path.join(root, f)).reshape(-1))
        if embs:
            norms, off = manifold_stats(W, b, embs)
            print(f'{len(embs)} embeddings: projected norm '
                  f'{norms.mean():.3f}±{norms.std():.3f}, pairwise cosine '
                  f'{off.mean():.3f}±{off.std():.3f} '
                  f'(min {off.min():.3f}, max {off.max():.3f})')
            out.update(norms=norms, cosines=off)
    return out


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-fd', '--features_dir', type=str, default='')
    add_device_flag(parser)
    return parser


def main(argv=None):
    return run(parse_args(build_parser(), argv))


if __name__ == '__main__':
    main()

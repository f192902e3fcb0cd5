"""Helpers for the tests that hold the PyTorch port to the JAX package:
seeded numpy inputs and parameters, handed to both sides."""
import numpy as np
import torch


def to_torch(tree):
    """Nested dicts of numpy/JAX arrays -> same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def mrf_params(rng, level, C, kernel_sizes, dilations, w_scale=0.05,
               b_scale=0.02):
    """Seeded resblock params of one level, JAX vocoder layout (numpy)."""
    params = {}
    for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        params[f'resblock_{level}_{j}'] = {
            f'{pre}_{i}': {'w': (rng.randn(C, C, k) * w_scale).astype(np.float32),
                           'b': (rng.randn(C) * b_scale).astype(np.float32)}
            for pre in ('convs1', 'convs2') for i in range(len(dils))}
    return params


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))

"""Helpers for the tests that hold the PyTorch port to the JAX package:
seeded numpy inputs and parameters, handed to both sides."""
import contextlib

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


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread, the count restored after. A replay of
    thousands of small ops otherwise waits on the thread pool at every op,
    which several test workers on one CPU turn into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# ---- the float32 kernels' 3xTF32 arithmetic, modelled on the CPU ---------

TF32_STEP = 8             # k per mma.sync m16n8k8


def tf32(x):
    """cvt.rna.tf32.f32: the nearest value with 10 mantissa bits, ties
    away from zero (the low 13 bits of the pattern cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a, b, terms=3, tile=None):
    """a (..., M, K) @ b (..., K, N) as the kernels compute it. K is padded
    to a multiple of 8 with zeros (the tiles' zero-filled rows); each 8-wide
    step adds its split products to a float32 accumulator, small terms
    first; with ``tile``, every ``tile`` values of K go to a fresh
    accumulator that is then added to the sum. ``terms=1``: hi.hi only."""
    K = a.shape[-1]
    pad = -K % TF32_STEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    pairs = [(a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi)][3 - terms:]
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    part = torch.zeros_like(total)
    per_tile = (tile or K + pad) // TF32_STEP
    for i, k0 in enumerate(range(0, K + pad, TF32_STEP)):
        ks = slice(k0, k0 + TF32_STEP)
        for x, y in pairs:
            part = part + x[..., ks] @ y[..., ks, :]
        if (i + 1) % per_tile == 0 or k0 + TF32_STEP >= K + pad:
            total, part = total + part, torch.zeros_like(part)
    return total

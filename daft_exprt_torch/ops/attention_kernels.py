"""Masked self-attention with dropout, forward and backward: the CUDA
kernels ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` and their
plain PyTorch versions.

Replaces ``daft_exprt_tpu/ops/attention_kernels.py::fused_attention``
(Pallas bodies ``_fwd_kernel`` and ``_bwd_kernel``, with its custom VJP).
Numerics follow the TPU kernels: float32 logits of the pre-scaled q
against k, keys at or past ``lengths[b]`` set to -1e9, float32 softmax,
dropout on the normalised float32 weights, weights cast to v's dtype,
float32 accumulation of every product, outputs in the inputs' dtype. The
backward recomputes p and the mask (the kernels draw the mask once, in
the first of their two launches, into a bit scratch the second reads);
dk and dv are summed over all query rows in float32 and cast last.

The dropout mask is the port's own (TPU PRNG bits cannot be reproduced on
a GPU): ``bits >= thr`` with ``thr = round(p * 2**32)`` and kept weights
scaled by ``1 / (1 - thr / 2**32)``, as the TPU kernel's ``_thr`` /
``_keep_mask``, but the bits are Philox-4x32-10 with key
``(seed, b * H + h)`` and counter ``(i, j // 4, 0, 0)``, word ``j % 4``, for
query row i and key j (:func:`dropout_bits`). The mask is a pure function
of ``(seed, b, h, i, j)``: the kernels and the plain versions compute the
same bits, and the backward regenerates the forward's mask.

Bound on the card: bytes at T=128, operations at T=1024 (see the notes in
the .cu files). Both types run on the tensor cores (mma.sync over 64-row
tiles streamed through shared memory) and take any T: bf16 calls in bf16,
float32 calls in 3xTF32 (each product split into three TF32 products of
its operands' high and low halves, which keeps it within the float32
band).
"""
import collections
import ctypes

import numpy as np
import torch

from daft_exprt_torch.ops import _build

__all__ = ['fused_attention', 'fused_attention_bwd', 'attention_plain',
           'attention_bwd_plain', 'dropout_bits', 'dropout_threshold']

HEAD_DIM = 64         # the only instantiation: the FFT blocks' head width
TILE = 64             # rows per tile of the kernels (the stats' padding)
_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def dropout_threshold(dropout_p):
    """(thr, scale) of the TPU kernel's ``_thr``: keep where bits >= thr =
    round(p * 2**32); kept weights times scale = 1 / (1 - thr / 2**32),
    rounded to float32 as the kernel's weakly typed multiply does.
    ``(0, 1.0)`` when dropout is off."""
    if not dropout_p:
        return 0, 1.0
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f'dropout_p must lie in [0, 1), got {dropout_p}')
    thr = int(round(dropout_p * 4294967296.0))
    return thr, float(np.float32(1.0 / (1.0 - thr / 4294967296.0)))


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m for int64 ``a`` in [0, 2**32) and a
    32-bit constant m, in 16-bit halves so that no int64 product overflows."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (lo >> 32), lo & _U32


def dropout_bits(seed, B, H, T, rows=None, device=None):
    """(B, H, len(rows), T) int64 Philox words in [0, 2**32): key (seed,
    b*H + h), counter (i, j // 4, 0, 0), word j % 4, for query rows ``rows``
    (default 0..T-1) and keys 0..T-1. ``seed``: an int or an int64 tensor
    of one element (only its low 32 bits count)."""
    dev = torch.device(device) if device is not None else (
        seed.device if torch.is_tensor(seed) else torch.device('cpu'))
    rows = torch.arange(T, device=dev) if rows is None else \
        torch.as_tensor(rows, device=dev)
    G = -(-T // 4)
    i64 = torch.int64
    c0 = rows.to(i64).view(1, -1, 1)
    c1 = torch.arange(G, device=dev, dtype=i64).view(1, 1, G)
    c2 = c3 = torch.zeros((), device=dev, dtype=i64)
    k0 = (seed.to(dev, i64).reshape(()) if torch.is_tensor(seed)
          else torch.tensor(int(seed), device=dev, dtype=i64)) & _U32
    k1 = torch.arange(B * H, device=dev, dtype=i64).view(-1, 1, 1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    shape = (B * H, rows.numel(), G)
    words = torch.stack([c.expand(shape) for c in (c0, c1, c2, c3)], -1)
    return words.reshape(B, H, rows.numel(), 4 * G)[..., :T]


def _softmax_rows(q, k, lengths):
    """float32 softmax of the masked logits, (B, H, T, T)."""
    T = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(-1e9, dtype=s.dtype, device=s.device))
    return torch.softmax(s, dim=-1)


def _keep(q, seed, thr):
    B, H, T, _ = q.shape
    return dropout_bits(seed, B, H, T, device=q.device) >= thr


def attention_plain(q, k, v, lengths, seed=0, dropout_p=0.0):
    """The plain PyTorch version of the forward. q, k, v: (B, H, T, D), q
    pre-scaled by D**-0.5; lengths: (B,) valid key counts; seed and
    dropout_p as :func:`fused_attention`. Differentiable by autograd."""
    p = _softmax_rows(q, k, lengths)
    thr, scale = dropout_threshold(dropout_p)
    if thr:
        p = torch.where(_keep(q, seed, thr), p * scale, torch.zeros_like(p))
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_bwd_plain(q, k, v, do, lengths, seed=0, dropout_p=0.0):
    """The plain PyTorch version of the backward: (dq, dk, dv) of
    :func:`attention_plain` for the output gradient ``do``, computed as the
    TPU kernel does (the cast of the weights to v's dtype passes gradients
    through unchanged; ds is rounded to q's dtype before its products)."""
    p = _softmax_rows(q, k, lengths)
    thr, scale = dropout_threshold(dropout_p)
    dpd = torch.matmul(do.float(), v.float().transpose(-1, -2))
    if thr:
        keep = _keep(q, seed, thr)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p * scale, zero)
        dp = torch.where(keep, dpd * scale, zero)
    else:
        pd, dp = p, dpd
    dv = torch.matmul(pd.to(v.dtype).float().transpose(-1, -2), do.float())
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_fns = {}


def _fn(name, n_ptr):
    """The C entry point of ``csrc/<name>.cu`` (``n_ptr`` pointers, then B,
    H, T, D, dtype, thr, scale, stream), bound once."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library(name), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_inputs(what, q, k, v, *more):
    B, H, T, D = q.shape
    if any(t.shape != q.shape for t in (k, v) + more):
        raise ValueError(f'{what}: q, k, v (and do) shapes differ')
    if any(t.dtype != q.dtype for t in (k, v) + more) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f'{what}: q, k, v (and do) must share bfloat16 '
                         f'or float32 (got {q.dtype})')
    if D != HEAD_DIM:
        raise ValueError(f'{what}: head dim {D} not supported (D = '
                         f'{HEAD_DIM})')


def _call_key(q, dropout_p):
    """The wrappers' ``.calls`` key: q's shape and dropout_p, then
    'float32' for a float32 call."""
    key = tuple(q.shape) + (float(dropout_p),)
    return key + ('float32',) if q.dtype == torch.float32 else key


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels copy
    16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _seed_ptr(seed, thr, device):
    """A device int64 holding the seed (None when dropout is off, so that
    no host-to-device copy is made) and its pointer."""
    if not thr:
        return None, ctypes.c_void_p(0)
    s = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(1)
    return s, _build.ptr(s)


def _launch_fwd(q, k, v, lengths, seed, dropout_p):
    """``attention_fwd.cu`` on CUDA tensors (one launch)."""
    _check_inputs('fused_attention', q, k, v)
    B, H, T, D = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    thr, scale = dropout_threshold(dropout_p)
    s, sp = _seed_ptr(seed, thr, q.device)
    out = torch.empty_like(q)
    err = _fn('attention_fwd', 6)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lens), sp,
        _build.ptr(out), B, H, T, D, 1 if q.dtype == torch.bfloat16 else 0,
        thr, scale, _build.stream_ptr(q))
    _build.check(err, 'attention_fwd')
    fused_attention.launches += 1
    fused_attention.calls[_call_key(q, dropout_p)] += 1
    return out


def fused_attention_bwd(q, k, v, do, lengths, seed=0, dropout_p=0.0):
    """(dq, dk, dv) of :func:`fused_attention`'s forward for the output
    gradient ``do``. On a CUDA tensor this launches ``attention_bwd.cu``
    (two launches, or raises); on a CPU tensor it runs
    :func:`attention_bwd_plain`.

    ``fused_attention_bwd.launches`` counts CUDA launches;
    ``fused_attention_bwd.calls`` counts calls by q's shape and dropout_p
    (and 'float32' for a float32 call)."""
    if q.device.type == 'cpu':
        return attention_bwd_plain(q, k, v, do, lengths, seed, dropout_p)
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention_bwd: unsupported device '
                         f'{q.device}')
    _check_inputs('fused_attention_bwd', q, k, v, do)
    B, H, T, D = q.shape
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    thr, scale = dropout_threshold(dropout_p)
    s, sp = _seed_ptr(seed, thr, q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # each row's statistics (max * log2(e), 1 / sum, sum dp * p, 0), rows
    # padded to tiles
    Tp = -(-T // TILE) * TILE
    stats = torch.empty((B * H, Tp, 4), device=q.device, dtype=torch.float32)
    bf16 = q.dtype == torch.bfloat16
    # with dropout: the mask bits, drawn once by the first launch
    keep = torch.empty((B * H, Tp * Tp // 32), device=q.device,
                       dtype=torch.int32) if thr else None
    err = _fn('attention_bwd', 11)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lens), sp, _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
        _build.ptr(stats), ctypes.c_void_p(0) if keep is None
        else _build.ptr(keep), B, H, T, D, 1 if bf16 else 0, thr, scale,
        _build.stream_ptr(q))
    _build.check(err, 'attention_bwd')
    fused_attention_bwd.launches += 2
    fused_attention_bwd.calls[_call_key(q, dropout_p)] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; saves
    q, k, v, lengths and the seed, as the TPU kernel's residuals, and no
    (T, T) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, dropout_p):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.seed, ctx.dropout_p = seed, dropout_p
        if q.device.type == 'cpu':
            return attention_plain(q, k, v, lengths, seed, dropout_p)
        if q.device.type != 'cuda':
            raise ValueError(f'fused_attention: unsupported device {q.device}')
        return _launch_fwd(q, k, v, lengths, seed, dropout_p)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, do, lengths, ctx.seed,
                                         ctx.dropout_p)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, lengths, seed=0, dropout_p=0.0):
    """softmax(q·kᵀ, keys >= lengths[b] masked to -1e9) [dropout] ·v, with
    :func:`fused_attention_bwd` as its gradient.

    q, k, v: (B, H, T, D) in bfloat16 or float32, q already scaled by
    D**-0.5. ``seed``: an int or an int64 tensor of one element on q's
    device (the training step draws it there); ``dropout_p`` in [0, 1). On
    a CUDA tensor this launches ``attention_fwd.cu`` (or raises); on a CPU
    tensor it runs :func:`attention_plain`.

    ``fused_attention.launches`` counts CUDA launches;
    ``fused_attention.calls`` counts them by q's shape and dropout_p (and
    'float32' for a float32 call)."""
    return _FusedAttention.apply(q, k, v, lengths, seed, dropout_p)


fused_attention.launches = 0
fused_attention.calls = collections.Counter()
fused_attention_bwd.launches = 0
fused_attention_bwd.calls = collections.Counter()

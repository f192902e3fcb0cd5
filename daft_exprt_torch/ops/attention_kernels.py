"""Masked self-attention forward: the CUDA kernel ``csrc/attention_fwd.cu``
and its plain PyTorch version.

Replaces ``daft_exprt_tpu/ops/attention_kernels.py::fused_attention``
(forward; Pallas body ``_fwd_kernel``). Numerics follow the TPU kernel and
the XLA branch of ``MultiHeadSelfAttention``: float32 logits of the
pre-scaled q against k, keys at or past ``lengths[b]`` set to -1e9, float32
softmax, weights cast to v's dtype, float32 accumulation of p·v, output in
q's dtype.

Bound on the card: bytes at T=128, operations at T=1024 (see the source
note in the .cu file). Dropout is not ported: ``dropout_p > 0`` raises
(the Philox dropout comes with the backward kernel in the training slice).
"""
import collections
import ctypes

import torch

from daft_exprt_torch.ops import _build

__all__ = ['fused_attention', 'attention_plain']

MAX_T = 2048          # (16, T) float32 logit rows in shared memory
HEAD_DIM = 64         # the only instantiation: the FFT blocks' head width


def attention_plain(q, k, v, lengths):
    """The plain PyTorch version. q, k, v: (B, H, T, D), q pre-scaled by
    D**-0.5; lengths: (B,) valid key counts."""
    T = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(-1e9, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _lib():
    lib = _build.library('attention_fwd')
    fn = lib.attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_attention(q, k, v, lengths, dropout_p=0.0):
    """softmax(q·kᵀ, keys >= lengths[b] masked to -1e9)·v.

    q, k, v: (B, H, T, D) in bfloat16 or float32, q already scaled by
    D**-0.5. On a CUDA tensor this launches ``attention_fwd.cu`` (or
    raises); on a CPU tensor it runs :func:`attention_plain`.

    ``fused_attention.launches`` counts CUDA launches;
    ``fused_attention.calls`` counts them by q's shape."""
    if dropout_p:
        raise NotImplementedError(
            'attention dropout is not ported yet: it comes with the '
            'backward kernel in the training slice (ROADMAP Queue 2)')
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, lengths)
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention: unsupported device {q.device}')
    B, H, T, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError('fused_attention: q, k, v shapes differ')
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError('fused_attention: q, k, v must share bfloat16 or '
                         f'float32 (got {q.dtype}, {k.dtype}, {v.dtype})')
    if D != HEAD_DIM or T > MAX_T:
        raise ValueError(f'fused_attention: head dim {D} / length {T} not '
                         f'supported (D = {HEAD_DIM}, T <= {MAX_T})')
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib()(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(lens), _build.ptr(out), B, H, T, D,
                 1 if q.dtype == torch.bfloat16 else 0, _build.stream_ptr(q))
    _build.check(err, 'attention_fwd')
    fused_attention.launches += 1
    fused_attention.calls[tuple(q.shape)] += 1
    return out


fused_attention.launches = 0
fused_attention.calls = collections.Counter()

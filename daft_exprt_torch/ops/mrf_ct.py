"""Float MRF kernels of the levels that take no fused upsample (HiFi-GAN
V2's four levels): the CUDA kernel ``csrc/mrf_ct.cu``, its plain PyTorch
version, the ``fused_mrf_ct`` packer and two wrappers.

- :func:`fused_mrf_ct` replaces ``vocoder_kernels.py::fused_mrf_ct`` in its
  float modes (per-tap and merged-tap weights).
- :func:`fused_mrf_phase_noups` replaces ``fused_mrf_phase`` without the
  upsample prologue (``in_phase=False``: x in (B, C, T)), float mode.

Both TPU kernels pad x with zeros by a halo once per tile and run valid
convs on the window, so at every sample both compute the zero-padded valid
chains of :func:`vocoder_kernels.mrf_tc_plain`; the tile, the halo, the
phase layout and the merged taps change the summation order only. One CUDA
kernel per dtype serves both, one launch a level with the three chains on
chip (``csrc/mrf_ct.cuh``'s ``ct_kernel`` over the bf16 engine's chains,
``CtBf``, or the 3xTF32 chains on the tensor cores, ``CtF32``; plan
:func:`vocoder_kernels._ct_plan`); each wrapper
keeps its own counters and plain version. The port keeps the level
sample-major, (B, T, C), as the polyphase upsample before the level emits
it: the TPU kernels' (B, C, T) input transposed.
"""
import collections
import ctypes

import torch

from daft_exprt_torch.ops import _build
from daft_exprt_torch.ops.vocoder_kernels import (
    CT_BF_CFG, CT_CHANNELS, TC_F32_CFG, _F32, _I32, _I64, _P, _check_cuda_input,
    _check_kernel_sizes, _check_weights, _ct_args, _ct_plan, _empty_on, _fn,
    _scratch, aligned, mrf_tc_plain, prepare_mrf, sm_count,
)

def pack_mrf_weights(params, level, kernel_sizes, dilations,
                     merge_taps=False):
    """One level's resblock weights for ``fused_mrf_ct`` (port of its
    packer): per chain [w1, b1, w2, b2] with w (n_dil, k, C_out, C_in), or
    (n_dil, C_out, k*C_in) with ``merge_taps``, and b (n_dil, C, 1)."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        for prefix in ('convs1', 'convs2'):
            w = torch.stack([rb[f'{prefix}_{i}']['w'].permute(2, 0, 1)
                             for i in range(len(dils))])
            if merge_taps:
                n_dil, k, co, ci = w.shape
                w = w.permute(0, 2, 1, 3).reshape(n_dil, co, k * ci)
            out.append(w)
            out.append(torch.stack([rb[f'{prefix}_{i}']['b'][:, None]
                                    for i in range(len(dils))]))
    return out


def prepare_mrf_ct(weights, kernel_sizes, dilations, merge_taps=False):
    """:class:`vocoder_kernels.MrfWeights` from :func:`pack_mrf_weights`'s
    layout (or the JAX packer's arrays): the taps read back as (n_dil, k,
    C_in, C_out), the layout ``prepare_mrf`` takes."""
    packed = []
    for n, w in enumerate(weights):
        if n % 2:
            packed.append(w[..., 0])
            continue
        if merge_taps:
            n_dil, co, kc = w.shape
            ci = weights[n + 1].shape[1]
            w = w.reshape(n_dil, co, kc // ci, ci).permute(0, 2, 1, 3)
        packed.append(w.permute(0, 1, 3, 2))
    return prepare_mrf(packed, kernel_sizes, dilations)


def mrf_ct_plain(x, mrf):
    """The plain version of :func:`fused_mrf_ct` and of
    :func:`fused_mrf_phase_noups` (the same function). x: (B, T, C)."""
    return mrf_tc_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations)


mrf_phase_noups_plain = mrf_ct_plain

# x, x_bs, T, out, out_bs, ptrs, ints, scale, C, B, scratch, its floats,
# slots, stream (mrf_ct.cu mrf_ct_bf / mrf_ct_f32)
_CT_ARGTYPES = [_P, _I64, _I32, _P, _I64, _P, _P, _F32, _I32, _I32, _P, _I64,
                _I32, _P]


def _launch(wrapper, x, mrf):
    """The level kernel's launch for a call of ``wrapper``: ``ct_kernel``
    over CtBf in bf16, over CtF32 in float32, one launch."""
    name = wrapper.__name__
    B, T, C = x.shape
    f32 = x.dtype == torch.float32
    _check_cuda_input(x, name, CT_CHANNELS, C)
    _check_kernel_sizes(name, mrf.kernel_sizes)
    _check_weights(name, x, mrf)
    if mrf.packed[0].shape[-1] != C:
        raise ValueError(f'{name}: x has C={C} but the weights '
                         f'{mrf.packed[0].shape[-1]}')
    if mrf.blk is None:
        raise ValueError(
            f'{name}: the weights carry no {"float32" if f32 else "bf16"} '
            'engine form (prepare_mrf on the card)')
    x = aligned(x)
    slots = sm_count(x.device)
    pl = _ct_plan(x, mrf, _empty_on(x.device), slots)
    if f32:
        stages = (1, TC_F32_CFG[C].kch)
    else:
        stages = (CT_BF_CFG[C].tps, CT_BF_CFG[C].kch)
    ptrs, ints = _ct_args(pl, stages)
    pa = (ctypes.c_int64 * len(ptrs))(*ptrs)
    ia = (ctypes.c_int * len(ints))(*ints)
    scratch = _scratch(pl.scratch, x.device)
    kind = 'f32' if f32 else 'bf'
    err = _fn('mrf_ct', f'mrf_ct_{kind}', _CT_ARGTYPES)(
        _build.ptr(x), x.stride(0), T, _build.ptr(pl.out), pl.out.stride(0),
        ctypes.cast(pa, ctypes.c_void_p), ctypes.cast(ia, ctypes.c_void_p),
        1.0 / len(mrf.kernel_sizes), C, B, _build.ptr(scratch),
        scratch.numel(), slots, _build.stream_ptr(x))
    _build.check(err, f'MRF {kind} level without upsample (C={C}, '
                 f'block_m={pl.block_m})')
    wrapper.launches += 1
    wrapper.calls[tuple(x.shape) + (('float32',) if f32 else ())] += 1
    return pl.out


def fused_mrf_ct(x, mrf):
    """Fused MRF group of a level in ``fused_mrf_ct``'s float form. x: (B,
    T, C) in bfloat16 or float32, C in :data:`CT_CHANNELS`; ``mrf`` from
    ``prepare_mrf`` (or :func:`prepare_mrf_ct`) in x's dtype. Returns (B,
    T, C) in x's dtype. On a CUDA tensor this launches ``mrf_ct.cu`` once
    (or raises); on a CPU tensor it runs :func:`mrf_ct_plain`.

    ``fused_mrf_ct.launches`` counts CUDA launches;
    ``fused_mrf_ct.calls`` counts CUDA-route calls by x's shape (and
    'float32' for a float32 call)."""
    if x.device.type == 'cpu':
        return mrf_ct_plain(x, mrf)
    return _launch(fused_mrf_ct, x, mrf)


fused_mrf_ct.launches = 0
fused_mrf_ct.calls = collections.Counter()


def fused_mrf_phase_noups(x, mrf):
    """Fused MRF group of a narrow level in ``fused_mrf_phase``'s float form
    without the upsample prologue (the upsample ran before it). x: (B, T,
    C) in bfloat16 or float32; ``mrf`` as for :func:`fused_mrf_ct`.
    Returns (B, T, C) in x's dtype. On a CUDA tensor this launches
    ``mrf_ct.cu`` once (or raises); on a CPU tensor it runs
    :func:`mrf_phase_noups_plain`.

    ``fused_mrf_phase_noups.launches`` counts CUDA launches;
    ``fused_mrf_phase_noups.calls`` counts CUDA-route calls by x's shape
    (and 'float32' for a float32 call)."""
    if x.device.type == 'cpu':
        return mrf_phase_noups_plain(x, mrf)
    return _launch(fused_mrf_phase_noups, x, mrf)


fused_mrf_phase_noups.launches = 0
fused_mrf_phase_noups.calls = collections.Counter()

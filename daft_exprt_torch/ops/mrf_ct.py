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
kernel serves both; each wrapper keeps its own counters and plain version.
The port keeps the level sample-major, (B, T, C), as the polyphase
upsample before the level emits it: the TPU kernels' (B, C, T) input
transposed.
"""
import collections

import torch

from daft_exprt_torch.ops.vocoder_kernels import (
    _STEP_ARGTYPES, _check_cuda_input, _check_kernel_sizes, _check_weights,
    _empty_on, _fn, _launch_step, _tc_plan, mrf_tc_plain, prepare_mrf,
)

CT_CHANNELS = (8, 16, 32, 64)


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


def _launch(wrapper, name, x, mrf):
    B, T, C = x.shape
    _check_cuda_input(x, name, CT_CHANNELS, C)
    _check_kernel_sizes(name, mrf.kernel_sizes)
    _check_weights(name, x, mrf)
    x = x.contiguous()
    steps, out = _tc_plan(x, mrf.chains, mrf.kernel_sizes, mrf.dilations,
                          _empty_on(x.device))
    fn = _fn('mrf_ct', 'mrf_ct_step', _STEP_ARGTYPES)
    for st in steps:
        _launch_step(fn, st, B, C, x.dtype)
        wrapper.launches += 1
    wrapper.calls[tuple(x.shape)] += 1
    return out


def fused_mrf_ct(x, mrf):
    """Fused MRF group of a level in ``fused_mrf_ct``'s float form. x: (B,
    T, C) in bfloat16 or float32, C in :data:`CT_CHANNELS`; ``mrf`` from
    ``prepare_mrf`` (or :func:`prepare_mrf_ct`) in x's dtype. Returns (B,
    T, C) in x's dtype. On a CUDA tensor this launches ``mrf_ct.cu`` (or
    raises); on a CPU tensor it runs :func:`mrf_ct_plain`.

    ``fused_mrf_ct.launches`` counts CUDA launches (one per chain step);
    ``fused_mrf_ct.calls`` counts CUDA-route calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_ct_plain(x, mrf)
    return _launch(fused_mrf_ct, 'fused_mrf_ct', x, mrf)


fused_mrf_ct.launches = 0
fused_mrf_ct.calls = collections.Counter()


def fused_mrf_phase_noups(x, mrf):
    """Fused MRF group of a narrow level in ``fused_mrf_phase``'s float form
    without the upsample prologue (the upsample ran before it). x: (B, T,
    C) in bfloat16 or float32; ``mrf`` as for :func:`fused_mrf_ct`.
    Returns (B, T, C) in x's dtype. On a CUDA tensor this launches
    ``mrf_ct.cu`` (or raises); on a CPU tensor it runs
    :func:`mrf_phase_noups_plain`.

    ``fused_mrf_phase_noups.launches`` counts CUDA launches (one per chain
    step); ``fused_mrf_phase_noups.calls`` counts CUDA-route calls by x's
    shape."""
    if x.device.type == 'cpu':
        return mrf_phase_noups_plain(x, mrf)
    return _launch(fused_mrf_phase_noups, 'fused_mrf_phase_noups', x, mrf)


fused_mrf_phase_noups.launches = 0
fused_mrf_phase_noups.calls = collections.Counter()

"""HiFi-GAN generator (PyTorch port of ``daft_exprt_tpu/models/hifigan.py``;
V1 by default, any ResBlock1/2 config such as V2): conv_pre -> [lrelu ->
transposed-conv upsample -> multi-receptive-field resblock group] x n ->
lrelu -> conv_post -> tanh, on params kept as nested dicts in torch layout
(the JAX package's own layout, so the bridge is a copy).

Routes, as ``generator_forward`` in the JAX package:

- the float32 plain route (``use_fast=False``): one PyTorch op per conv,
  the semantics of the JAX XLA branch (per-conv SAME padding);
- the fast route (``use_fast=True``, bf16 in serving; ResBlock1): each
  level on the kernel :func:`level_routes` picks, the JAX generator's
  decision: a wide level (C >= 128) takes the polyphase upsample and
  ``fused_mrf_tc``; a narrow level whose phases chain (want_p = u * p_in,
  V1's L2 and L3) its upsample + MRF (+ conv_post at the last level)
  through ``fused_mrf_phase``; any other level (HiFi-GAN V2's four) the
  upsample, then ``fused_mrf_phase`` without prologue at p = 128/C >= 4
  phases, else ``fused_mrf_ct``. The CUDA kernels run on a CUDA tensor.
- the int8 tiers (``use_fast=True`` with ``int8=True``; the static tier
  with ``int8_act_scales`` from :func:`calibrate_act_scales`, the dynamic
  one without): the same levels in int8 where C % 32 == 0 (bf16 where
  not): a wide level through ``fused_mrf_tc_q8`` (static) or
  ``fused_mrf_ct_q8`` (dynamic), a chained narrow level through
  ``fused_mrf_ptc`` (after a static wide level, batch >=
  ``PTC_MIN_BATCH``: static mode, or ``dyn`` when ``int8_act_scales`` has
  no entry for the level) or ``fused_mrf_phase_q8`` (static below that
  batch, dynamic at every batch), any other level through
  ``fused_mrf_ct_q8f`` / ``fused_mrf_ct_q8`` or
  ``fused_mrf_phase_q8_noups``.

Three keywords stand for the JAX package's environment switches, with
their defaults: ``fuse_post=False`` (``DAFT_FUSE_POST=0``) packs and
launches the last chained narrow level without its conv_post epilogue, so
that level hands over the MRF output and lrelu -> conv_post -> tanh run
after the loop (the per-level error budget's setting);
``int8_fused=False`` (``DAFT_INT8_FUSED_EPI=0``) moves the static
ct, phase and chain levels to the ``q8s`` form (the float32 conv1 -> conv2
boundary: ``fused_mrf_ct_q8s`` and the q8s modes of the int8 phase
kernels); ``ptc_bf16=True`` (``DAFT_MRF_PTC_BF16=1``) takes the bf16
tier's chained narrow levels after a wide level, from ``PTC_MIN_BATCH``,
through ``fused_mrf_ptc_f`` (``fused_mrf_ptc``'s fdot mode). A chain level
whose upsample cannot fuse (p*C != p_in*C_in) runs lrelu and
:func:`conv_transpose1d_phase` in the phase layout, then the phase kernel
without prologue, as the JAX generator does; conv_post then runs in the
tail.

Reference checkpoints (weight-normed ``HiFiGANGenerator`` state dicts) load
through :func:`load_torch_generator`.
"""
import math
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from daft_exprt_torch.checkpoint import torch_load_guarded
from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.ops.mrf_ct import (
    fused_mrf_ct, fused_mrf_phase_noups, mrf_ct_plain, mrf_phase_noups_plain,
    pack_mrf_weights,
)
from daft_exprt_torch.ops.mrf_int8 import (
    conv_transpose1d_phase, ct_tile, fused_mrf_ct_q8, fused_mrf_ct_q8f,
    fused_mrf_ct_q8s, fused_mrf_phase_q8, fused_mrf_phase_q8_noups,
    fused_mrf_ptc, mrf_ct_q8_plain, mrf_ct_q8f_plain, mrf_ct_q8s_plain,
    mrf_phase_q8_noups_plain, mrf_phase_q8_plain, mrf_ptc_plain,
    pack_mrf_phase_weights, pack_post_phase_weights,
    pack_ups_phase_weights, phase_post_feasible, phase_tile,
    prepare_mrf_ct_q8, prepare_mrf_ct_q8f, prepare_mrf_ct_q8s,
    prepare_mrf_phase_q8, quantize_mrf_ct_q8f_weights,
    quantize_mrf_ct_q8s_weights, quantize_mrf_ct_weights,
    quantize_mrf_phase_weights, quantize_ups_phase_weights,
    ups_used_blocks,
)
from daft_exprt_torch.ops.vocoder_kernels import (
    MrfQ8Weights, MrfWeights, full_f32, fused_mrf_phase, fused_mrf_ptc_f,
    fused_mrf_tc, fused_mrf_tc_q8, mrf_phase_plain, mrf_ptc_f_plain,
    mrf_tc_plain, mrf_tc_q8_plain, pack_mrf_ptc_f_weights,
    pack_mrf_ptc_weights, pack_mrf_tc_int8_weights, pack_mrf_tc_weights,
    pack_post_ptc_weights, pack_ups_ptc_f_weights, pack_ups_ptc_weights,
    prepare_mrf, prepare_mrf_ptc, prepare_mrf_ptc_f, prepare_mrf_tc_q8,
    ptc_post_feasible, ptc_tile,
)

LRELU_SLOPE = 0.1
# the int8-static tier's narrow levels take the phase-tc kernel from this
# batch size on (``DAFT_PTC_MIN_BATCH`` of the JAX package), the int8
# fused_mrf_phase below it
PTC_MIN_BATCH = 8

DEFAULT_CONFIG = {
    'sampling_rate': 22050,
    'upsample_rates': [8, 8, 2, 2],
    'upsample_kernel_sizes': [16, 16, 4, 4],
    'upsample_initial_channel': 512,
    'resblock': '1',
    'resblock_kernel_sizes': [3, 7, 11],
    'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    'model_in_dim': 80,
}


def _conv1d(x, w, b, dilation=1, padding=None):
    """x: (B, C, T); w: (out, in, k) torch layout; SAME padding."""
    if padding is None:
        padding = dilation * (w.shape[-1] - 1) // 2
    y = F.conv1d(x, w, padding=padding, dilation=dilation)
    return y + b[None, :, None]


def _conv_transpose1d(x, w, b, stride, padding):
    """torch ConvTranspose1d semantics; w: (in, out, k)."""
    return F.conv_transpose1d(x, w, stride=stride, padding=padding) + \
        b[None, :, None]


def _conv_transpose1d_poly(x, w, b, s, p, in_tc=False):
    """Polyphase transposed conv (k - 2p == s) as one matmul over shifted
    copies of x: y[co, q*s + r] = sum_t sum_ci w[ci, co, j0(r) + t*s] *
    x[ci, q + delta(r) - t], j0(r) = (r + p) mod s, delta(r) = (r + p) // s.
    Returns (B, T*s, C_out) time-major, where the phase interleave is a
    reshape; ``in_tc`` says x is (B, T, C) rather than (B, C, T)."""
    if in_tc:
        B, T, C_in = x.shape
    else:
        B, C_in, T = x.shape
    C_out, k = w.shape[1], w.shape[-1]
    n_taps = k // s
    deltas = [(r + p) // s for r in range(s)]
    shifts = sorted({d - t for d in deltas for t in range(n_taps)},
                    reverse=True)
    hi, lo = max(shifts), min(shifts)
    t_axis = 1 if in_tc else 2
    left, right = (-lo if lo < 0 else 0), (hi if hi > 0 else 0)
    xp = F.pad(x, (0, 0, left, right) if in_tc else (left, right))
    stacked = torch.cat([xp.narrow(t_axis, left + sh, T) for sh in shifts],
                        dim=2 if in_tc else 1)
    col = {sh: i for i, sh in enumerate(shifts)}
    W = x.new_zeros(s * C_out, len(shifts) * C_in)
    for r in range(s):
        j0, d = (r + p) % s, deltas[r]
        for t in range(n_taps):
            c = col[d - t]
            W[r * C_out:(r + 1) * C_out, c * C_in:(c + 1) * C_in] = \
                w[:, :, j0 + t * s].t().to(x.dtype)
    if not in_tc:
        stacked = stacked.transpose(1, 2)                # (B, T, |S|*C_in)
    y = torch.matmul(stacked, W.t())                     # (B, T, s*C_out)
    return y.reshape(B, T * s, C_out) + b[None, None, :]


def _lrelu(x):
    """The slope is a constant of x's dtype, as in JAX, where the weakly
    typed 0.1 becomes bf16(0.1) against a bf16 x: 0.1f * x rounded to bf16
    differs on ~10% of the negative samples."""
    return torch.where(x >= 0, x, x * x.new_tensor(LRELU_SLOPE))


def _resblock1(params, x, dilations):
    for i, d in enumerate(dilations):
        xt = _conv1d(_lrelu(x), params[f'convs1_{i}']['w'],
                     params[f'convs1_{i}']['b'], dilation=d)
        xt = _conv1d(_lrelu(xt), params[f'convs2_{i}']['w'],
                     params[f'convs2_{i}']['b'])
        x = xt + x
    return x


def _resblock2(params, x, dilations):
    for i, d in enumerate(dilations):
        xt = _conv1d(_lrelu(x), params[f'convs_{i}']['w'],
                     params[f'convs_{i}']['b'], dilation=d)
        x = xt + x
    return x


def init_generator_params(seed=0, config=None, std=0.01, device=None):
    """Fresh generator params, normal(0, std) like the reference init,
    drawn from a CPU ``torch.Generator`` seeded with ``seed``."""
    cfg = config or DEFAULT_CONFIG
    generator = torch.Generator().manual_seed(int(seed))
    dev = resolve_device(device)

    def norm(*shape):
        return (std * torch.randn(shape, generator=generator)).to(dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    c0 = cfg['upsample_initial_channel']
    params: Dict[str, Any] = {
        'conv_pre': {'w': norm(c0, cfg['model_in_dim'], 7), 'b': zeros(c0)}}
    ch = c0
    for i, _ in enumerate(cfg['upsample_rates']):
        k = cfg['upsample_kernel_sizes'][i]
        out = c0 // (2 ** (i + 1))
        params[f'ups_{i}'] = {'w': norm(ch, out, k), 'b': zeros(out)}
        ch = out
        for j, (rk, dils) in enumerate(zip(cfg['resblock_kernel_sizes'],
                                           cfg['resblock_dilation_sizes'])):
            names = (('convs1', 'convs2') if cfg['resblock'] == '1'
                     else ('convs',))
            params[f'resblock_{i}_{j}'] = {
                f'{pre}_{l}': {'w': norm(out, out, rk), 'b': zeros(out)}
                for l in range(len(dils)) for pre in names}
    params['conv_post'] = {'w': norm(1, ch, 7), 'b': zeros(1)}
    return params


def _phase_for(c):
    """Phases that fill 128 lanes at channel width c (the JAX package's
    ``_phase_for``)."""
    if c <= 0 or c >= 128 or 128 % c != 0:
        return 1
    return min(8, 128 // c)


@dataclass(frozen=True)
class Route:
    """One level's kernel on the fast route, as the JAX generator picks it.

    ``kind``: 'tc' (a wide level: polyphase upsample, then
    ``fused_mrf_tc``), 'ptc' (``fused_mrf_ptc``: upsample prologue, MRF and
    conv_post epilogue), 'chain' (``fused_mrf_phase`` with its upsample
    prologue), 'phase' (the upsample, then ``fused_mrf_phase`` without it)
    or 'ct' (the upsample, then ``fused_mrf_ct``). ``mode``: '' (float;
    'ptc': the fdot mode), 'q8' (int8-dynamic; 'ptc': the dyn mode), 'q8f'
    (int8-static, fused s32 boundary) or 'q8s' (int8-static, float32
    boundary). ``p``:
    phases; ``tile``: phase-tc rows ('ptc'), phase columns ('chain',
    'phase') or samples ('ct'); ``merge``: ``fused_mrf_ct``'s merged
    taps; ``ups_p_in``: the input's phases when a 'phase' level's upsample
    is :func:`conv_transpose1d_phase` (a chain level whose upsample cannot
    fuse), 0 for the sample-major upsample."""
    kind: str
    mode: str = ''
    p: int = 1
    tile: int = 0
    merge: bool = False
    ups_p_in: int = 0


def _mrf_route(C, T, int8, static, int8_fused=True):
    """``_pallas_mrf``'s kernel for a level input (B, C, T) after the
    upsample: the phase kernel without prologue when p = 128/C >= 4 phases
    and a tile of >= 128 columns divides T, else ``fused_mrf_ct``
    (merged taps at C <= 64 unless int8). int8 needs C % 32 == 0."""
    q8 = int8 and C % 32 == 0
    mode = _int8_mode(static, int8_fused) if q8 else ''
    p = 128 // C if C > 0 and 128 % C == 0 else 1
    if p >= 4:
        p = min(p, 8)
        tile = phase_tile(T, p)
        if tile is not None:
            return Route('phase', mode, p, tile)
    return Route('ct', mode, 1, ct_tile(T, C), merge=C <= 64 and not q8)


def _int8_mode(static, int8_fused):
    """A level's int8 route mode: 'q8' (dynamic), else 'q8f' or 'q8s'."""
    return ('q8f' if int8_fused else 'q8s') if static else 'q8'


def level_routes(params, config=None, batch=1, frames=128, int8=False,
                 act_scales=None, ptc_min_batch=PTC_MIN_BATCH,
                 int8_fused=True, ptc_bf16=False):
    """The fast route's :class:`Route` per level for a (batch, n_mels,
    frames) mel: the JAX ``generator_forward``'s decision (``use_pallas=
    True``), condition for condition:

    - ``want_tc``: C >= 128, no phases yet, k - 2*pad == u > 1, and under
      int8 the level's static scales with C % 32 == 0;
    - ``want_ptc`` (after a tc level, batch >= ``ptc_min_batch``, p*C ==
      p_in*C_in == 128, C % 32 == 0; int8, or bf16 with ``ptc_bf16``) when
      a tile of >= 64 rows divides the level (from 8192 rows under int8,
      4096 in fdot): static with the level's scales, ``dyn`` without;
    - the phase chain when want_p = _phase_for(C) >= 2 equals u * p_in
      and a tile of >= 64 columns divides the level (``_pallas_mrf_phase``):
      its upsample fuses when p*C == p_in*C_in, else it runs before the
      phase kernel without prologue (a 'phase' route with ``ups_p_in``);
    - else the upsample, then ``_pallas_mrf``'s kernel (:func:`_mrf_route`).

    ``act_scales`` ({level: calibration entry}) makes a level int8-static
    (and implies ``int8``); without its entry a level is int8-dynamic.
    ``int8_fused`` and ``ptc_bf16`` are JAX's ``DAFT_INT8_FUSED_EPI`` and
    ``DAFT_MRF_PTC_BF16`` (module note); the 'tc' and 'ptc' static routes
    have one form only, as their TPU kernels."""
    cfg = config or DEFAULT_CONFIG
    if cfg['resblock'] != '1':
        raise ValueError('the fused kernels serve ResBlock1 generators')
    int8 = int8 or act_scales is not None
    routes, cur_p, cur_tc, T = [], 1, False, frames
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        c_in, c_out = params[f'ups_{i}']['w'].shape[:2]
        static = int8 and (act_scales or {}).get(i) is not None
        want_p = _phase_for(c_out)
        poly = k - 2 * ((k - u) // 2) == u
        if (c_out >= 128 and cur_p == 1 and poly and u > 1
                and (not int8 or static and c_out % 32 == 0)):
            routes.append(Route('tc', 'q8f' if int8 else ''))
            cur_tc, T = True, T * u
            continue
        chain = want_p >= 2 and want_p == u * cur_p and poly
        if ((int8 or ptc_bf16) and cur_tc and chain
                and batch >= ptc_min_batch and want_p * c_out == 128
                and cur_p * c_in == 128 and c_out % 32 == 0):
            tile = ptc_tile(T // cur_p, 8192 if int8 else 4096)
            if tile is not None:
                mode = ('q8f' if static else 'q8') if int8 else ''
                routes.append(Route('ptc', mode, want_p, tile))
                cur_p, T = want_p, T * u
                continue
        cur_tc = False
        if chain:
            tile = ptc_tile(T // cur_p, 8192 if int8 else 4096)
            if tile is not None:
                mode = _int8_mode(static, int8_fused) \
                    if int8 and c_out % 32 == 0 else ''
                routes.append(Route('chain', mode, want_p, tile)
                              if want_p * c_out == cur_p * c_in else
                              Route('phase', mode, want_p, tile,
                                    ups_p_in=cur_p))
                cur_p, T = want_p, T * u
                continue
        cur_p, T = 1, T * u
        routes.append(_mrf_route(c_out, T, int8, static, int8_fused))
    return routes


@dataclass
class NarrowLevel:
    """A chained narrow level's weights when it takes the phase-tc kernel
    from ``PTC_MIN_BATCH`` on: ``ptc`` for ``fused_mrf_ptc`` (int8, static
    or dyn) or ``fused_mrf_ptc_f`` (fdot), ``phase`` for the banded phase
    kernel the level takes below that batch (and, per tap, for its
    ``fused_mrf_ct`` fallback). A level without the phase-tc route packs
    ``ptc`` None."""
    ptc: Optional[Any]
    phase: Any


def _phase_int8_weights(params, i, cfg, p, p_in, act_scales, fused=True,
                        fuse_post=True):
    """The int8 phase kernel's weights of level i, packed as
    ``_pallas_mrf_phase`` packs them (bands, compact gather, jitted
    quantisation); ``act_scales`` (this level's calibration entry) selects
    the ``q8f`` form (``q8s`` when not ``fused``), None the dynamic one;
    conv_post at the last level unless not ``fuse_post``."""
    ks = tuple(cfg['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in cfg['resblock_dilation_sizes'])
    u, k = cfg['upsample_rates'][i], cfg['upsample_kernel_sizes'][i]
    pad = (k - u) // 2
    ph_scales = None
    if act_scales is not None:
        ph_scales = [s[ii] for s1, s2 in act_scales
                     for ii in range(s1.shape[0]) for s in (s1, s2)]
    qw = quantize_mrf_phase_weights(
        pack_mrf_phase_weights(params, i, ks, dils, p), ks, dils, p,
        ph_scales, fused)
    w_u = params[f'ups_{i}']['w']
    wb, bu, _, _ = pack_ups_phase_weights(w_u, params[f'ups_{i}']['b'], u,
                                          pad, p_in)
    ups = quantize_ups_phase_weights(wb, bu, ups_used_blocks(k, u, pad, p_in),
                                     w_u.shape[0])
    post = None
    if fuse_post and i == len(cfg['upsample_rates']) - 1:
        post = pack_post_phase_weights(params['conv_post']['w'],
                                       params['conv_post']['b'], p)
    return prepare_mrf_phase_q8(qw, ks, dils, p, tuple(ups) + (k, u, pad, p_in),
                                post)


def _pack_level(params, cfg, i, route, act_scales, int8_fused, fuse_post):
    """Level i's weights for ``route``, in the kernels' forms (conv_post
    at the last narrow level only with ``fuse_post``). Every form holds the
    per-tap chain weights that ``fused_mrf_ct`` and ``fused_mrf_phase``
    without prologue read (:func:`_chain_weights`)."""
    ks = tuple(cfg['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in cfg['resblock_dilation_sizes'])
    u, k = cfg['upsample_rates'][i], cfg['upsample_kernel_sizes'][i]
    pad = (k - u) // 2
    scales = (act_scales or {}).get(i)
    if route.kind in ('ptc', 'chain'):
        ups = (params[f'ups_{i}']['w'], params[f'ups_{i}']['b'], u, pad)
        post = (params['conv_post']['w'], params['conv_post']['b']) \
            if fuse_post and i == len(cfg['upsample_rates']) - 1 else None
        p, p_in = route.p, route.p // u
        pst = None if post is None or route.kind == 'chain' else \
            pack_post_ptc_weights(*post, p, dtype=post[0].dtype)
        if not route.mode:
            phase = prepare_mrf(pack_mrf_tc_weights(params, i, ks, dils), ks,
                                dils, ups, post)
            if route.kind == 'chain':
                return phase
            # fdot: bf16 dots whatever the params' dtype (_pallas_mrf_ptc)
            return NarrowLevel(prepare_mrf_ptc_f(
                pack_mrf_ptc_f_weights(params, i, ks, dils, p), ks, dils, p,
                tuple(pack_ups_ptc_f_weights(*ups, p_in))
                + (k, u, pad, p_in), pst), phase)
        lvl_scales = None if route.mode == 'q8' else scales
        ptc = None
        if route.kind == 'ptc':
            ptc = prepare_mrf_ptc(
                pack_mrf_ptc_weights(params, i, ks, dils, p, lvl_scales), ks,
                dils, p, tuple(pack_ups_ptc_weights(*ups, p_in))
                + (k, u, pad, p_in), pst)
        return NarrowLevel(ptc, _phase_int8_weights(
            params, i, cfg, p, p_in, lvl_scales, int8_fused, fuse_post))
    if route.mode == 'q8f' and route.kind == 'tc':
        return prepare_mrf_tc_q8(pack_mrf_tc_int8_weights(
            params, i, ks, dils, scales), ks, dils)
    if not route.mode:
        return prepare_mrf(pack_mrf_tc_weights(params, i, ks, dils), ks,
                           dils)
    w = pack_mrf_weights(params, i, ks, dils)
    if route.mode == 'q8':
        return prepare_mrf_ct_q8(quantize_mrf_ct_weights(w), ks, dils)
    ct_scales = [s for s1, s2 in scales for s in (s1, s2)]
    if route.mode == 'q8s':
        return prepare_mrf_ct_q8s(quantize_mrf_ct_q8s_weights(w, ct_scales),
                                  ks, dils)
    return prepare_mrf_ct_q8f(quantize_mrf_ct_q8f_weights(w, ct_scales), ks,
                              dils)


def _chain_weights(w):
    """The per-tap chain weights of any level form (a narrow level's are
    its phase kernel's)."""
    return w.phase if isinstance(w, NarrowLevel) else w


def _form(w):
    """The route mode weights ``w`` serve: '' (float), 'q8', 'q8f' or
    'q8s'."""
    if isinstance(w, MrfWeights):
        return ''
    return 'q8' if w.dynamic else 'q8s' if w.q8s else 'q8f'


def _serves(w, route, post):
    """Whether level weights ``w`` carry what ``route`` launches, a chained
    narrow level's with conv_post if and only if ``post``."""
    if route.kind == 'ptc':
        return isinstance(w, NarrowLevel) and w.ptc is not None and \
            _form(w.ptc) == route.mode and (w.ptc.post is not None) == post
    w = _chain_weights(w)
    if not isinstance(w, (MrfWeights, MrfQ8Weights)):
        return False
    return _form(w) == route.mode and (route.kind != 'chain' or (
        w.ups is not None and (w.post is not None) == post))


def pack_levels(params, config=None, act_scales=None, int8=False,
                int8_fused=True, ptc_bf16=False, fuse_post=True):
    """Per level, the weights its fused kernel takes, made once (the
    serving wrapper packs at construction): the weights of the route
    :func:`level_routes` picks for a batch of at least ``PTC_MIN_BATCH``
    mels of 128 frames (the wrapper pads every mel to a multiple of 128).
    Without ``int8``: :class:`MrfWeights` (with the upsample at a chain
    level and conv_post at the last one; a phase-tc level under
    ``ptc_bf16`` its :class:`NarrowLevel`). With ``int8`` (the static tier
    when the calibration's ``act_scales`` are given, else the dynamic one;
    weights quantised from the params' dtype as the JAX tiers quantise
    them): :class:`MrfQ8Weights` at a tc, ct or phase level, a chain
    level's :class:`NarrowLevel`, and float :class:`MrfWeights` where C %
    32 != 0. ``int8_fused`` and ``ptc_bf16`` as in :func:`level_routes`,
    ``fuse_post`` as in :func:`generator_forward`: pack with the values the
    generator runs with. They serve every input length: a chain level's
    weights also hold the per-tap ones its fallback to ``fused_mrf_ct``
    reads, and the ct and phase-without-prologue kernels read the same
    per-tap weights."""
    cfg = config or DEFAULT_CONFIG
    routes = level_routes(params, cfg, PTC_MIN_BATCH, 128, int8, act_scales,
                          int8_fused=int8_fused, ptc_bf16=ptc_bf16)
    return {i: _pack_level(params, cfg, i, r, act_scales, int8_fused,
                           fuse_post) for i, r in enumerate(routes)}


def _without_post(mrf, feasible):
    return mrf if mrf.post is None or feasible else replace(
        mrf, post=None, post_dev=None)


def _narrow_int8_level(x, lvl, route, plain):
    """One narrow level of an int8 tier on ``route`` ('ptc' or 'chain'): x
    (B, T, C_in) sample-major -> (B, p*T/p_in, C), or the waveform (B, 1,
    ...) when conv_post fused (where the tile leaves its halo room).
    Returns (y, whether conv_post fused)."""
    if route.kind == 'ptc':
        mrf = lvl.ptc
        mrf = _without_post(mrf, mrf.post is None or ptc_post_feasible(
            mrf.kernel_sizes, mrf.dilations, mrf.p, mrf.post[0].shape[0],
            route.tile))
        return (mrf_ptc_plain if plain else fused_mrf_ptc)(
            x, mrf, route.tile), mrf.post is not None
    mrf = _chain_weights(lvl)
    mrf = _without_post(mrf, mrf.post is None or phase_post_feasible(
        mrf.kernel_sizes, mrf.dilations, mrf.p, mrf.post[0].shape[0],
        route.tile))
    return (mrf_phase_q8_plain if plain else fused_mrf_phase_q8)(
        x, mrf, route.tile), mrf.post is not None


def _mrf_level(x, w, route, plain):
    """The MRF group of a level on a 'ct' or 'phase' route: x (B, T, C)
    sample-major (the upsample's output) -> (B, T, C)."""
    w = _chain_weights(w)
    if route.kind == 'ct':
        if route.mode == 'q8f':
            return (mrf_ct_q8f_plain if plain else fused_mrf_ct_q8f)(x, w)
        if route.mode == 'q8s':
            return (mrf_ct_q8s_plain if plain else fused_mrf_ct_q8s)(x, w)
        if route.mode == 'q8':
            return (mrf_ct_q8_plain if plain else fused_mrf_ct_q8)(
                x, w, route.tile)
        return (mrf_ct_plain if plain else fused_mrf_ct)(x, w)
    if route.mode:
        return (mrf_phase_q8_noups_plain if plain else
                fused_mrf_phase_q8_noups)(x, w, route.p, route.tile)
    return (mrf_phase_noups_plain if plain else fused_mrf_phase_noups)(x, w)


def _upsample_tc(x, ups, u, k, in_tc):
    """lrelu, then the level's ConvTranspose1d (polyphase when k - 2p == u,
    as the JAX ``_conv_transpose1d``), returned sample-major (B, T, C)."""
    pad = (k - u) // 2
    if k - 2 * pad == u and u > 1:
        return _conv_transpose1d_poly(_lrelu(x), ups['w'], ups['b'], u, pad,
                                      in_tc=in_tc)
    x = x.transpose(1, 2) if in_tc else x
    return _conv_transpose1d(_lrelu(x), ups['w'], ups['b'], u,
                             pad).transpose(1, 2)


def _upsample_phase(x, ups, u, k, p_in, in_tc):
    """lrelu, then the level's ConvTranspose1d in the phase layout
    (:func:`conv_transpose1d_phase` on phase-``p_in`` input, as the JAX
    generator upsamples a chain level whose upsample cannot fuse), returned
    sample-major (B, T, C)."""
    x = x if in_tc else x.transpose(1, 2)                # (B, T, C_in)
    B, T, C = x.shape
    x_p = x.reshape(B, T // p_in, p_in, C).permute(0, 2, 3, 1).reshape(
        B, p_in * C, T // p_in)
    y = conv_transpose1d_phase(_lrelu(x_p), ups['w'], ups['b'], u,
                               (k - u) // 2, p_in)
    po = u * p_in
    return y.reshape(B, po, -1, T // p_in).permute(0, 3, 1, 2).reshape(
        B, T * u, -1)


def generator_forward(params, mel, config=None, use_fast=False, packed=None,
                      int8=False, int8_act_scales=None,
                      ptc_min_batch=PTC_MIN_BATCH, plain=False,
                      int8_fused=True, ptc_bf16=False, fuse_post=True,
                      _tap=None):
    """mel: (B, n_mels, T) -> wav (B, 1, T * prod(upsample_rates)), in the
    dtype of ``mel`` (cast params to it first for the bf16 route).

    ``use_fast`` selects the fused-kernel route (see the module note), each
    level on its :func:`level_routes` kernel; ``int8`` its int8 tiers:
    static with ``int8_act_scales`` (from :func:`calibrate_act_scales`; they
    imply ``int8``), whose narrow levels take the phase-tc kernel from
    batch ``ptc_min_batch`` on, dynamic without; ``int8_fused`` and
    ``ptc_bf16``: the JAX package's ``DAFT_INT8_FUSED_EPI`` and
    ``DAFT_MRF_PTC_BF16`` switches and ``fuse_post`` (False: the last
    chained narrow level without its conv_post epilogue, the JAX package's
    ``DAFT_FUSE_POST=0``; module note); ``packed``:
    :func:`pack_levels` of the same params (and tier and switches), so the
    kernels' weight layouts are built once; ``plain`` runs the kernels'
    plain versions on any device (the card-side reference of
    ``chip_smoke.py``).
    ``_tap(level, x)`` is called after each level with the level output in
    (B, C, T) layout, or the waveform at a last level whose kernel fused
    conv_post."""
    cfg = config or DEFAULT_CONFIG
    num_kernels = len(cfg['resblock_kernel_sizes'])
    resblock = _resblock1 if cfg['resblock'] == '1' else _resblock2
    fast = use_fast and cfg['resblock'] == '1'
    int8 = bool(int8) or int8_act_scales is not None
    if int8 and not fast:
        raise ValueError('the int8 tiers run in the fused kernels: they need '
                         'use_fast=True and ResBlock1')
    routes = level_routes(params, cfg, mel.shape[0], mel.shape[2], int8,
                          int8_act_scales, ptc_min_batch, int8_fused,
                          ptc_bf16) if fast else None
    if fast and packed is None:
        packed = pack_levels(params, cfg, int8_act_scales, int8, int8_fused,
                             ptc_bf16, fuse_post)
    last = len(cfg['upsample_rates']) - 1

    x = _conv1d(mel, params['conv_pre']['w'], params['conv_pre']['b'])
    tc = False                     # x in (B, T, C) layout
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        ups = params[f'ups_{i}']
        pad = (k - u) // 2
        route = routes[i] if fast else None
        w = packed.get(i) if fast else None
        if fast and not _serves(w, route, fuse_post and i == last):
            raise ValueError(f'level {i}: the packed weights do not serve '
                             f'its route {route}; pack_levels the same '
                             'params for this tier and fuse_post')
        if route is not None and route.kind in ('ptc', 'chain') \
                and route.mode:
            # narrow level: int8 upsample + MRF (+ conv_post)
            if not tc:
                x = x.transpose(1, 2)
            x, post_done = _narrow_int8_level(x, w, route, plain)
            tc = not post_done
            if _tap is not None:
                _tap(i, x if post_done else x.transpose(1, 2))
            if post_done:
                return x
            continue
        if route is not None and route.kind in ('ptc', 'chain'):
            # narrow level: upsample + MRF (+ conv_post) in one kernel route
            x_in = x.transpose(1, 2) if tc else x
            if route.kind == 'ptc':          # fused_mrf_ptc's fdot mode
                mrf = w.ptc
                mrf = _without_post(mrf, mrf.post is None or ptc_post_feasible(
                    mrf.kernel_sizes, mrf.dilations, mrf.p,
                    mrf.post[0].shape[-1], route.tile))
                x = (mrf_ptc_f_plain if plain else fused_mrf_ptc_f)(
                    x_in, mrf, route.tile)
            else:
                mrf = _chain_weights(w)
                x = (_phase_plain if plain else fused_mrf_phase)(x_in, mrf)
            tc = False
            if _tap is not None:
                _tap(i, x)
            if mrf.post is not None:
                return x
            continue
        if route is not None:
            # polyphase (or dilated, or phase-layout) upsample to (B, T,
            # C), then the MRF kernel: the wide levels' tc, or ct / phase
            # without prologue
            x = _upsample_phase(x, ups, u, k, route.ups_p_in, tc) \
                if route.ups_p_in else _upsample_tc(x, ups, u, k, tc)
            if route.kind == 'tc' and route.mode:
                x = (mrf_tc_q8_plain if plain else fused_mrf_tc_q8)(x, w)
            elif route.kind == 'tc':
                x = (_tc_plain if plain else fused_mrf_tc)(x, w)
            else:
                x = _mrf_level(x, w, route, plain)
            tc = True
            if _tap is not None:
                _tap(i, x.transpose(1, 2))
            continue
        if tc:
            x = x.transpose(1, 2)
            tc = False
        x = _conv_transpose1d(_lrelu(x), ups['w'], ups['b'], u, pad)
        xs = None
        for j, dil in enumerate(cfg['resblock_dilation_sizes']):
            y = resblock(params[f'resblock_{i}_{j}'], x, dil)
            xs = y if xs is None else xs + y
        x = xs / num_kernels
        if _tap is not None:
            _tap(i, x)
    if tc:
        x = x.transpose(1, 2)
    x = _conv1d(_lrelu(x), params['conv_post']['w'], params['conv_post']['b'])
    return torch.tanh(x)


def _tc_plain(x, mrf):
    """:func:`vocoder_kernels.mrf_tc_plain` on prepared weights."""
    return mrf_tc_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations)


def _phase_plain(x, mrf):
    """:func:`vocoder_kernels.mrf_phase_plain` on prepared weights."""
    return mrf_phase_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations,
                           mrf.ups, mrf.post)


def calibrate_act_scales(params, mels, config=None):
    """Per-channel amax of every resblock conv input (after lrelu) in the
    float32 reference forward (per-conv SAME padding) on calibration mels:
    the int8 tier's static activation scales. Port of the JAX package's
    ``calibrate_act_scales``. Returns {level: [(s1, s2) per resblock]}
    with s1 (conv1 inputs: the residual stream) and s2 (conv2 inputs)
    float32 (n_dil, C) tensors on the params' device."""
    cfg = config or DEFAULT_CONFIG
    if cfg['resblock'] != '1':
        raise ValueError('static act-scale calibration targets the '
                         'ResBlock1 fused kernels')
    dev = params['conv_pre']['w'].device
    mels = torch.as_tensor(mels, dtype=torch.float32, device=dev)
    if mels.ndim == 2:
        mels = mels[None]
    scales = {}
    with torch.no_grad(), full_f32():
        x = _conv1d(mels, params['conv_pre']['w'], params['conv_pre']['b'])
        for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                       cfg['upsample_kernel_sizes'])):
            x = _conv_transpose1d(_lrelu(x), params[f'ups_{i}']['w'],
                                  params[f'ups_{i}']['b'], u, (k - u) // 2)
            xs, level = None, []
            for j, dils in enumerate(cfg['resblock_dilation_sizes']):
                rb = params[f'resblock_{i}_{j}']
                cur, s1, s2 = x, [], []
                for ii, d in enumerate(dils):
                    t1 = _lrelu(cur)
                    s1.append(t1.abs().amax(dim=(0, 2)))
                    a = _conv1d(t1, rb[f'convs1_{ii}']['w'],
                                rb[f'convs1_{ii}']['b'], dilation=d)
                    t2 = _lrelu(a)
                    s2.append(t2.abs().amax(dim=(0, 2)))
                    cur = cur + _conv1d(t2, rb[f'convs2_{ii}']['w'],
                                        rb[f'convs2_{ii}']['b'])
                level.append((torch.stack(s1), torch.stack(s2)))
                xs = cur if xs is None else xs + cur
            x = xs / len(cfg['resblock_kernel_sizes'])
            scales[i] = level
    return scales


def _fold_wn(sd, prefix):
    """One conv of a reference state dict as {'w', 'b'} float32: weight
    norm (dim 0) folded, w = g * v / max(|v|, 1e-12) over all but the first
    axis, or a plain ``.weight`` where weight norm was removed."""
    if f'{prefix}.weight_v' in sd:
        v = torch.as_tensor(sd[f'{prefix}.weight_v']).float()
        g = torch.as_tensor(sd[f'{prefix}.weight_g']).float()
        norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
        w = g * v / norm.clamp(min=1e-12)
    else:
        w = torch.as_tensor(sd[f'{prefix}.weight']).float()
    return {'w': w, 'b': torch.as_tensor(sd[f'{prefix}.bias']).float()}


def convert_torch_generator(state_dict, config=None):
    """A reference ``HiFiGANGenerator`` state dict (``conv_pre``, ``ups.{i}``,
    ``resblocks.{i*n_kernels + j}.convs1|convs2|convs.{l}``, ``conv_post``)
    -> the port's params, float32 tensors on the CPU."""
    cfg = config or DEFAULT_CONFIG
    sd = {k: v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(v)
          for k, v in state_dict.items()}
    params: Dict[str, Any] = {'conv_pre': _fold_wn(sd, 'conv_pre'),
                              'conv_post': _fold_wn(sd, 'conv_post')}
    num_kernels = len(cfg['resblock_kernel_sizes'])
    names = ('convs1', 'convs2') if cfg['resblock'] == '1' else ('convs',)
    for i in range(len(cfg['upsample_rates'])):
        params[f'ups_{i}'] = _fold_wn(sd, f'ups.{i}')
        for j, dils in enumerate(cfg['resblock_dilation_sizes']):
            n = i * num_kernels + j
            params[f'resblock_{i}_{j}'] = {
                f'{pre}_{l}': _fold_wn(sd, f'resblocks.{n}.{pre}.{l}')
                for l in range(len(dils)) for pre in names}
    return params


def generator_state_dict(params, config=None):
    """The port's params as a reference ``HiFiGANGenerator`` state dict
    (plain ``.weight`` / ``.bias``, float32 on the CPU): the inverse of
    :func:`convert_torch_generator`, for writing a checkpoint that
    :func:`load_torch_generator` reads."""
    cfg = config or DEFAULT_CONFIG
    sd = {}

    def put(prefix, conv):
        sd[f'{prefix}.weight'] = conv['w'].detach().float().cpu()
        sd[f'{prefix}.bias'] = conv['b'].detach().float().cpu()

    put('conv_pre', params['conv_pre'])
    put('conv_post', params['conv_post'])
    num_kernels = len(cfg['resblock_kernel_sizes'])
    names = ('convs1', 'convs2') if cfg['resblock'] == '1' else ('convs',)
    for i in range(len(cfg['upsample_rates'])):
        put(f'ups.{i}', params[f'ups_{i}'])
        for j, dils in enumerate(cfg['resblock_dilation_sizes']):
            for pre in names:
                for l in range(len(dils)):
                    put(f'resblocks.{i * num_kernels + j}.{pre}.{l}',
                        params[f'resblock_{i}_{j}'][f'{pre}_{l}'])
    return sd


def load_torch_generator(path, config=None):
    """Load a reference HiFi-GAN generator checkpoint (its state dict, or a
    dict holding it under 'generator' or 'state_dict') through
    ``checkpoint.torch_load_guarded`` (``weights_only=True``: a file that
    needs unpickling is refused) and convert it."""
    ckpt = torch_load_guarded(path)
    sd = ckpt.get('generator', ckpt.get('state_dict', ckpt)) \
        if isinstance(ckpt, dict) else ckpt
    return convert_torch_generator(sd, config)


def _to(params, dtype, device):
    return {k: (_to(v, dtype, device) if isinstance(v, dict)
                else v.to(device=device, dtype=dtype))
            for k, v in params.items()}


class HiFiGanVocoder:
    """Frozen inference wrapper (port of the JAX ``HiFiGanVocoder``).

    - ``fast=False``: the float32 plain route (TF32 off).
    - ``fast=True`` / ``'bf16'``: bf16 params and activations through the
      fused MRF kernels.
    - ``fast='int8'`` with ``int8_calibration_mels``: the int8-static tier
      (``bench.py``'s headline route). The act scales are calibrated once
      on those mels in float32 (:func:`calibrate_act_scales`), then the
      bf16 params are packed to int8.
    - ``fast='int8'`` without them: the int8-dynamic tier (the JAX
      wrapper's default int8 tier): every conv's activation scale is taken
      per tile at run time.

    ``params`` (the port's generator params) or ``checkpoint_path`` (a
    reference generator checkpoint, :func:`load_torch_generator`) give the
    weights; ``config`` the generator (V1 by default). Nothing is
    downloaded: with neither, it raises. ``int8_fused=False`` and
    ``ptc_bf16=True`` are the JAX package's ``DAFT_INT8_FUSED_EPI=0`` and
    ``DAFT_MRF_PTC_BF16=1`` (module note).
    """

    def __init__(self, params=None, config=None, fast=False, device=None,
                 int8_calibration_mels=None, checkpoint_path=None,
                 int8_fused=True, ptc_bf16=False):
        if fast not in (False, True, 'bf16', 'int8'):
            raise ValueError(f'unknown vocoder tier fast={fast!r}')
        if params is None:
            if checkpoint_path is None:
                raise ValueError('HiFiGanVocoder needs params or a '
                                 'checkpoint_path (no checkpoint is '
                                 'downloaded)')
            params = load_torch_generator(checkpoint_path, config)
        if int8_calibration_mels is not None and fast != 'int8':
            warnings.warn('int8_calibration_mels given but the serving tier '
                          f'is not int8 (fast={fast!r}): calibration ignored')
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.fast = bool(fast)
        self.int8 = fast == 'int8'
        self.dtype = torch.bfloat16 if self.fast else torch.float32
        self.act_scales = None
        if self.int8 and int8_calibration_mels is not None:
            self.act_scales = calibrate_act_scales(
                _to(params, torch.float32, self.device),
                int8_calibration_mels, self.config)
        self.params = _to(params, self.dtype, self.device)
        self.switches = dict(int8_fused=int8_fused, ptc_bf16=ptc_bf16)
        self.packed = pack_levels(self.params, self.config, self.act_scales,
                                  self.int8, **self.switches) if (
            self.fast and self.config['resblock'] == '1') else None

    def infer(self, mel_spec):
        """mel (n_mels, T) or (B, n_mels, T) -> float32 numpy wav in
        [-1, 1]. The fast tiers pad T to a multiple of 128 frames with the
        mel floor log(1e-5), as the JAX wrapper does, and crop the wav."""
        mel = torch.as_tensor(np.asarray(mel_spec, dtype=np.float32))
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        T0 = mel.shape[-1]
        if self.fast:
            t_pad = -(-T0 // 128) * 128
            if t_pad != T0:
                mel = F.pad(mel, (0, t_pad - T0), value=math.log(1e-5))
        hop = int(np.prod(self.config['upsample_rates']))
        mel = mel.to(self.device, self.dtype)
        with torch.no_grad():
            if self.fast:
                wav = generator_forward(self.params, mel, self.config,
                                        use_fast=True, packed=self.packed,
                                        int8=self.int8,
                                        int8_act_scales=self.act_scales,
                                        **self.switches)
            else:
                with full_f32():
                    wav = generator_forward(self.params, mel, self.config)
        audio = wav.float().cpu().numpy()[:, 0, :T0 * hop]
        if squeeze:
            audio = audio[0]
        return np.clip(audio, -1.0, 1.0)


def load_hifigan_vocoder(checkpoint_path=None, params=None, config=None,
                         fast=False, int8_calibration_mels=None, device=None,
                         int8_fused=True, ptc_bf16=False):
    """:class:`HiFiGanVocoder` from a reference checkpoint or params."""
    return HiFiGanVocoder(params=params, config=config, fast=fast,
                          device=device,
                          int8_calibration_mels=int8_calibration_mels,
                          checkpoint_path=checkpoint_path,
                          int8_fused=int8_fused, ptc_bf16=ptc_bf16)

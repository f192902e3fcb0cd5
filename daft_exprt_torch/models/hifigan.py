"""HiFi-GAN V1 generator (PyTorch port of
``daft_exprt_tpu/models/hifigan.py``): conv_pre -> [lrelu -> transposed-conv
upsample -> multi-receptive-field resblock group] x 4 -> lrelu -> conv_post
-> tanh, on params kept as nested dicts in torch layout (the JAX package's
own layout, so the bridge is a copy).

Routes, as ``generator_forward`` in the JAX package:

- the float32 plain route (``use_fast=False``): one PyTorch op per conv,
  the semantics of the JAX XLA branch (per-conv SAME padding);
- the fast route (``use_fast=True``, bf16 in serving): conv_pre and the
  wide levels' polyphase upsamples as plain PyTorch ops, the wide levels'
  MRF groups (C >= 128) through ``fused_mrf_tc`` and the narrow levels'
  upsample + MRF group (+ conv_post at the last level) through
  ``fused_mrf_phase`` — the CUDA kernels on a CUDA tensor;
- the int8 tiers (``use_fast=True`` with ``int8=True``; the static tier
  with ``int8_act_scales`` from :func:`calibrate_act_scales`, the dynamic
  one without): the wide levels through ``fused_mrf_tc_q8`` (static) or
  ``fused_mrf_ct_q8`` (dynamic, per-tile scales at every conv), the
  narrow levels (p phases x C channels = 128) with their upsample prologue
  and, at the last level, the conv_post epilogue through ``fused_mrf_ptc``
  (static, batch >= ``PTC_MIN_BATCH``) or ``fused_mrf_phase_q8`` (static
  below that batch, dynamic at every batch). A level no ported kernel
  serves raises ``NotImplementedError`` naming ROADMAP.md.
"""
import math
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.ops.mrf_int8 import (
    ct_tile, fused_mrf_ct_q8, fused_mrf_phase_q8, mrf_ct_q8_plain,
    mrf_phase_q8_plain, pack_mrf_phase_weights, pack_mrf_weights,
    pack_post_phase_weights, pack_ups_phase_weights, phase_post_feasible,
    prepare_mrf_ct_q8, prepare_mrf_phase_q8, quantize_mrf_ct_weights,
    quantize_mrf_phase_weights, quantize_ups_phase_weights, ups_used_blocks,
)
from daft_exprt_torch.ops.vocoder_kernels import (
    full_f32, fused_mrf_phase, fused_mrf_ptc, fused_mrf_tc, fused_mrf_tc_q8,
    mrf_ptc_plain, mrf_tc_q8_plain, pack_mrf_ptc_weights,
    pack_mrf_tc_int8_weights, pack_mrf_tc_weights,
    pack_post_ptc_weights, pack_ups_ptc_weights, prepare_mrf,
    prepare_mrf_ptc, prepare_mrf_tc_q8, ptc_post_feasible, ptc_tile,
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


def _fast_route(cfg, params, i):
    """The fast route's kernel for level i: 'tc' (wide level, C >= 128),
    'phase' (narrow level) or None (no fused kernel is ported for it)."""
    u, k = cfg['upsample_rates'][i], cfg['upsample_kernel_sizes'][i]
    pad = (k - u) // 2
    if cfg['resblock'] != '1' or not (k - 2 * pad == u and u > 1
                                      and k % u == 0):
        return None
    return 'tc' if params[f'ups_{i}']['w'].shape[1] >= 128 else 'phase'


def _phase_for(c):
    """Phases that fill 128 lanes at channel width c (the JAX package's
    ``_phase_for``)."""
    if c <= 0 or c >= 128 or 128 % c != 0:
        return 1
    return min(8, 128 // c)


def _narrow_phases(cfg, params):
    """{level: (p, p_in)} of the narrow levels the int8 phase kernels take
    (``want_ptc`` of the JAX generator less its batch and tile checks, and
    the phase chain's fused upsample): p phases after the upsample, p_in
    before, p*C == p_in*C_in == 128."""
    out, cur_p = {}, 1
    for i, u in enumerate(cfg['upsample_rates']):
        if _fast_route(cfg, params, i) != 'phase':
            continue
        c_in, c = params[f'ups_{i}']['w'].shape[:2]
        p = _phase_for(c)
        if not (p >= 2 and p == u * cur_p and p * c == 128
                and cur_p * c_in == 128 and c % 32 == 0):
            break
        out[i] = (p, cur_p)
        cur_p = p
    return out


@dataclass
class NarrowInt8:
    """A narrow level's int8 weights: ``ptc`` for ``fused_mrf_ptc`` (static
    tier only) and ``phase`` for ``fused_mrf_phase_q8`` (``q8f`` in the
    static tier, dynamic in the dynamic one)."""
    ptc: Optional[Any]
    phase: Any


def _phase_int8_weights(params, i, cfg, p, p_in, act_scales):
    """The int8 phase kernel's weights of level i, packed as
    ``_pallas_mrf_phase`` packs them (bands, compact gather, jitted
    quantisation); ``act_scales`` (this level's calibration entry) selects
    the ``q8f`` form, None the dynamic one."""
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
        ph_scales)
    w_u = params[f'ups_{i}']['w']
    wb, bu, _, _ = pack_ups_phase_weights(w_u, params[f'ups_{i}']['b'], u,
                                          pad, p_in)
    ups = quantize_ups_phase_weights(wb, bu, ups_used_blocks(k, u, pad, p_in),
                                     w_u.shape[0])
    post = None
    if i == len(cfg['upsample_rates']) - 1:
        post = pack_post_phase_weights(params['conv_post']['w'],
                                       params['conv_post']['b'], p)
    return prepare_mrf_phase_q8(qw, ks, dils, p, tuple(ups) + (k, u, pad, p_in),
                                post)


def pack_levels(params, config=None, act_scales=None, int8=False):
    """Per level, the weights its fused kernel takes. Without ``int8``:
    :class:`MrfWeights` (the MRF group's weights, plus the upsample at a
    narrow level and conv_post at the last level). With ``int8`` (the
    static tier when the calibration's ``act_scales`` are given, else the
    dynamic one; weights quantised from the params' dtype as the JAX tiers
    quantise them): the wide levels' :class:`MrfQ8Weights` for
    ``fused_mrf_tc_q8`` (static) or ``fused_mrf_ct_q8`` (dynamic) and the
    narrow levels' :class:`NarrowInt8`. Levels with no fused kernel are
    left out."""
    cfg = config or DEFAULT_CONFIG
    int8 = int8 or act_scales is not None
    ks = tuple(cfg['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in cfg['resblock_dilation_sizes'])
    n_ups = len(cfg['upsample_rates'])
    narrow = _narrow_phases(cfg, params) if int8 else {}
    levels = {}
    for i in range(n_ups):
        route = _fast_route(cfg, params, i)
        if route is None:
            continue
        u, k = cfg['upsample_rates'][i], cfg['upsample_kernel_sizes'][i]
        ups = (params[f'ups_{i}']['w'], params[f'ups_{i}']['b'], u,
               (k - u) // 2)
        post = (params['conv_post']['w'], params['conv_post']['b']) \
            if i == n_ups - 1 else None
        if not int8:
            levels[i] = prepare_mrf(
                pack_mrf_tc_weights(params, i, ks, dils), ks, dils,
                ups if route == 'phase' else None, post if route == 'phase'
                else None)
        elif route == 'tc' and act_scales is not None:
            levels[i] = prepare_mrf_tc_q8(pack_mrf_tc_int8_weights(
                params, i, ks, dils, act_scales[i]), ks, dils)
        elif route == 'tc':
            levels[i] = prepare_mrf_ct_q8(quantize_mrf_ct_weights(
                pack_mrf_weights(params, i, ks, dils)), ks, dils)
        elif i in narrow:
            p, p_in = narrow[i]
            ptc = None
            if act_scales is not None:
                u_ptc = pack_ups_ptc_weights(*ups, p_in)
                pst = None if post is None else pack_post_ptc_weights(
                    *post, p, dtype=post[0].dtype)
                ptc = prepare_mrf_ptc(
                    pack_mrf_ptc_weights(params, i, ks, dils, p,
                                         act_scales[i]),
                    ks, dils, p, tuple(u_ptc) + (k, u, (k - u) // 2, p_in),
                    pst)
            levels[i] = NarrowInt8(ptc, _phase_int8_weights(
                params, i, cfg, p, p_in,
                None if act_scales is None else act_scales[i]))
    return levels


def _without_post(mrf, feasible):
    return mrf if mrf.post is None or feasible else replace(
        mrf, post=None, post_dev=None)


def _narrow_int8_level(x, lvl, ptc_min_batch, plain):
    """One narrow level of an int8 tier: x (B, T, C_in) sample-major ->
    (B, p*T/p_in, C), or the waveform (B, 1, ...) when conv_post fused.
    The phase-tc kernel at batch >= ``ptc_min_batch`` (static tier), else
    the int8 phase kernel, each with its tile rule (8192 phase rows or
    columns, halved until it divides them). Returns (y, whether conv_post
    fused)."""
    mrf = lvl.ptc
    if mrf is not None and x.shape[0] >= ptc_min_batch:
        tile = ptc_tile(x.shape[1] // mrf.p_in)
        if tile is not None:
            mrf = _without_post(mrf, mrf.post is None or ptc_post_feasible(
                mrf.kernel_sizes, mrf.dilations, mrf.p, mrf.post[0].shape[0],
                tile))
            return (mrf_ptc_plain if plain else fused_mrf_ptc)(x, mrf, tile), \
                mrf.post is not None
    mrf = lvl.phase
    cols = x.shape[1] // mrf.p_in
    tile = ptc_tile(cols)
    if tile is None:
        raise NotImplementedError(
            f'int8 tier: a narrow level of {cols} phase columns (no tile of '
            '>= 64 columns divides them) needs the banded fallback through '
            'fused_mrf_ct, which is not ported (ROADMAP.md Queue 2)')
    mrf = _without_post(mrf, mrf.post is None or phase_post_feasible(
        mrf.kernel_sizes, mrf.dilations, mrf.p, mrf.post[0].shape[0], tile))
    return (mrf_phase_q8_plain if plain else fused_mrf_phase_q8)(
        x, mrf, tile), mrf.post is not None


def generator_forward(params, mel, config=None, use_fast=False, packed=None,
                      int8=False, int8_act_scales=None,
                      ptc_min_batch=PTC_MIN_BATCH, plain=False, _tap=None):
    """mel: (B, n_mels, T) -> wav (B, 1, T * prod(upsample_rates)), in the
    dtype of ``mel`` (cast params to it first for the bf16 route).

    ``use_fast`` selects the fused-kernel route (see the module note);
    ``int8`` its int8 tiers: static with ``int8_act_scales`` (from
    :func:`calibrate_act_scales`; they imply ``int8``), whose narrow levels
    take the phase-tc kernel from batch ``ptc_min_batch`` on, dynamic
    without; ``packed``: :func:`pack_levels` of the same params (and
    tier), so the kernels' weight layouts are built once; ``plain`` runs
    the int8 kernels' plain versions on any device (the card-side
    reference of ``chip_smoke.py``). ``_tap(level, x)`` is called after
    each level with the level output in (B, C, T) layout, or the waveform
    at a last level whose kernel fused conv_post."""
    cfg = config or DEFAULT_CONFIG
    num_kernels = len(cfg['resblock_kernel_sizes'])
    resblock = _resblock1 if cfg['resblock'] == '1' else _resblock2
    fast = use_fast and cfg['resblock'] == '1'
    int8 = bool(int8) or int8_act_scales is not None
    static = int8_act_scales is not None
    if int8 and not fast:
        raise ValueError('the int8 tiers run in the fused kernels: they need '
                         'use_fast=True and ResBlock1')
    if fast and packed is None:
        packed = pack_levels(params, cfg, int8_act_scales, int8)

    x = _conv1d(mel, params['conv_pre']['w'], params['conv_pre']['b'])
    tc = False                     # x in (B, T, C) layout
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        ups = params[f'ups_{i}']
        pad = (k - u) // 2
        route = _fast_route(cfg, params, i) if fast else None
        if route == 'tc':
            # wide level: polyphase upsample emits (B, T, C); the MRF kernel
            x = _conv_transpose1d_poly(_lrelu(x), ups['w'], ups['b'], u, pad,
                                       in_tc=tc)
            if static:
                x = (mrf_tc_q8_plain if plain else fused_mrf_tc_q8)(
                    x, packed[i])
            elif int8:
                if x.shape[2] % 32:
                    raise NotImplementedError(
                        f'int8-dynamic tier: level {i} (C={x.shape[2]}) needs '
                        'the float fused_mrf_ct, which is not ported '
                        '(ROADMAP.md Queue 2)')
                x = (mrf_ct_q8_plain if plain else fused_mrf_ct_q8)(
                    x, packed[i], ct_tile(x.shape[1], x.shape[2]))
            else:
                x = fused_mrf_tc(x, packed[i])
            tc = True
            if _tap is not None:
                _tap(i, x.transpose(1, 2))
            continue
        if route == 'phase' and int8:
            if i not in packed or not tc:
                raise NotImplementedError(
                    f'int8 tier: level {i} is not a narrow int8 level (p*C == '
                    '128 after a wide level); it needs the banded int8 '
                    'kernels, which are not ported (ROADMAP.md Queue 2)')
            # narrow level: int8 upsample + MRF (+ conv_post)
            x, post_done = _narrow_int8_level(x, packed[i], ptc_min_batch,
                                              plain)
            if _tap is not None:
                _tap(i, x if post_done else x.transpose(1, 2))
            if post_done:
                return x
            continue
        if route == 'phase':
            # narrow level: upsample + MRF (+ conv_post) in one kernel route
            x = fused_mrf_phase(x.transpose(1, 2) if tc else x, packed[i])
            tc = False
            if _tap is not None:
                _tap(i, x)
            if packed[i].post is not None:
                return x
            continue
        if fast:
            raise NotImplementedError(
                f'level {i} (k={k}, s={u}, C={ups["w"].shape[1]}) needs '
                'fused_mrf_ct, which is not ported yet (ROADMAP Queue 2)')
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
    """

    def __init__(self, params, config=None, fast=False, device=None,
                 int8_calibration_mels=None):
        if fast not in (False, True, 'bf16', 'int8'):
            raise ValueError(f'unknown vocoder tier fast={fast!r}')
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
        self.packed = pack_levels(self.params, self.config, self.act_scales,
                                  self.int8) if (
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
                                        int8_act_scales=self.act_scales)
            else:
                with full_f32():
                    wav = generator_forward(self.params, mel, self.config)
        audio = wav.float().cpu().numpy()[:, 0, :T0 * hop]
        if squeeze:
            audio = audio[0]
        return np.clip(audio, -1.0, 1.0)

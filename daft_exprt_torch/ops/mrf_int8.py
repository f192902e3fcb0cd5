"""int8 MRF kernels of the narrow levels and of the ct form: the CUDA
kernels ``csrc/mrf_ct_q8.cu``, ``csrc/mrf_phase_q8.cu`` and
``csrc/mrf_ptc.cu``, their plain PyTorch versions, packers and wrappers.

- :func:`fused_mrf_ct_q8` replaces ``vocoder_kernels.py::fused_mrf_ct``
  with ``int8_chain=True`` and no act scales (the ``q8`` branch of
  ``_fused_mrf_ct_kernel``): V1's wide levels and V2's L0 in the
  int8-dynamic tier. :func:`fused_mrf_ct_q8f` replaces it with act scales
  and the fused s32 boundary (``q8f``): V2's L0 in the int8-static tier;
  :func:`fused_mrf_ct_q8s` with act scales and the float32 boundary
  (``q8s``, JAX's ``DAFT_INT8_FUSED_EPI=0``).
- :func:`fused_mrf_phase_q8` replaces ``fused_mrf_phase`` with
  ``int8_chain=True``, its int8 upsample prologue and the bf16 conv_post
  epilogue, in its ``q8`` (dynamic), ``q8f`` (static, fused s32 boundary)
  and ``q8s`` modes: V1's narrow levels in the dynamic tier at any batch
  and in the static tier below ``PTC_MIN_BATCH``. Static (q8f, q8s): the
  tile amax, then ``fused_mrf_ptc``'s block-resident kernel on the phase
  tiles (:func:`_ptc_fused_plan` with :func:`_phase_geometry`).
  :func:`fused_mrf_phase_q8_noups` replaces it without the prologue
  (``in_phase=False``), every mode: V2's L1.
- :func:`fused_mrf_ptc` replaces ``fused_mrf_ptc`` (upsample prologue,
  optional conv_post epilogue) in its static mode (V1's narrow levels in
  the int8-static tier from ``PTC_MIN_BATCH``) and its ``dyn`` mode (a
  narrow level without a calibration entry after a static tc level).
  Static: the tile amax, then one block-resident kernel that runs the
  upsample, the chains and conv_post per block of output samples
  (:func:`_ptc_fused_plan`). Dyn: the dynamic phase kernel's engine on
  the phase-tc geometry (halo and tile in rows, 64-aligned): the windows of
  a dynamic conv are all p phases of the rows it reads, which is the phase
  layout's column window.

In dynamic mode every conv quantises its whole input window with one scale
per (utterance, tile, chain, dilation, conv), ``amax(|lrelu(x)|)/127``
over the window, so the TPU kernels' tile and halo are part of the
function. The port keeps each tile as a segment of its own and runs each
conv over exactly the TPU kernel's window (:func:`_dyn_windows`). Every
dynamic route (``fused_mrf_ct_q8`` at C = 256..32, ``fused_mrf_phase_q8``
and ``fused_mrf_ptc`` at (128, 64) / (64, 32), ``fused_mrf_phase_q8_noups``
at C = 64/32) runs on the segment-synchronised engine
(``csrc/mrf_dyn_blk.cuh``, :func:`_dyn_blk_plan`): it splits each segment
among resident blocks that keep their rows on chip and meet at a segment
barrier per conv, where their partial amaxes give the next scale; one
launch per chain at C = 256/128, one a level elsewhere. The phase layout
(p samples per phase column) is a reshape of the port's sample-major
tensors, so the windows are whole phase columns in samples. The static
levels without upsample (``fused_mrf_ct_q8f`` / ``_q8s`` and the static
``fused_mrf_phase_q8_noups``) are the zero-padded valid chains whatever the
tile: one launch a level of ``ptc_fused_q8_kernel`` without its prologue
(:func:`_static_plan`).

The packers mirror the JAX ones (held to them bit for bit by the tests);
``prepare_*`` read the per-tap int8 weights back out of them for the
sample-domain kernels.
"""
import collections
import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import _build
from daft_exprt_torch.ops.mrf_ct import pack_mrf_weights  # noqa: F401
from daft_exprt_torch.ops.vocoder_kernels import (
    ADD, DYN_BLK_CFG, FINAL, PHASE_CHANNELS, PTC_Q8_BM, PTC_Q8_NOUPS_BM,
    Q8_STAGES, WRITE,
    MrfQ8Weights, _AMAX_ARGTYPES, _F32, _I32, _I64, _P, _chain_q8, _const,
    _empty_on, _fma, _fn, _int_conv, _lrelu, _ups_phase_entries, aligned,
    chain_halo, check_q8_input, full_f32, fuse_boundary_consts,
    mrf_tc_q8_plain, pack_stage_s8, ptc_amax, ptc_chain_halo, ptc_halo_in,
    ptc_post_feasible, sm_count, staged_chains, ups_geometry,
)

CT_Q8_CHANNELS = (32, 64, 128, 256)     # fused_mrf_ct_q8 (dynamic)
CT_Q8F_CHANNELS = (32, 64)               # fused_mrf_ct_q8f / _q8s (static)


# ----------------------------------------------------------------------
# quantisation and geometry helpers (port of vocoder_kernels.py:54-139,
# 761-943)
# ----------------------------------------------------------------------

def _quantize_segments(v):
    """``_quantize_dynamic`` of lrelu(v), one scale per segment of float32
    (S, L, C): q = rint(t * (127/amax)), no clip, amax >= 1e-30 over the
    segment; returns (q int8, scale amax/127 (S,))."""
    t = _lrelu(v)
    amax = t.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    q = torch.round(t * (torch.full_like(amax, 127.0) / amax)[:, None, None])
    return q.to(torch.int8), amax * (1.0 / 127.0)


def resblock1_halo(kernel_size, dilations):
    """Per-side receptive field of one chain, rounded up to 64 samples."""
    return -(-chain_halo(kernel_size, dilations) // 64) * 64


def ct_halo(kernel_sizes, dilations):
    """``fused_mrf_ct``'s per-side halo: the widest chain's, 128-aligned."""
    h = max(resblock1_halo(k, d) for k, d in zip(kernel_sizes, dilations))
    return -(-h // 128) * 128


@functools.lru_cache(maxsize=None)
def _phase_conv_spec(k, d, p):
    """Geometry of one dilated conv in phase-p layout (``_phase_conv_spec``):
    a conv output column q reads input columns q + dmin .. q + dmax.
    Cached (a launch plan asks for it per conv and call); callers only
    read the dict."""
    half = (k - 1) // 2
    dmin = (-(d * half)) // p
    dmax = (p - 1 + d * half) // p
    j0 = -d * half - p * dmin
    used = tuple(sorted({r + d * t for r in range(p) for t in range(k)}))
    return dict(half=half, dmin=dmin, dmax=dmax, W=dmax - dmin + 1, j0=j0,
                kcols=p + d * (k - 1), used=used,
                runs=_stage_runs_of(used, j0, p))


def _stage_runs_of(used, j0, p):
    """``used`` blocks grouped into (slot, shift, phase row, length) runs."""
    runs = []
    i = 0
    while i < len(used):
        u, rp = divmod(j0 + used[i], p)
        ln = 1
        while (i + ln < len(used) and used[i + ln] == used[i] + ln
               and rp + ln < p):
            ln += 1
        runs.append((i, u, rp, ln))
        i += ln
    return tuple(runs)


def phase_chain_halo(kernel_sizes, dilations, p):
    """Per-side halo in phase columns of the fused chain, 128-aligned."""
    worst = 0
    for k, dils in zip(kernel_sizes, dilations):
        left = right = 0
        for d in dils:
            s1, s2 = _phase_conv_spec(k, d, p), _phase_conv_spec(k, 1, p)
            left += -s1['dmin'] - s2['dmin']
            right += s1['dmax'] + s2['dmax']
        worst = max(worst, left, right)
    return -(-worst // 128) * 128


def _phase_chain_geometry(kernel_sizes, dilations, p, tile, halo):
    """Per chain (column offset, columns left) after the fused chain."""
    geo = []
    for k, dils in zip(kernel_sizes, dilations):
        off, cur_len = 0, tile + 2 * halo
        for d in dils:
            s1, s2 = _phase_conv_spec(k, d, p), _phase_conv_spec(k, 1, p)
            off += -s1['dmin'] - s2['dmin']
            cur_len -= (s1['W'] - 1) + (s2['W'] - 1)
        geo.append((off, cur_len))
    return geo


def phase_post_feasible(kernel_sizes, dilations, p, post_k, tile):
    """True when the chain halo leaves room for the conv_post epilogue."""
    halo = phase_chain_halo(kernel_sizes, dilations, p)
    sp = _phase_conv_spec(post_k, 1, p)
    for off, cur_len in _phase_chain_geometry(kernel_sizes, dilations, p,
                                              tile, halo):
        start = halo + sp['dmin'] - off
        if start < 0 or start + tile + sp['W'] - 1 > cur_len:
            return False
    return True


def phase_halo_in(halo, ups_dmin, ups_dmax):
    """Per-side halo in input columns of the upsample prologue, 128-aligned
    (``_fused_mrf_phase_jit``'s ``halo_in``)."""
    return -(-max(halo - ups_dmin, halo + ups_dmax) // 128) * 128


def phase_tile(T, p, tile=4096):
    """The phase kernel's tile in columns for a (B, C, T) level input
    (``hifigan._pallas_mrf``): halved (down to 128) until p*tile divides
    T; None when none does (the level then takes ``fused_mrf_ct``)."""
    while T % (p * tile) and tile > 128:
        tile //= 2
    return None if T % (p * tile) else tile


def ct_tile(T, C, tile=8192):
    """``fused_mrf_ct``'s time tile (``hifigan._pallas_mrf``): halved while
    tile*C > 2^19 (down to 512), then until it divides T."""
    eff = tile
    while eff * C > (1 << 19) and eff > 512:
        eff //= 2
    if T % eff:
        eff = min(eff, T)
        while T % eff:
            eff //= 2
    return eff


# ----------------------------------------------------------------------
# packers (port of vocoder_kernels.py:121-131, 421-436, 468-495, 819-916,
# 1316-1349, 1380-1390)
# ----------------------------------------------------------------------
#
# The int8 weights of ``fused_mrf_ct`` and ``fused_mrf_phase`` are made
# inside their jitted wrappers, where XLA folds a division by a constant
# into a multiplication by its float32 reciprocal (and ``x * m / 127`` into
# ``x * f32(m/127)``): their scales differ from the eagerly packed tc/ptc
# ones by an ulp. The port's packers compute what the jitted code does.

def quantize_rows_jit(w, row_axes=(0,)):
    """:func:`quantize_rows` as XLA compiles it inside a jitted kernel
    wrapper: scale = max(amax, 1e-30) * f32(1/127), q = rint(w / scale)."""
    reduce = tuple(a for a in range(w.ndim) if a not in row_axes)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce, keepdim=True)
    s = amax.clamp(min=1e-30) * _const(wf, 1.0 / 127.0)
    return torch.round(wf / s).to(torch.int8), s


def quantize_mrf_ct_weights(weights):
    """``fused_mrf_ct``'s int8-dynamic weights from :func:`pack_mrf_weights`:
    per chain [wq1, sw1, b1, wq2, sw2, b2], wq int8 quantised per
    (dilation, output channel), sw (n_dil, C, 1), b float32."""
    qw = []
    for i in range(0, len(weights), 2):
        w, b = weights[i], weights[i + 1]
        n_dil, _, c_out, _ = w.shape
        wq, sw = quantize_rows_jit(w, row_axes=(0, 2))
        qw += [wq, sw.reshape(n_dil, c_out, 1), b.float()]
    return qw


def fold_act_scales_taps(w, s_in, margin=1.1):
    """Fold per-channel act scales into per-tap weights (n_dil, k, C_out,
    C_in): returns (folded float32, inv_s (n_dil, C_in, 1)), as jitted:
    s = max(s_in, 1e-30) * f32(margin/127)."""
    s = s_in.float().clamp(min=1e-30) * _const(s_in, margin / 127.0)
    return w.float() * s[:, None, None, :], (1.0 / s)[:, :, None]


def quantize_mrf_ct_q8f_weights(weights, act_scales):
    """``fused_mrf_ct``'s int8-static weights with the fused s32 boundary
    (``q8f``, its jitted wrapper's packing, vocoder_kernels.py:403-420)
    from :func:`pack_mrf_weights`: per chain [wq1, inv1, b1i, m1, wq2, sw2,
    b2], wq int8 (n_dil, k, C_out, C_in) quantised per (dilation, output
    channel) after the act scales fold into the input channels, the rest
    (n_dil, C, 1). ``act_scales``: per conv in pack order (conv1, conv2 of
    each chain) the calibrated amax, (n_dil, C)."""
    qw = []
    for j in range(0, len(weights), 4):
        w1, b1, w2, b2 = weights[j:j + 4]
        n_dil, _, c_out, _ = w1.shape
        w1f, inv1 = fold_act_scales_taps(w1, act_scales[j // 2])
        wq1, sw1 = quantize_rows_jit(w1f, row_axes=(0, 2))
        sw1 = sw1.reshape(n_dil, c_out, 1)
        w2f, inv2 = fold_act_scales_taps(w2, act_scales[j // 2 + 1])
        wq2, sw2 = quantize_rows_jit(w2f, row_axes=(0, 2))
        b1i, m1 = fuse_boundary_consts(sw1, b1, inv2)
        qw += [wq1, inv1, b1i, m1, wq2, sw2.reshape(n_dil, c_out, 1),
               b2.float()]
    return qw


def quantize_mrf_ct_q8s_weights(weights, act_scales):
    """``fused_mrf_ct``'s int8-static weights with the float32 boundary
    (``q8s``, its jitted wrapper's packing, vocoder_kernels.py:421-436)
    from :func:`pack_mrf_weights`: per conv [wq, sw, inv, b], i.e. per
    chain [wq1, sw1, inv1, b1, wq2, sw2, inv2, b2], wq int8 (n_dil, k,
    C_out, C_in) with the act scales folded into the input channels, sw
    (n_dil, C_out, 1), inv (n_dil, C_in, 1), b float32. ``act_scales``: per
    conv in pack order the calibrated amax, (n_dil, C)."""
    qw = []
    for i in range(0, len(weights), 2):
        w, b = weights[i], weights[i + 1]
        n_dil, _, c_out, _ = w.shape
        wf, inv = fold_act_scales_taps(w, act_scales[i // 2])
        wq, sw = quantize_rows_jit(wf, row_axes=(0, 2))
        qw += [wq, sw.reshape(n_dil, c_out, 1), inv, b.float()]
    return qw


def fold_act_scales_band(wd, s_in, C, p, margin=1.1):
    """Fold per-channel act scales into a banded phase matrix (p*C_out,
    kcols*C_in): column col reads channel col % C. Returns (folded float32,
    inv_s (p*C, 1)), as jitted: s = max(s_in, 1e-30) * f32(margin/127)."""
    s = s_in.float().clamp(min=1e-30) * _const(s_in, margin / 127.0)
    kcols = wd.shape[1] // C
    return wd.float() * s.repeat(kcols)[None, :], (1.0 / s).repeat(p)[:, None]


def pack_mrf_phase_weights(params, level, kernel_sizes, dilations, p):
    """One level's resblock weights as banded phase-p matrices: per (chain,
    dilation) [Wd1, b1, Wd2, b2] with Wd (p*C, (p + d(k-1))*C) (row block r
    = the phase-0 band shifted by r*C columns) and b (p*C, 1)."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        for i, d in enumerate(dils):
            for prefix, dd in (('convs1', d), ('convs2', 1)):
                w = rb[f'{prefix}_{i}']['w']
                C_out, C_in, kk = w.shape
                taps = w.permute(2, 0, 1)                      # (k, out, in)
                if dd > 1:
                    z = w.new_zeros((kk, dd - 1, C_out, C_in))
                    taps = torch.cat([taps[:, None], z], dim=1).reshape(
                        kk * dd, C_out, C_in)[:dd * (kk - 1) + 1]
                band = taps.permute(1, 0, 2).reshape(C_out, -1)
                out.append(torch.cat([F.pad(band, (r * C_in,
                                                   (p - 1 - r) * C_in))
                                      for r in range(p)]))
                out.append(rb[f'{prefix}_{i}']['b'].repeat(p)[:, None])
    return out


def pack_post_phase_weights(w, b, p):
    """conv_post (torch (C_out, C_in, k)) -> banded phase-p matrix
    (p*C_out, k*C_in) and bias (p*C_out, 1)."""
    C_out, C_in, k = w.shape
    band = w.permute(0, 2, 1).reshape(C_out, k * C_in)
    return (torch.cat([F.pad(band, (r * C_in, (p - 1 - r) * C_in))
                       for r in range(p)]), b.repeat(p)[:, None])


def ups_used_blocks(k, stride, padding, p_in):
    """The C_in-column blocks of the upsample band that any entry writes."""
    entries, dmin, _ = _ups_phase_entries(k, stride, padding, p_in)
    return tuple(sorted({(d - dmin) * p_in + a for _, _, a, d in entries}))


def pack_ups_phase_weights(w, b, stride, padding, p_in, dtype=None):
    """ConvTranspose1d (torch (C_in, C_out, k)) -> the banded phase matrix
    (po*C_out, W*p_in*C_in), bias (po*C_out, 1) float32, W and dmin."""
    C_in, C_out, k = w.shape
    entries, dmin, dmax = _ups_phase_entries(k, stride, padding, p_in)
    W = dmax - dmin + 1
    po = stride * p_in
    dt = dtype or w.dtype
    Wb = w.new_zeros((po * C_out, W * p_in * C_in), dtype=dt)
    wt = w.transpose(0, 1).to(dt)                          # (C_out, C_in, k)
    for r, j, a, d in entries:
        blk = (d - dmin) * p_in + a
        Wb[r * C_out:(r + 1) * C_out, blk * C_in:(blk + 1) * C_in] = \
            wt[:, :, j]
    return Wb, b.repeat(po)[:, None].float(), W, dmin


def conv_transpose1d_phase(x_p, w, b, stride, padding, p_in):
    """torch's ConvTranspose1d on a phase-``p_in`` input, emitting phase
    ``stride * p_in`` output (port of the JAX package's
    ``conv_transpose1d_phase``, which it leaves to XLA): one matmul of
    :func:`pack_ups_phase_weights`' band per shifted slice, summed in x_p's
    dtype, then the bias.

    x_p: (B, p_in*C_in, U) with x_p[:, a*C_in + c, u] = x[:, c, p_in*u + a];
    w: (C_in, C_out, k). Returns (B, stride*p_in*C_out, U) in the same
    layout."""
    B, PC, U = x_p.shape
    C_in = w.shape[0]
    if PC != p_in * C_in:
        raise ValueError(f'conv_transpose1d_phase: {PC} rows, not p_in * '
                         f'C_in = {p_in * C_in}')
    Wb, bias, W, dmin = pack_ups_phase_weights(w, b, stride, padding, p_in,
                                               dtype=x_p.dtype)
    xpad = F.pad(x_p, (-dmin, dmin + W - 1))
    pic = p_in * C_in
    y = None
    for u in range(W):
        part = torch.matmul(Wb[:, u * pic:(u + 1) * pic], xpad[:, :, u:u + U])
        y = part if y is None else y + part
    return y + bias[None].to(y.dtype)


def _gather(wd, spec, C):
    """The compact column gather: the band's ``spec['used']`` C-blocks."""
    return torch.cat([wd[:, jj * C:(jj + 1) * C] for jj in spec['used']],
                     dim=1)


def quantize_mrf_phase_weights(weights, kernel_sizes, dilations, p,
                               act_scales=None, fused=True):
    """``_fused_mrf_phase_jit``'s int8 chain weights (compact form) from
    :func:`pack_mrf_phase_weights`. Without ``act_scales`` the dynamic
    (``q8``) form, per (chain, dilation) [wq1, sw1, b1, wq2, sw2, b2];
    with them (per conv in pack order, (C,) calibrated amax) the fused
    static (``q8f``) form [wq1, inv1, b1i, m1, wq2, sw2, b2], or with
    ``fused=False`` the ``q8s`` form [wq1, sw1, inv1, b1, wq2, sw2, inv2,
    b2]. wq are the row-quantised bands with only their used column
    blocks."""
    C = weights[0].shape[0] // p
    kd = [(k, d) for k, ds in zip(kernel_sizes, dilations) for d in ds]

    def spec(pair):
        k, d = kd[pair // 2]
        return _phase_conv_spec(k, d if pair % 2 == 0 else 1, p)

    qw = []
    for j in range(0, len(weights), 4):
        wd1, b1, wd2, b2 = weights[j:j + 4]
        if act_scales is None:
            wq1, sw1 = quantize_rows_jit(wd1)
            wq2, sw2 = quantize_rows_jit(wd2)
            qw += [_gather(wq1, spec(j // 2), C), sw1, b1.float(),
                   _gather(wq2, spec(j // 2 + 1), C), sw2, b2.float()]
            continue
        wd1f, inv1 = fold_act_scales_band(wd1, act_scales[j // 2], C, p)
        wq1, sw1 = quantize_rows_jit(wd1f)
        wd2f, inv2 = fold_act_scales_band(wd2, act_scales[j // 2 + 1], C, p)
        wq2, sw2 = quantize_rows_jit(wd2f)
        if not fused:
            qw += [_gather(wq1, spec(j // 2), C), sw1, inv1, b1.float(),
                   _gather(wq2, spec(j // 2 + 1), C), sw2, inv2, b2.float()]
            continue
        b1i, m1 = fuse_boundary_consts(sw1, b1, inv2)
        qw += [_gather(wq1, spec(j // 2), C), inv1, b1i, m1,
               _gather(wq2, spec(j // 2 + 1), C), sw2, b2.float()]
    return qw


def quantize_ups_phase_weights(wb, b, used, C_in):
    """The int8 upsample prologue's weights: the band's used C_in blocks,
    row-quantised (wq, sw (rows, 1)), and the bias in float32."""
    wq, sw = quantize_rows_jit(torch.cat([wb[:, jj * C_in:(jj + 1) * C_in]
                                      for jj in used], dim=1))
    return wq, sw, b.float()


# ----------------------------------------------------------------------
# per-tap weights for the sample-domain kernels
# ----------------------------------------------------------------------

_CT_FORMS = {'q8': 6, 'q8f': 7, 'q8s': 8}       # arrays per chain


def _prepare_ct(qw, kernel_sizes, dilations, mode):
    """:class:`MrfQ8Weights` of a ct-packed level in form ``mode``: per
    step the taps (k, C_in, C_out) int8 and the (C,) vectors of each
    chain's ``_CT_FORMS[mode]`` arrays (int32 kept, the rest float32)."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    per = _CT_FORMS[mode]
    chains = []
    for j, dils in enumerate(dilations):
        arrs = qw[per * j:per * j + per]
        chains.append([tuple(
            a[i].transpose(1, 2) if a.dtype == torch.int8
            else a[i, :, 0].int() if a.dtype == torch.int32
            else a[i, :, 0].float() for a in arrs) for i in range(len(dils))])
    mrf = MrfQ8Weights(qw[0].device, kernel_sizes, dilations, chains,
                       dynamic=mode == 'q8', q8s=mode == 'q8s')
    if mrf.device.type == 'cuda':
        # the stages of the width's kernels: the dynamic engine and, q8f and
        # q8s (C = 64/32), ptc_fused_q8_kernel without prologue
        st = Q8_STAGES.get((chains[0][0][0].shape[-1],) * 2)
        if st is not None:
            mrf.blk_dev = staged_chains(chains, st.tps, st.kch)
    return mrf


def prepare_mrf_ct_q8(qw, kernel_sizes, dilations):
    """Dynamic :class:`MrfQ8Weights` of a wide level from
    :func:`quantize_mrf_ct_weights` (or the JAX packer's arrays)."""
    return _prepare_ct(qw, kernel_sizes, dilations, 'q8')


def prepare_mrf_ct_q8f(qw, kernel_sizes, dilations):
    """Static (``q8f``) :class:`MrfQ8Weights` from
    :func:`quantize_mrf_ct_q8f_weights` (or the JAX packer's arrays), the
    form of ``vocoder_kernels.prepare_mrf_tc_q8``."""
    return _prepare_ct(qw, kernel_sizes, dilations, 'q8f')


def prepare_mrf_ct_q8s(qw, kernel_sizes, dilations):
    """Static ``q8s`` :class:`MrfQ8Weights` from
    :func:`quantize_mrf_ct_q8s_weights` (or the JAX packer's arrays)."""
    return _prepare_ct(qw, kernel_sizes, dilations, 'q8s')


def _band_taps(wq, k, d, p, C_out):
    """(k, C_in, C_out) taps of row block 0 of a gathered band: tap t sits
    at column block d*t of the full band."""
    used = _phase_conv_spec(k, d, p)['used']
    C_in = wq.shape[1] // len(used)
    return torch.stack([
        wq[:C_out, used.index(d * t) * C_in:(used.index(d * t) + 1) * C_in].t()
        for t in range(k)])


def prepare_mrf_phase_q8(qw, kernel_sizes, dilations, p, ups, post=None):
    """:class:`MrfQ8Weights` of a narrow level from the phase packers:
    ``qw`` from :func:`quantize_mrf_phase_weights` (dynamic when its steps
    have six arrays, ``q8f`` when seven, ``q8s`` when eight); ``ups`` =
    (wq, sw, bias) from
    :func:`quantize_ups_phase_weights` followed by the ConvTranspose1d's
    (k, stride, padding, p_in); ``post`` = (Wd, b) from
    :func:`pack_post_phase_weights` at the last level (its dtype is the
    epilogue's)."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    n_steps = sum(len(d) for d in dilations)
    per = len(qw) // n_steps
    if per not in (6, 7, 8) or per * n_steps != len(qw):
        raise ValueError(f'{len(qw)} arrays for {n_steps} chain steps')
    C = qw[0].shape[0] // p
    chains, n = [], 0
    for k, dils in zip(kernel_sizes, dilations):
        steps = []
        for d in dils:
            st = qw[n:n + per]
            n += per
            t2 = 4 if per == 8 else per - 3       # the conv2 band's place
            steps.append(tuple(
                _band_taps(a, k, d if m == 0 else 1, p, C) if m in (0, t2)
                else a[:C, 0].int() if a.dtype == torch.int32
                else a[:C, 0].float() for m, a in enumerate(st)))
        chains.append(steps)
    wq_b, sw_b, b_b, k_u, stride, padding, p_in = ups
    if stride * p_in != p:
        raise ValueError(f'upsample stride {stride} x input phases {p_in} '
                         f'!= {p} phases')
    entries, dmin, dmax = _ups_phase_entries(k_u, stride, padding, p_in)
    used = ups_used_blocks(k_u, stride, padding, p_in)
    C_in = wq_b.shape[1] // len(used)
    where = {(r, j): (a, d) for r, j, a, d in entries}
    _, _, _, _, taps = ups_geometry(k_u, stride, padding)

    def tap(r, j):
        a, d = where[r, j]
        g = used.index((d - dmin) * p_in + a)
        return wq_b[r * C:(r + 1) * C, g * C_in:(g + 1) * C_in].t()

    wq_u = torch.stack([torch.stack([tap(r, j) for j in taps[r]])
                        for r in range(stride)])
    sw = torch.stack([sw_b[r * C:(r + 1) * C, 0].float()
                      for r in range(stride)])
    mrf = MrfQ8Weights(qw[0].device, kernel_sizes, dilations, chains,
                       dynamic=per == 6, q8s=per == 8, p=p, p_in=p_in,
                       ups=(wq_u, sw, b_b[:C, 0].float(), stride, padding,
                            k_u), ups_shifts=(dmin, dmax))
    if post is not None:
        Wd, b_p = post
        post_k = Wd.shape[1] // C - (p - 1)                # kcols = p + k - 1
        w_p = Wd[0, :post_k * C].reshape(post_k, C).float()  # (k, C)
        mrf.post = (w_p, b_p[:1, 0].float(), Wd.dtype)
    if mrf.device.type != 'cpu':
        st = Q8_STAGES.get((C_in, C))
        if st is not None:
            # the block-resident kernels' staged form (the dynamic engine
            # and, q8f and q8s, ptc_fused_q8_kernel); no other width has a
            # kernel
            mrf.blk_dev = staged_chains(chains, st.tps, st.kch)
            mrf.blk_ups_dev = (torch.cat([
                pack_stage_s8(wq_u[r], st.utps, st.ukch)
                for r in range(stride)]), sw.contiguous(),
                mrf.ups[2].contiguous())
        if mrf.post is not None:
            mrf.post_dev = (mrf.post[0].contiguous(), float(mrf.post[1][0]))
    return mrf


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def _conv_dyn(v, w, sw, b, d, start, n):
    """Samples [start, start + n) of the int8-dynamic conv of each segment
    of float32 v (S, L, C): lrelu(v) quantised with its segment's scale
    over all of v, tap t of output i reading v[start + i + t*d]; then
    fma(acc, sw*s_x, b)."""
    q, sx = _quantize_segments(v)
    acc = _int_conv(q[:, start:start + n + (w.shape[0] - 1) * d], w, d, n)
    return _fma(acc.float(), (sw[None, :] * sx[:, None])[:, None, :], b)


def _windows(x, step, halo, length):
    """Windows [t*step - halo, t*step - halo + length) of zero-padded x
    (B, T, C) for every tile t, as float32 segments (B*n_tiles, length, C)."""
    xin = F.pad(x.float(), (0, 0, halo, halo))
    return xin.unfold(1, length, step).transpose(2, 3).reshape(
        -1, length, x.shape[2])


def mrf_ct_q8_plain(x, mrf, tile):
    """The plain version of :func:`fused_mrf_ct_q8` (``fused_mrf_ct``,
    ``int8_chain=True``, dynamic). x: (B, T, C) sample-major, T a multiple
    of ``tile``. Each tile's chains run on the window [-halo, tile + halo)
    of zero-padded x, every conv quantised over its whole window."""
    B, T, C = x.shape
    if T % tile:
        raise ValueError(f'T={T} not a multiple of tile={tile}')
    halo = ct_halo(mrf.kernel_sizes, mrf.dilations)
    acc = None
    with full_f32():
        x0 = _windows(x, tile, halo, tile + 2 * halo)
        for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
            half = (k - 1) // 2
            cur = x0
            for (wq1, sw1, b1, wq2, sw2, b2), d in zip(mrf.chains[j], dils):
                L1 = cur.shape[1] - 2 * d * half
                a1 = _conv_dyn(cur, wq1, sw1, b1, d, 0, L1)
                L2 = L1 - 2 * half
                a2 = _conv_dyn(a1, wq2, sw2, b2, 1, 0, L2)
                sh = d * half + half
                cur = cur[:, sh:sh + L2] + a2
            extra = (cur.shape[1] - tile) // 2
            y = cur[:, extra:extra + tile]
            acc = y if acc is None else acc + y
    out = acc * (1.0 / len(mrf.kernel_sizes))
    return out.to(x.dtype).reshape(B, T, C)


def _phase_geometry(mrf, cols, tile):
    """(halo, halo_in, n_tiles, P) of a phase call in phase columns: chain
    halo, upsample input halo, tiles per utterance, conv_post reach."""
    if cols % tile:
        raise ValueError(f'T/p={cols} not a multiple of tile={tile}')
    halo = phase_chain_halo(mrf.kernel_sizes, mrf.dilations, mrf.p)
    P = 0
    if mrf.post is not None:
        post_k = mrf.post[0].shape[0]
        if not phase_post_feasible(mrf.kernel_sizes, mrf.dilations, mrf.p,
                                   post_k, tile):
            raise ValueError('chain halo too small for conv_post epilogue')
        P = (post_k - 1) // 2
    reach = max(chain_halo(k, d) for k, d in zip(mrf.kernel_sizes,
                                                 mrf.dilations)) + P
    if reach > halo * mrf.p:
        raise ValueError(f'chain reach {reach} beyond the {halo}-column halo')
    return (halo, phase_halo_in(halo, *mrf.ups_shifts), cols // tile, P)


def _ptc_geometry(mrf, rows, tile):
    """(halo, halo_in, n_tiles, P) of a phase-tc call: chain halo and
    upsample input halo in rows, tiles per utterance, conv_post reach."""
    if rows % tile:
        raise ValueError(f'rows={rows} not a multiple of tile={tile}')
    halo = ptc_chain_halo(mrf.kernel_sizes, mrf.dilations, mrf.p)
    P = 0
    if mrf.post is not None:
        post_k = mrf.post[0].shape[0]
        if not ptc_post_feasible(mrf.kernel_sizes, mrf.dilations, mrf.p,
                                 post_k, tile):
            raise ValueError('chain halo too small for conv_post epilogue')
        P = (post_k - 1) // 2
    reach = max(chain_halo(k, d) for k, d in zip(mrf.kernel_sizes,
                                                 mrf.dilations)) + P
    if reach > halo * mrf.p:
        raise ValueError(f'chain reach {reach} beyond the {halo}-row halo')
    return halo, ptc_halo_in(halo, mrf.ups_shifts), rows // tile, P


def _phase_prologue_plain(x, mrf, tile, halo, halo_in):
    """The int8 upsample prologue per tile: float32 segments (S, (tile +
    2*halo)*p, C), sample n of a tile at n + halo*p."""
    wq_u, sw_u, b_u, stride, padding, k_u = mrf.ups
    p_in = mrf.p_in
    _, amin, rows_r, _, _ = ups_geometry(k_u, stride, padding)
    M = (tile + 2 * halo) * p_in
    base = (halo_in - halo) * p_in + amin
    amax, win = ptc_amax(x, p_in, tile, halo_in)
    q = torch.round(win * (torch.full_like(amax, 127.0) / amax)
                    [:, None, None]).to(torch.int8)
    sx = amax * (1.0 / 127.0)
    x0 = win.new_empty((win.shape[0], M * stride, wq_u.shape[-1]))
    for r in range(stride):
        acc = _int_conv(q[:, base + rows_r[r]:], wq_u[r], 1, M)
        x0[:, r::stride] = _fma(acc.float(), (sw_u[r][None, :] * sx[:, None])
                                [:, None], b_u)
    return x0


def _phase_dyn_chain(x0, steps, k, dils, p, halo, N, P):
    """One chain in the phase kernel's dynamic form on segments x0 (sample
    n of a tile at n + halo*p): each conv over the phase columns the TPU
    kernel computes, quantised over them. Returns the chain output at
    samples [-P, tile*p + P)."""
    cur, off = x0, 0
    half = (k - 1) // 2
    for (wq1, sw1, b1, wq2, sw2, b2), d in zip(steps, dils):
        s1, s2 = _phase_conv_spec(k, d, p), _phase_conv_spec(k, 1, p)
        L1 = cur.shape[1] // p - (s1['W'] - 1)
        a1 = _conv_dyn(cur, wq1, sw1, b1, d, -p * s1['dmin'] - d * half,
                       p * L1)
        L2 = L1 - (s2['W'] - 1)
        a2 = _conv_dyn(a1, wq2, sw2, b2, 1, -p * s2['dmin'] - half, p * L2)
        shift = -s1['dmin'] - s2['dmin']
        cur = cur[:, p * shift:p * (shift + L2)] + a2
        off += shift
    lo = p * (halo - off) - P                # sample -P
    return cur[:, lo:lo + N + 2 * P]


def mrf_phase_q8_plain(x, mrf, tile):
    """The plain version of :func:`fused_mrf_phase_q8` (``fused_mrf_phase``
    with ``int8_chain=True``, the upsample prologue and, when
    ``mrf.post`` is set, the conv_post epilogue), in ``mrf.mode``. x: (B,
    cols*p_in, C_in) sample-major (the phase layout (B, p_in*C_in, cols)
    reshaped); ``tile`` phase columns per tile (divides cols). Returns (B,
    cols*p, C), or with ``post`` the waveform (B, 1, cols*p), in x's
    dtype."""
    return _narrow_plain(x, mrf, tile, _phase_geometry)


def mrf_ptc_plain(x, mrf, tile):
    """The plain version of :func:`fused_mrf_ptc` (static or ``dyn`` mode
    as ``mrf.mode`` says, with the upsample prologue and, when
    ``mrf.post`` is set, the conv_post epilogue). x: (B, rows*p_in, C_in)
    sample-major, the phase-tc rows (B, rows, p_in*C_in) reshaped. Each
    tile of ``tile`` rows is its own function of x: the upsample quantises
    its input window with the tile's own scale and the chains run on that
    tile's upsample output (dyn: each conv over the TPU kernel's rows, all
    p phases, quantised over them). Returns (B, rows*p, C) in x's dtype,
    or with ``post`` the waveform (B, 1, rows*p)."""
    return _narrow_plain(x, mrf, tile, _ptc_geometry)


def _narrow_plain(x, mrf, tile, geometry):
    """The int8 upsample prologue, chains and conv_post of a narrow level
    on the tiles and halos ``geometry`` (:func:`_phase_geometry` or
    :func:`_ptc_geometry`) gives."""
    B, T_in, _ = x.shape
    p = mrf.p
    halo, halo_in, n_t, P = geometry(mrf, T_in // mrf.p_in, tile)
    N = tile * p
    with full_f32():
        x0 = _phase_prologue_plain(x, mrf, tile, halo, halo_in)
        acc = None
        for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
            if mrf.dynamic:
                y = _phase_dyn_chain(x0, mrf.chains[j], k, dils, p, halo, N,
                                     P)
            else:
                y = _chain_q8(x0, mrf.chains[j], k, dils)
                lo = halo * p - chain_halo(k, dils) - P
                y = y[:, lo:lo + N + 2 * P]
            acc = y if acc is None else acc + y
        mean = acc * (1.0 / len(mrf.kernel_sizes))
        if mrf.post is None:
            return mean.to(x.dtype).reshape(B, n_t * N, -1)
        w_p, b_p, pdt = mrf.post
        t = _lrelu(mean).to(pdt).float().transpose(1, 2)
        y = F.conv1d(t, w_p.t()[None]) + b_p
    return torch.tanh(y).to(x.dtype).reshape(B, 1, n_t * N)


# The plain version of :func:`fused_mrf_ct_q8f` (``fused_mrf_ct``,
# ``int8_chain=True`` with act scales, fused boundary), x (B, T, C): static
# scales make each sample a fixed function of zero-padded x, the one
# ``vocoder_kernels.mrf_tc_q8_plain`` computes.
mrf_ct_q8f_plain = mrf_tc_q8_plain


# The plain version of :func:`fused_mrf_ct_q8s` (``q8s``): the same
# function class as q8f, the float32 boundary in each step.
mrf_ct_q8s_plain = mrf_tc_q8_plain


def mrf_phase_q8_noups_plain(x, mrf, p, tile):
    """The plain version of :func:`fused_mrf_phase_q8_noups`
    (``fused_mrf_phase``, ``int8_chain=True``, ``in_phase=False``, no
    upsample prologue), in ``mrf.mode``. x: (B, T, C) sample-major, T a
    multiple of ``tile*p``. q8f / q8s: the zero-padded static chains
    (:func:`mrf_ct_q8f_plain`'s function). Dynamic: each tile
    of ``tile`` phase columns runs the chains on the window [-halo, tile +
    halo) columns of zero-padded x, every conv over the TPU kernel's phase
    columns, quantised over them."""
    if not mrf.dynamic:
        return mrf_tc_q8_plain(x, mrf)
    B, T, C = x.shape
    halo = phase_chain_halo(mrf.kernel_sizes, mrf.dilations, p)
    N, E = tile * p, halo * p
    if T % N:
        raise ValueError(f'T={T} not a multiple of tile*p={N}')
    acc = None
    with full_f32():
        x0 = _windows(x, N, E, N + 2 * E)
        for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
            y = _phase_dyn_chain(x0, mrf.chains[j], k, dils, p, halo, N, 0)
            acc = y if acc is None else acc + y
    out = acc * (1.0 / len(mrf.kernel_sizes))
    return out.to(x.dtype).reshape(B, T, C)


# ----------------------------------------------------------------------
# launch plans (shared by the CUDA routes and the CPU replay in the tests)
# ----------------------------------------------------------------------

def _dyn_windows(k, dils, p, lo, hi, out_lo, out_hi):
    """Each conv's output window [l, h) (tile samples) of one chain in
    dynamic form on the input window [lo, hi), conv1 then conv2 per
    dilation. p = 1: ``fused_mrf_ct``'s (each conv shrinks by its reach per
    side); p > 1: the phase kernel's (whole phase columns,
    ``_phase_conv_spec``). The chain's last conv2 is cut to [out_lo,
    out_hi)."""
    half = (k - 1) // 2
    wins = []
    c_lo, c_hi = lo, hi
    for i, d in enumerate(dils):
        if p == 1:
            l1, h1 = c_lo + d * half, c_hi - d * half
            l2, h2 = l1 + half, h1 - half
        else:
            sp1, sp2 = _phase_conv_spec(k, d, p), _phase_conv_spec(k, 1, p)
            l1 = c_lo - p * sp1['dmin']
            h1 = l1 + (c_hi - c_lo) - p * (sp1['W'] - 1)
            l2 = l1 - p * sp2['dmin']
            h2 = l2 + (h1 - l1) - p * (sp2['W'] - 1)
        if i == len(dils) - 1:
            l2, h2 = out_lo, out_hi
        wins += [(l1, h1), (l2, h2)]
        c_lo, c_hi = l2, h2
    return wins


@dataclass
class PtcFusedPlan:
    """The two launches of :func:`fused_mrf_ptc`'s static mode over S =
    B*n_tiles segments (segment b*n_tiles + t is tile t of utterance b).
    ``amax_kernel`` writes ``amax[seg]`` (float bits, from 0), the amax of
    lrelu(x) over input samples [t*tile_in - halo_in, ... + win_len).
    ``ptc_fused_q8_kernel``'s block i of a segment owns the tile's output
    samples n in [i*block_m, (i+1)*block_m) (N per tile): it quantises
    lrelu(x) with the tile's scale over its own input rows, runs the
    upsample (output sample stride*m + r from input m + amin + rows[r] +
    tap, tap < ntaps) and each chain on the tile samples [i*block_m - hx,
    (i+1)*block_m + hx), and writes the chain mean times ``scale`` at its
    samples, or with conv_post (kpost taps, reach P) the waveform. Without
    upsample (:func:`_static_plan`: ``amax`` None, stride 1, no input rows)
    each chain of block i reads its x window straight from x."""
    x: torch.Tensor
    amax: Optional[torch.Tensor]
    n_tiles: int
    tile_in: int
    halo_in: int
    win_len: int
    stride: int
    ntaps: int
    amin: int
    rows: list
    span: int
    N: int
    hx: int
    P: int
    kpost: int
    block_m: int
    blocks_per_tile: int
    scale: float
    out: torch.Tensor


def _ptc_fused_plan(x, mrf, tile, alloc, block_m=None,
                    geometry=_ptc_geometry):
    """Launch plan of :func:`fused_mrf_ptc`'s static mode (and, with
    :func:`_phase_geometry`, of :func:`fused_mrf_phase_q8`'s q8f and q8s
    modes, the same functions on the phase kernel's tiles); ``block_m``
    defaults to the kernel's for the level's (C_in, C)."""
    B, T_in, C_in = x.shape
    p, p_in = mrf.p, mrf.p_in
    halo, halo_in, n_t, P = geometry(mrf, T_in // p_in, tile)
    wq_u, _, _, stride, padding, k_u = mrf.ups
    C = wq_u.shape[-1]
    ntaps, amin, rows, span, _ = ups_geometry(k_u, stride, padding)
    N = tile * p
    reach = max(chain_halo(k, d) for k, d in zip(mrf.kernel_sizes,
                                                 mrf.dilations)) + P
    hx = -(-reach // stride) * stride
    if hx > halo * p:
        raise ValueError(f'fused_mrf_ptc: block window {hx} beyond the '
                         f'{halo * p}-sample segment halo')
    bm = block_m or PTC_Q8_BM[C_in, C]
    if bm % stride:
        raise ValueError(f'fused_mrf_ptc: stride {stride} must divide the '
                         f'block {bm}')
    S = B * n_t
    out = alloc((B, n_t * N, C) if mrf.post is None else (B, 1, n_t * N),
                x.dtype)
    kpost = 0 if mrf.post is None else mrf.post[0].shape[0]
    return PtcFusedPlan(x, alloc((S,), torch.float32), n_t, tile * p_in,
                        halo_in * p_in, (tile + 2 * halo_in) * p_in, stride,
                        ntaps, amin, rows, span, N, hx, P, kpost, bm,
                        -(-N // bm), 1.0 / len(mrf.kernel_sizes), out)


def _static_plan(x, mrf, alloc):
    """Launch plan of the static levels without upsample
    (:func:`fused_mrf_ct_q8f`, :func:`fused_mrf_ct_q8s`, the static
    :func:`fused_mrf_phase_q8_noups`): ``ptc_fused_q8_kernel`` without its
    prologue, one segment an utterance (the static chains do not depend on
    the tile), block i of utterance b owning samples [i*block_m, (i+1)*
    block_m) and running each chain on x over its window [i*block_m - h,
    (i+1)*block_m + h) (h: the chain's reach; zero outside the utterance);
    block_m is the kernel's for x's width."""
    B, T, C = x.shape
    bm = PTC_Q8_NOUPS_BM[C]
    hx = max(chain_halo(k, d) for k, d in zip(mrf.kernel_sizes,
                                              mrf.dilations))
    return PtcFusedPlan(x, None, 1, T, 0, 0, 1, 0, 0, [], 0, T, hx, 0, 0, bm,
                        -(-T // bm), 1.0 / len(mrf.kernel_sizes),
                        alloc((B, T, C), x.dtype))


_PTC_FUSED_ARGTYPES = ([_P, _I64, _I32, _P, _P, _I64, _P, _P, _F32, _F32]
                       + [_I32] * 5 + [_P])


def _ptc_fused_args(plan, mrf, chains, ups):
    """The pointer and int arrays of ``mrf_ptc_fused`` (their order is the
    C entry point's) for staged ``chains`` (per step q8f's seven arrays or
    q8s's eight) and upsample ``ups`` (None without upsample)."""
    C_in = plan.x.shape[2]
    C = C_in if ups is None else mrf.ups[0].shape[-1]
    tps, kch, utps, ukch = Q8_STAGES[C_in, C]
    if ups is None:
        ptrs, wu_phase = [0] * 4, 0
    else:
        wu, swu, bu = ups
        ptrs = [wu.data_ptr(), swu.data_ptr(), bu.data_ptr(),
                mrf.post_dev[0].data_ptr() if plan.kpost else 0]
        wu_phase = wu.numel() // plan.stride
    ptrs += [t.data_ptr() for steps in chains for st in steps for t in st]
    rows = list(plan.rows) + [0] * (8 - len(plan.rows))
    ints = [plan.stride, plan.ntaps, plan.amin, plan.span] + rows + [
        plan.n_tiles, plan.tile_in, plan.N, plan.hx, plan.P, plan.kpost,
        plan.block_m, tps, kch, utps, ukch, wu_phase, len(mrf.kernel_sizes)]
    for k, dils in zip(mrf.kernel_sizes, mrf.dilations):
        ints += [k, len(dils)] + list(dils) + [0] * (4 - len(dils))
    return ((ctypes.c_int64 * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints))


@dataclass
class DynChain:
    """One chain of the dynamic engine's plan: its convs' output windows
    ``wins`` (tile samples, conv1 then conv2 per dilation) and ``rem``,
    the reach a block still needs per side around its owned samples: rem[0]
    for x0, rem[c + 1] after conv c (the later convs' reaches plus the
    conv_post reach P)."""
    k: int
    dils: tuple
    wins: list
    rem: list
    weights: Optional[list]   # per step (w1, sw1, b1, w2, sw2, b2), staged


@dataclass
class DynBlkLaunch:
    """One launch of ``dyn_blk_kernel``: its chains (one launch per chain:
    one, its output by ``mode`` into the chain sum or, FINAL, ``out``; else
    all, summed on chip into the level's output); each segment's G blocks own ``block_m`` samples of X
    each (block i from x_lo + i*block_m), R row 0 at a block's first owned
    sample - ``hx``; the grid holds ``slots`` blocks and walks the segments
    in ``n_waves`` waves of ``spw`` whole segments (grid block g of wave w
    serves block g % G of segment w*spw + g // G); ``n_bar`` segment
    barriers per item, whose scale words and arrival counts are ``sync``
    (2, n_bar, S), zero at launch."""
    chains: list
    hx: int
    block_m: int
    G: int
    spw: int
    n_waves: int
    n_bar: int
    sync: torch.Tensor
    mode: int
    has_acc: bool


@dataclass
class DynBlkPlan:
    """The segment-synchronised engine's plan of a dynamic call
    (``fused_mrf_ct_q8``, ``fused_mrf_phase_q8``, ``fused_mrf_ptc`` dyn,
    ``fused_mrf_phase_q8_noups``): ``amax_kernel`` into ``amax0`` (without
    upsample: x's amax over each window, the first conv's scale; else the
    upsample input's), then ``launches``. Segment seg = b*n_tiles + t owns
    the window X = [x_lo, x_hi) of x0 (tile samples), which each launch
    splits among its blocks (:class:`DynBlkLaunch`). Each chain's output
    leaves over [out_lo, out_hi) (with upsample the chain mean there, then
    conv_post with reach P); ``sum``: the float32 chain sum of a plan of
    one launch per chain."""
    x_lo: int
    x_hi: int
    out_lo: int
    out_hi: int
    P: int
    S: int
    n_tiles: int
    tile_in: int
    N: int
    launches: list
    sync: torch.Tensor
    amax0: torch.Tensor
    sum: Optional[torch.Tensor]
    out: torch.Tensor
    scale: float


def dyn_block_range(plan, launch, i, rem, win):
    """Samples [lo, hi) that block i of a segment computes of a window
    ``win`` with ``rem`` samples of reach still needed: its owned samples
    grown by rem per side, cut to the window (empty when lo >= hi)."""
    o_lo = plan.x_lo + i * launch.block_m
    o_hi = min(o_lo + launch.block_m, plan.x_hi)
    return max(o_lo - rem, win[0]), min(o_hi + rem, win[1])


@functools.lru_cache(maxsize=None)
def _dyn_blocks(X, hx, S, slots, cfg, stride, block_m=None):
    """(block_m, G, spw, n_waves) of one launch over segments of X samples
    with block halo ``hx``: the block size (a multiple of ``stride``) and
    blocks a segment that minimise the waves times a block's work (its MMA
    passes at full rows plus its rows: the MMAs of a pass cost the same
    whatever rows it holds), a block holding at most cfg[0] rows;
    ``block_m`` fixes the block size."""
    wrows_max, rows_pass = cfg.wrows, cfg.rows_pass
    if block_m is not None:
        cands = [block_m]
    else:
        bm_max = (wrows_max - 2 * hx) // stride * stride
        if bm_max < stride:
            raise ValueError(f'the dynamic engine: block halo {hx} leaves no '
                             f'room in {wrows_max} rows')
        # the even split of X into G blocks, for every G the card holds
        # (none when the smallest G does not fit: bm_max raises below)
        cands = sorted({-(-(-(-X // G)) // stride) * stride
                        for G in range(-(-X // bm_max), slots + 1)},
                       reverse=True) or [bm_max]
    best = None
    for bm in cands:
        G = -(-X // bm)
        if G > slots:
            raise ValueError(f'the dynamic engine: a segment of {X} samples '
                             f'takes {G} blocks of {bm}, but one launch '
                             f'holds {slots} resident blocks')
        spw = slots // G
        waves = -(-S // spw)
        wrows = bm + 2 * hx
        cost = waves * (rows_pass * -(-wrows // rows_pass) + wrows)
        if best is None or cost < best[0]:
            best = (cost, bm, G, spw, waves)
    return best[1:]


def _dyn_blk_plan(x, mrf, tile, weights, alloc, slots, block_m=None,
                  geometry=_phase_geometry, p=1):
    """Plan of the dynamic engine for x and dynamic ``mrf``: a narrow level
    with its upsample on the tiles and halos ``geometry`` gives
    (:func:`_phase_geometry`, the default, or :func:`_ptc_geometry`), or,
    when ``mrf.ups`` is None, a level without upsample on the windows of
    ``p`` phases: 1 ``fused_mrf_ct``'s (``tile`` samples a tile), else the
    phase kernel's (``tile`` columns of p samples, a halo of
    :func:`phase_chain_halo` columns). ``weights`` per chain (staged),
    ``slots`` the blocks one launch holds. A level without upsample at
    C = 256/128, where the chain sum does not fit on chip, takes one launch
    per chain, its output into a float32 chain sum; every other level takes
    one launch with the sum on chip (``DynTypes::LEVEL`` in
    mrf_dyn_blk.cuh)."""
    B, T_in, C_in = x.shape
    if mrf.ups is None:
        C = C_in
        if p == 1:
            halo = ct_halo(mrf.kernel_sizes, mrf.dilations)
        else:
            halo = phase_chain_halo(mrf.kernel_sizes, mrf.dilations, p) * p
        N = tile * p
        if T_in % N:
            raise ValueError(f'T={T_in} not a multiple of the tile\'s {N} '
                             'samples')
        n_t, tile_in, P = T_in // N, N, 0
        x_lo, x_hi, out_lo, out_hi = -halo, N + halo, 0, N
        stride = 1
    else:
        p = mrf.p
        C = mrf.ups[0].shape[-1]
        halo, _, n_t, P = geometry(mrf, T_in // mrf.p_in, tile)
        N, tile_in, E = tile * p, tile * mrf.p_in, halo * p
        x_lo, x_hi, out_lo, out_hi = -E, N + E, -P, N + P
        stride = mrf.ups[3]
    level = C_in != C or C <= 64        # DynTypes::LEVEL
    cfg = DYN_BLK_CFG[C_in, C]
    S = B * n_t
    chains = []
    for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
        half = (k - 1) // 2
        reach = [r for d in dils for r in (d * half, half)]
        chains.append(DynChain(
            k, tuple(dils), _dyn_windows(k, dils, p, x_lo, x_hi, out_lo,
                                         out_hi),
            [P + sum(reach[c:]) for c in range(len(reach) + 1)],
            None if weights is None else weights[j]))
    nb = len(chains)
    if not level:            # one launch per chain, the sum in float32
        groups = [([ch], ch.rem[0], 2 * len(ch.dils) - 1,
                   FINAL if j == nb - 1 else (WRITE if j == 0 else ADD),
                   j > 0) for j, ch in enumerate(chains)]
    else:                    # one launch a level, the sum on chip
        hx = max(ch.rem[0] for ch in chains)
        groups = [(chains, -(-hx // stride) * stride,
                   int(mrf.ups is not None)
                   + sum(2 * len(ch.dils) - 1 for ch in chains), FINAL,
                   False)]
    sync = alloc((sum(2 * g[2] * S for g in groups),), torch.int32)
    launches, at = [], 0
    for chs, hx, n_bar, mode, has_acc in groups:
        launches.append(DynBlkLaunch(
            chs, hx, *_dyn_blocks(x_hi - x_lo, hx, S, slots, cfg, stride,
                                  block_m), n_bar,
            sync[at:at + 2 * n_bar * S].view(2, n_bar, S), mode, has_acc))
        at += 2 * n_bar * S
    if mrf.post is None:
        out = alloc((B, n_t * N, C), x.dtype)
    else:
        out = alloc((B, 1, n_t * N), x.dtype)
    return DynBlkPlan(x_lo, x_hi, out_lo, out_hi, P, S, n_t, tile_in, N,
                      launches, sync,
                      alloc((S,), torch.float32),
                      alloc((B, T_in, C), torch.float32)
                      if not level and nb > 1 else None, out, 1.0 / nb)


# ----------------------------------------------------------------------
# CUDA launches
# ----------------------------------------------------------------------

_DYN_BLK_ARGTYPES = ([_P, _I64, _I32, _P, _P, _P, _I64, _P, _I64, _P, _P,
                      _F32, _F32, _P, _I64, _I32, _I32, _I32, _P])
_MAX_SEGMENTS = 65535                 # the launch grid's y extent


def _check_segments(name, S):
    if S > _MAX_SEGMENTS:
        raise ValueError(f'{name}: {S} tiles in the batch exceed the launch '
                         f'grid ({_MAX_SEGMENTS}); split the batch')


def fused_mrf_ct_q8(x, mrf, tile):
    """Fused MRF group of a level in the int8-dynamic form (``fused_mrf_ct``
    with ``int8_chain=True``, no act scales). x: (B, T, C) bfloat16
    sample-major, C in :data:`CT_Q8_CHANNELS`; ``mrf`` from
    :func:`prepare_mrf_ct_q8`; ``tile``
    samples per tile (divides T; :func:`ct_tile` gives the JAX package's
    rule). Returns (B, T, C) bfloat16. On a CUDA tensor this launches
    ``mrf_ct_q8.cu`` (or raises); on a CPU tensor it runs
    :func:`mrf_ct_q8_plain`.

    ``fused_mrf_ct_q8.launches`` counts CUDA launches (the window amax,
    then the segment-synchronised engine: at C = 256/128 one launch per
    chain, at C = 64/32 one); ``fused_mrf_ct_q8.calls`` counts CUDA-route
    calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_ct_q8_plain(x, mrf, tile)
    C = x.shape[2]
    check_q8_input('fused_mrf_ct_q8', x, mrf, CT_Q8_CHANNELS, C, 'dynamic')
    out = _launch_dyn_blk(fused_mrf_ct_q8, 'mrf_ct_q8', aligned(x),
                          _without_ups(mrf), tile)
    fused_mrf_ct_q8.calls[tuple(x.shape)] += 1
    return out


fused_mrf_ct_q8.launches = 0
fused_mrf_ct_q8.calls = collections.Counter()


def fused_mrf_phase_q8(x, mrf, tile):
    """Upsample + fused MRF group (+ conv_post) of a narrow level in the
    int8 forms of ``fused_mrf_phase`` (``int8_chain=True``): dynamic,
    ``q8f`` (static, fused s32 boundary) or ``q8s`` (static, float32
    boundary), as ``mrf.mode`` says; the upsample's input scale is dynamic
    per tile in every mode. x: (B, cols*p_in, C_in) bfloat16 sample-major
    (the previous level's output as it stands); ``mrf`` from
    :func:`prepare_mrf_phase_q8` (on a CPU tensor, q8f, also from
    ``vocoder_kernels.prepare_mrf_ptc``: the same per-tap weights);
    ``tile`` phase columns per tile (divides cols). Returns (B, cols*p, C),
    or with ``mrf.post`` the waveform (B, 1, cols*p), bfloat16. On a CUDA
    tensor this launches ``mrf_phase_q8.cu`` (or raises); on a CPU tensor
    it runs :func:`mrf_phase_q8_plain`.

    ``fused_mrf_phase_q8.launches`` counts CUDA launches (at (C_in, C) =
    (128, 64) / (64, 32), the only widths built: the amax and one launch of
    the dynamic engine or, q8f and q8s, ``ptc_fused_q8_kernel``);
    ``fused_mrf_phase_q8.calls`` counts CUDA-route calls by x's shape and
    mode: (B, T_in, C_in, ``mrf.mode``)."""
    if mrf.ups is None:
        raise ValueError('fused_mrf_phase_q8: the weights carry no upsample')
    if x.device.type == 'cpu':
        return mrf_phase_q8_plain(x, mrf, tile)
    if not mrf.dynamic:
        return _launch_ptc_fused(fused_mrf_phase_q8, 'mrf_phase_q8', x, mrf,
                                 tile, _phase_geometry, mrf.blk_dev,
                                 mrf.blk_ups_dev)
    C = _check_narrow_width('fused_mrf_phase_q8', x, mrf)
    check_q8_input('fused_mrf_phase_q8', x, mrf, PHASE_CHANNELS, C)
    out = _launch_dyn_blk(fused_mrf_phase_q8, 'mrf_phase_q8', aligned(x), mrf,
                          tile)
    fused_mrf_phase_q8.calls[tuple(x.shape) + (mrf.mode,)] += 1
    return out


fused_mrf_phase_q8.launches = 0
fused_mrf_phase_q8.calls = collections.Counter()


def fused_mrf_ptc(x, mrf, tile):
    """Upsample + fused MRF group (+ conv_post) of a narrow level in the
    int8 forms of ``fused_mrf_ptc``: static (the serving tier's, q8f
    arithmetic) or ``dyn`` (every conv's scale taken per tile), as
    ``mrf.mode`` says. x: (B, rows*p_in, C_in) bfloat16 sample-major (the
    phase-tc rows (B, rows, p_in*C_in) reshaped; the previous level's
    output as it stands); ``mrf`` from
    ``vocoder_kernels.prepare_mrf_ptc``; ``tile`` phase rows per tile
    (divides rows). Returns (B, rows*p, C), or with ``mrf.post`` the
    waveform (B, 1, rows*p), bfloat16. On a CUDA tensor this launches
    ``mrf_ptc.cu`` (static) or ``mrf_phase_q8.cu`` (dyn), or raises; on a
    CPU tensor it runs :func:`mrf_ptc_plain`.

    ``fused_mrf_ptc.launches`` counts CUDA launches (static: amax, the
    fused kernel; dyn: amax, one launch of the segment-synchronised
    engine, ``mrf_phase_q8.cu``'s on the phase-tc tiles);
    ``fused_mrf_ptc.calls`` counts CUDA-route calls by x's shape and mode:
    (B, T_in, C_in, 'q8f' or 'dynamic')."""
    if mrf.ups is None:
        raise ValueError('fused_mrf_ptc: the weights carry no upsample')
    if x.device.type == 'cpu':
        return mrf_ptc_plain(x, mrf, tile)
    if mrf.q8s:
        raise ValueError('fused_mrf_ptc has no q8s mode')
    if mrf.dynamic:
        C = _check_narrow_width('fused_mrf_ptc', x, mrf)
        check_q8_input('fused_mrf_ptc', x, mrf, PHASE_CHANNELS, C)
        out = _launch_dyn_blk(fused_mrf_ptc, 'mrf_phase_q8', aligned(x), mrf,
                              tile, _ptc_geometry)
        fused_mrf_ptc.calls[tuple(x.shape) + (mrf.mode,)] += 1
        return out
    return _launch_ptc_fused(fused_mrf_ptc, 'mrf_ptc', x, mrf, tile,
                             _ptc_geometry, mrf.chains_dev, mrf.ups_dev)


fused_mrf_ptc.launches = 0
fused_mrf_ptc.calls = collections.Counter()


def _without_ups(mrf):
    """A level's weights for a kernel without prologue: a chain level's
    (``prepare_mrf_phase_q8``) lose their upsample and conv_post, whose
    per-tap chains and staged form are the ct ones (its fallback)."""
    if mrf.ups is None:
        return mrf
    return replace(mrf, ups=None, post=None, post_dev=None, blk_ups_dev=None,
                   p=1, p_in=1, ups_shifts=())


def _check_narrow_width(name, x, mrf):
    """C of a narrow int8 level, which must have a CUDA instantiation:
    an upsample (C_in, C) of :data:`PTC_Q8_BM` (the dynamic engine's
    narrow widths too)."""
    C_in, C = x.shape[2], mrf.ups[0].shape[-1]
    built = tuple(PTC_Q8_BM)
    if (C_in, C) not in built:
        raise ValueError(f'{name}: upsample {C_in}->{C} has no CUDA '
                         f'instantiation (built for {built})')
    return C


def _launch_amax(lib, x, pro, S, stream):
    """``amax_kernel`` over the segments of a :class:`PtcFusedPlan`, into
    ``pro.amax``."""
    B, T_in, C_in = x.shape
    err = _fn(lib, f'{lib}_amax', _AMAX_ARGTYPES)(
        _build.ptr(x), x.stride(0), T_in, C_in, pro.n_tiles, pro.tile_in,
        pro.halo_in, pro.win_len, _build.ptr(pro.amax), S, stream)
    _build.check(err, f'{lib} amax')


def _launch_ptc_fused(wrapper, lib, x, mrf, tile, geometry, chains, ups):
    """The launches of a :class:`PtcFusedPlan` on ``geometry``'s tiles
    (``fused_mrf_ptc`` static, ``fused_mrf_phase_q8`` q8f and q8s) with the
    staged weights ``chains`` and ``ups`` through ``lib``'s entry points,
    counted on ``wrapper``."""
    name = wrapper.__name__
    B, T_in, C_in = x.shape
    C = _check_narrow_width(name, x, mrf)
    check_q8_input(name, x, mrf, PHASE_CHANNELS, C)
    x = aligned(x)
    plan = _ptc_fused_plan(x, mrf, tile, _empty_on(x.device),
                           geometry=geometry)
    S = plan.amax.shape[0]
    _check_segments(name, S)
    stream = _build.stream_ptr(x)
    plan.amax.zero_()
    _launch_amax(lib, x, plan, S, stream)
    wrapper.launches += 1
    ptrs, ints = _ptc_fused_args(plan, mrf, chains, ups)
    err = _fn(lib, f'{lib}_fused', _PTC_FUSED_ARGTYPES)(
        _build.ptr(x), x.stride(0), T_in, _build.ptr(plan.amax),
        _build.ptr(plan.out), plan.out.stride(0),
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p),
        plan.scale, mrf.post_dev[1] if plan.kpost else 0.0, C_in, C, S,
        sm_count(x.device), int(mrf.q8s), stream)
    _build.check(err, f'{name} (C_in={C_in}, C={C})')
    wrapper.launches += 1
    wrapper.calls[tuple(x.shape) + (mrf.mode,)] += 1
    return plan.out


def _dyn_blk_args(plan, launch, mrf, x):
    """The pointer and int arrays of ``<lib>_blk`` for one launch (their
    order is the C entry point's, mrf_dyn_blk.cuh)."""
    C_in = x.shape[2]
    C = C_in if mrf.ups is None else mrf.ups[0].shape[-1]
    st = Q8_STAGES[C_in, C]
    if mrf.ups is None:
        ptrs, ups_ints, wu_phase = [0] * 4, [1, 0, 0, 0] + [0] * 8, 0
        kpost = 0
    else:
        wu, swu, bu = mrf.blk_ups_dev
        kpost = 0 if mrf.post is None else mrf.post[0].shape[0]
        ptrs = [wu.data_ptr(), swu.data_ptr(), bu.data_ptr(),
                mrf.post_dev[0].data_ptr() if kpost else 0]
        _, _, _, stride, padding, k_u = mrf.ups
        ntaps, amin, rows, span, _ = ups_geometry(k_u, stride, padding)
        ups_ints = [mrf.ups[3], ntaps, amin, span] + list(rows) + [0] * (
            8 - len(rows))
        wu_phase = wu.numel() // mrf.ups[3]
    ptrs += [t.data_ptr() for ch in launch.chains for st in ch.weights
             for t in st]
    ints = ups_ints + [kpost, plan.P, plan.n_tiles, plan.tile_in, plan.N,
                       plan.x_lo, plan.x_hi, launch.hx, launch.G,
                       launch.spw, launch.n_waves, plan.S, launch.n_bar,
                       launch.mode, int(launch.has_acc), launch.block_m,
                       st.tps, st.kch, st.utps, st.ukch, wu_phase,
                       len(launch.chains)]
    for ch in launch.chains:
        wins = list(ch.wins) + [(0, 0)] * (8 - len(ch.wins))
        ints += [ch.k, len(ch.dils)] + list(ch.dils) + [0] * (
            4 - len(ch.dils))
        ints += [v for w in wins for v in w]
        ints += list(ch.rem) + [0] * (9 - len(ch.rem))
    return ((ctypes.c_int64 * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints))


def _launch_dyn_blk(wrapper, lib, x, mrf, tile, geometry=_phase_geometry,
                    p=1):
    """The launches of a :class:`DynBlkPlan` (``amax_kernel``, then
    ``dyn_blk_kernel`` per chain or per level; with upsample on
    ``geometry``'s tiles, without on the windows of ``p`` phases) through
    ``lib``'s entry points, counted on ``wrapper``."""
    name = wrapper.__name__
    B, T_in, C_in = x.shape
    slots = sm_count(x.device)
    plan = _dyn_blk_plan(x, mrf, tile, mrf.blk_dev, _empty_on(x.device),
                         slots, geometry=geometry, p=p)
    _check_segments(name, plan.S)
    C = C_in if mrf.ups is None else mrf.ups[0].shape[-1]
    stream = _build.stream_ptr(x)
    plan.sync.zero_()
    plan.amax0.zero_()
    if mrf.ups is None:
        win_in, halo_in = plan.x_hi - plan.x_lo, -plan.x_lo
    else:
        _, halo_in, _, _ = geometry(mrf, T_in // mrf.p_in, tile)
        halo_in *= mrf.p_in
        win_in = plan.tile_in + 2 * halo_in
    err = _fn(lib, f'{lib}_amax', _AMAX_ARGTYPES)(
        _build.ptr(x), x.stride(0), T_in, C_in, plan.n_tiles, plan.tile_in,
        halo_in, win_in, _build.ptr(plan.amax0), plan.S, stream)
    _build.check(err, f'{name} amax')
    wrapper.launches += 1
    # without R in shared memory each block keeps its residual window and
    # conv1's first pass (one MMA pass of rows) in a global scratch slice
    # of rows C + 8 floats wide; the kernel checks the size it is given
    cfg = DYN_BLK_CFG[C_in, C]
    per = 0 if cfg.r_smem else (max(ln.block_m + 2 * ln.hx
                                    for ln in plan.launches)
                                + cfg.rows_pass) * (C + 8)
    scratch = torch.empty(max(per * slots, 1), dtype=torch.float32,
                          device=x.device)
    fn = _fn(lib, f'{lib}_blk', _DYN_BLK_ARGTYPES)
    for ln in plan.launches:
        ptrs, ints = _dyn_blk_args(plan, ln, mrf, x)
        acc = plan.sum if plan.sum is not None else plan.out
        err = fn(_build.ptr(x), x.stride(0), T_in, _build.ptr(plan.amax0),
                 _build.ptr(ln.sync), _build.ptr(acc), acc.stride(0),
                 _build.ptr(plan.out), plan.out.stride(0),
                 ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(ints, ctypes.c_void_p), plan.scale,
                 mrf.post_dev[1] if mrf.post is not None else 0.0,
                 _build.ptr(scratch), scratch.numel(), C_in, C, slots,
                 stream)
        _build.check(err, f'{name} dynamic engine (C_in={C_in}, C={C})')
        wrapper.launches += 1
    return plan.out


def _launch_static(wrapper, lib, x, mrf):
    """The launch of a :class:`PtcFusedPlan` without upsample
    (:func:`_static_plan`) through ``lib``'s ``<lib>_fused``, counted on
    ``wrapper``."""
    B, T, C = x.shape
    plan = _static_plan(x, mrf, _empty_on(x.device))
    ptrs, ints = _ptc_fused_args(plan, mrf, mrf.blk_dev, None)
    err = _fn(lib, f'{lib}_fused', _PTC_FUSED_ARGTYPES)(
        _build.ptr(x), x.stride(0), T, None, _build.ptr(plan.out),
        plan.out.stride(0), ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(ints, ctypes.c_void_p), plan.scale, 0.0, C, C, B,
        sm_count(x.device), int(mrf.q8s), _build.stream_ptr(x))
    _build.check(err, f'{wrapper.__name__} (C={C}, {mrf.mode})')
    wrapper.launches += 1
    return plan.out


def fused_mrf_ct_q8f(x, mrf):
    """Fused MRF group of a level in ``fused_mrf_ct``'s int8-static form
    with the fused s32 boundary (``q8f``). x: (B, T, C) bfloat16
    sample-major, C in :data:`CT_Q8F_CHANNELS`; ``mrf`` from
    :func:`prepare_mrf_ct_q8f`. Returns (B, T, C) bfloat16. On a CUDA tensor
    this launches ``mrf_ct_q8.cu`` (or raises); on a CPU tensor it runs
    :func:`mrf_ct_q8f_plain`.

    ``fused_mrf_ct_q8f.launches`` counts CUDA launches (one a call:
    ``ptc_fused_q8_kernel`` without prologue); ``fused_mrf_ct_q8f.calls``
    counts CUDA-route calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_ct_q8f_plain(x, mrf)
    check_q8_input('fused_mrf_ct_q8f', x, mrf, CT_Q8F_CHANNELS, x.shape[2],
                   'q8f')
    x = aligned(x)
    out = _launch_static(fused_mrf_ct_q8f, 'mrf_ct_q8', x, mrf)
    fused_mrf_ct_q8f.calls[tuple(x.shape)] += 1
    return out


fused_mrf_ct_q8f.launches = 0
fused_mrf_ct_q8f.calls = collections.Counter()


def fused_mrf_ct_q8s(x, mrf):
    """Fused MRF group of a level in ``fused_mrf_ct``'s int8-static form
    with the float32 boundary (``q8s``: JAX's ``DAFT_INT8_FUSED_EPI=0``).
    x: (B, T, C) bfloat16 sample-major, C in :data:`CT_Q8F_CHANNELS`;
    ``mrf`` from :func:`prepare_mrf_ct_q8s`. Returns (B, T, C) bfloat16. On
    a CUDA tensor this launches ``mrf_ct_q8.cu`` (or raises); on a CPU
    tensor it runs :func:`mrf_ct_q8s_plain`.

    ``fused_mrf_ct_q8s.launches`` counts CUDA launches (one a call:
    ``ptc_fused_q8_kernel`` without prologue); ``fused_mrf_ct_q8s.calls``
    counts CUDA-route calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_ct_q8s_plain(x, mrf)
    check_q8_input('fused_mrf_ct_q8s', x, mrf, CT_Q8F_CHANNELS, x.shape[2],
                   'q8s')
    x = aligned(x)
    out = _launch_static(fused_mrf_ct_q8s, 'mrf_ct_q8', x, mrf)
    fused_mrf_ct_q8s.calls[tuple(x.shape)] += 1
    return out


fused_mrf_ct_q8s.launches = 0
fused_mrf_ct_q8s.calls = collections.Counter()


def fused_mrf_phase_q8_noups(x, mrf, p, tile):
    """Fused MRF group of a narrow level in ``fused_mrf_phase``'s int8 forms
    without the upsample prologue (``in_phase=False``): dynamic, ``q8f``
    (static, fused s32 boundary) or ``q8s`` (static, float32 boundary), as
    ``mrf.mode`` says. x: (B, T, C) bfloat16 sample-major, C in
    ``PHASE_CHANNELS``; ``mrf`` from :func:`prepare_mrf_ct_q8`, ``_q8f`` or
    ``_q8s`` (the phase packers' per-tap weights are the same); ``p``
    phases and ``tile``
    phase columns per tile (:func:`phase_tile`; they shape the dynamic
    form only). Returns (B, T, C) bfloat16. On a CUDA tensor this launches
    ``mrf_phase_q8.cu`` (or raises); on a CPU tensor it runs
    :func:`mrf_phase_q8_noups_plain`.

    ``fused_mrf_phase_q8_noups.launches`` counts CUDA launches (dynamic:
    the window amax and one launch of the segment-synchronised engine;
    static: one of ``ptc_fused_q8_kernel`` without prologue);
    ``fused_mrf_phase_q8_noups.calls`` counts CUDA-route calls by x's
    shape and mode: (B, T, C, ``mrf.mode``)."""
    if x.device.type == 'cpu':
        return mrf_phase_q8_noups_plain(x, mrf, p, tile)
    name = 'fused_mrf_phase_q8_noups'
    check_q8_input(name, x, mrf, PHASE_CHANNELS, x.shape[2])
    x = aligned(x)
    if mrf.dynamic:
        out = _launch_dyn_blk(fused_mrf_phase_q8_noups, 'mrf_phase_q8', x,
                              _without_ups(mrf), tile, p=p)
    else:
        out = _launch_static(fused_mrf_phase_q8_noups, 'mrf_phase_q8', x,
                             mrf)
    fused_mrf_phase_q8_noups.calls[tuple(x.shape) + (mrf.mode,)] += 1
    return out


fused_mrf_phase_q8_noups.launches = 0
fused_mrf_phase_q8_noups.calls = collections.Counter()

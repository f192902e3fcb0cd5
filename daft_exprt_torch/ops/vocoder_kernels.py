"""HiFi-GAN MRF kernels: the CUDA kernels ``csrc/mrf_tc.cu``,
``csrc/mrf_phase.cu`` and ``csrc/mrf_tc_q8.cu``, their plain PyTorch
versions and their wrappers, and the int8 helpers, packers and weight
forms that ``ops/mrf_int8.py`` shares.

An MRF group is one upsample level's ResBlock1 chains averaged:
``mean_j chain_j(x)`` with ``chain(x): x += conv_k(lrelu(conv_{k,d}(lrelu(x))))``
for d in the chain's dilations. The fused TPU kernels evaluate it with
*valid* convs on a zero-padded (or, after a fused upsample, extended)
input, so the result at every sample is a fixed function of the input:
the same function the port's kernels and plain versions compute.

- :func:`fused_mrf_tc` replaces ``vocoder_kernels.py::fused_mrf_tc``
  (float mode), for the wide levels in (B, T, C) layout.
- :func:`fused_mrf_phase` replaces ``vocoder_kernels.py::fused_mrf_phase``
  (float mode, fused upsample prologue, optional conv_post epilogue), for
  the narrow levels, in the standard (B, C, T) layout.
- :func:`fused_mrf_ptc_f` replaces ``fused_mrf_ptc`` in its ``fdot`` mode
  (the bf16 tier's phase-tc form, opt-in): the bf16 phase kernel's
  function with its upsample output kept in float32.
- :func:`fused_resblock1` replaces ``fused_resblock1``: one ResBlock1
  chain, the tc kernels' group of one chain.
- The levels that take no fused upsample (``ops/mrf_ct.py``:
  ``fused_mrf_ct`` and ``fused_mrf_phase`` without prologue, HiFi-GAN
  V2's levels) run one launch a level of ``csrc/mrf_ct.cu``, planned here
  (:data:`CT_BF_CFG`, :func:`_ct_plan`) beside the other engines' plans.
- :func:`fused_mrf_tc_q8` replaces ``fused_mrf_tc`` with ``q8=True``: the
  int8-static serving tier, with the quantisation helpers and the int8
  packers (second half of the file; ``fused_mrf_ptc`` itself lives in
  ``ops/mrf_int8.py``).

The float wrappers take one level's weights as :class:`MrfWeights`, made
once by :func:`prepare_mrf` (the plain layout and the kernels' layout side
by side); the int8 ones :class:`MrfQ8Weights` from
:func:`prepare_mrf_tc_q8` / :func:`prepare_mrf_ptc`. In bf16,
:func:`fused_mrf_tc` and :func:`fused_mrf_phase` run on the block-resident
bf16 engine (``mrf_chain_bf16.cuh``: one launch per chain, or per level
with the upsample and conv_post; weights packed by
:func:`pack_stage_bf16`), :func:`fused_mrf_tc_q8` on the int8 one
(``mrf_chain_q8.cuh``, :func:`pack_stage_s8`), and :func:`fused_mrf_tc`
and :func:`fused_mrf_phase` in float32 and :func:`fused_resblock1` in
both dtypes on the chain kernels (``mrf_chain_f32.cuh`` in float32:
3xTF32 on the tensor cores, weights split by :func:`pack_stage_tf32`):
each block keeps a chain's residual window on chip. :func:`fused_mrf_ptc_f`
runs the bf16 engine's phase kernel with its upsample output in float32.
The sample ranges of every launch and block are planned here
(:func:`_tc_bf_plan`, :func:`_tc_f32_plan`,
:func:`_phase_bf_plan`, :func:`_phase_f32_plan`, :func:`_ct_plan`,
:func:`_tc_q8_plan`) so the CPU tests can replay the plan.
"""
import collections
import contextlib
import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import _build

LRELU_SLOPE = 0.1
TC_CHANNELS = (128, 256)
PHASE_CHANNELS = (32, 64)
CT_CHANNELS = (8, 16, 32, 64)          # the levels without fused upsample
KERNEL_SIZES = (3, 7, 11)

WRITE, ADD, FINAL = 0, 1, 2           # chain output modes (mrf_common.cuh StepMode)


def _lrelu(x):
    return torch.where(x >= 0, x, LRELU_SLOPE * x)


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and matmuls in full float32 on the card: cuDNN
    defaults to TF32 for float32 convolutions on Hopper, which keeps ~3
    decimal digits and breaks the 1e-5 vocoder band."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def chain_halo(kernel_size, dilations):
    """Per-side receptive field of one ResBlock1 chain, in samples."""
    half = (kernel_size - 1) // 2
    return sum(d * half + half for d in dilations)


def pack_mrf_tc_weights(params, level, kernel_sizes, dilations):
    """One level's resblock weights, per block [w1, b1, w2, b2]: w as
    (n_dil, k, C_in, C_out) (torch (out, in, k) transposed) and b as
    (n_dil, C). Port of ``pack_mrf_tc_weights``; both MRF wrappers take it."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        for prefix in ('convs1', 'convs2'):
            out.append(torch.stack([rb[f'{prefix}_{i}']['w'].permute(2, 1, 0)
                                    for i in range(len(dils))]))
            out.append(torch.stack([rb[f'{prefix}_{i}']['b']
                                    for i in range(len(dils))]))
    return out


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def _conv_kio(x, w_kio, dilation=1):
    """Valid conv of float32 (B, C_in, L) with a (k, C_in, C_out) kernel."""
    return F.conv1d(x, w_kio.permute(2, 1, 0).float(), dilation=dilation)


def _chain_plain(cur, w1, b1, w2, b2, k, dils, cdt):
    """One ResBlock1 chain by valid convs on float32 (B, C, L); returns
    (B, C, L - 2*chain_halo)."""
    half = (k - 1) // 2
    for i, d in enumerate(dils):
        t = _lrelu(cur).to(cdt).float()
        a = _conv_kio(t, w1[i], d) + b1[i].float()[:, None]
        t2 = _lrelu(a).to(cdt).float()
        a2 = _conv_kio(t2, w2[i]) + b2[i].float()[:, None]
        sh = d * half + half
        cur = cur[:, :, sh:cur.shape[2] - sh] + a2
    return cur


def mrf_tc_plain(x, weights, kernel_sizes, dilations):
    """The plain version of :func:`fused_mrf_tc`. x: (B, T, C)."""
    cdt = x.dtype
    xc = x.transpose(1, 2).float()
    acc = None
    with full_f32():
        for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
            w1, b1, w2, b2 = weights[4 * j:4 * j + 4]
            h = chain_halo(k, dils)
            y = _chain_plain(F.pad(xc, (h, h)), w1, b1, w2, b2, k, dils, cdt)
            acc = y if acc is None else acc + y
    out = acc * (1.0 / len(kernel_sizes))
    return out.to(cdt).transpose(1, 2).contiguous()


def _ups_extended(x, w, b, stride, padding, ext, cdt, round_out=True):
    """lrelu(x) zero-extended (its input rounded to ``cdt``) ->
    ConvTranspose1d, evaluated at samples [-ext, stride*T + ext) (bias
    beyond the transposed conv's support), rounded to ``cdt`` when
    ``round_out``; returned as float32 (B, C_out, N + 2*ext)."""
    B, _, T_in = x.shape
    N = stride * T_in
    xin = _lrelu(x.float()).to(cdt).float()
    y = F.conv_transpose1d(xin, w.float(), stride=stride)
    lo = ext - padding                      # y[:, :, i] is sample i - padding
    if lo < 0 or lo + y.shape[2] > N + 2 * ext:
        raise ValueError('upsample extension smaller than its padding')
    x0 = y.new_zeros(B, w.shape[1], N + 2 * ext)
    x0[:, :, lo:lo + y.shape[2]] = y
    x0 = x0 + b.float()[:, None]
    return x0.to(cdt).float() if round_out else x0


def _phase_ext(kernel_sizes, dilations, post_k):
    return (max(chain_halo(k, d) for k, d in zip(kernel_sizes, dilations))
            + (post_k - 1) // 2)


def mrf_phase_plain(x, weights, kernel_sizes, dilations, ups, post=None,
                    fdot=False):
    """The plain version of :func:`fused_mrf_phase`. ``fdot``: that of
    ``fused_mrf_ptc``'s fdot mode (:func:`mrf_ptc_f_plain`): the conv
    inputs in the weights' dtype and the upsample output kept in float32.
    The output and conv_post's input are in x's dtype either way."""
    cdt = weights[0].dtype if fdot else x.dtype
    w_u, b_u, stride, padding = ups
    post_k = post[0].shape[-1] if post is not None else 1
    P = (post_k - 1) // 2
    E = _phase_ext(kernel_sizes, dilations, post_k)
    N = stride * x.shape[2]
    acc = None
    with full_f32():
        x0 = _ups_extended(x, w_u, b_u, stride, padding, E, cdt,
                           round_out=not fdot)
        for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
            w1, b1, w2, b2 = weights[4 * j:4 * j + 4]
            h = chain_halo(k, dils)
            win = x0[:, :, E - h - P:E + N + h + P]
            y = _chain_plain(win, w1, b1, w2, b2, k, dils, cdt)
            acc = y if acc is None else acc + y
        mean = acc * (1.0 / len(kernel_sizes))       # samples [-P, N + P)
        if post is None:
            return mean.to(x.dtype)
        t = _lrelu(mean).to(x.dtype).float()
        y = F.conv1d(t, post[0].to(x.dtype).float()) + \
            post[1].float()[:, None]
    return torch.tanh(y).to(x.dtype)


def ups_geometry(kernel_size, stride, padding):
    """Polyphase form of a ConvTranspose1d with k - 2p == s. Output sample
    s*m + r is the bias plus, for t < ntaps = k/s, kernel tap taps[r][t]
    applied to input sample m + amin + rows[r] + t; a block of M positions
    m reads M + span input rows starting at its first m + amin. Returns
    (ntaps, amin, rows, span, taps)."""
    if kernel_size - 2 * padding != stride or kernel_size % stride:
        raise ValueError('fused upsample needs k - 2*padding == stride and '
                         f'k % stride == 0 (k={kernel_size}, s={stride}, '
                         f'p={padding})')
    nt = kernel_size // stride
    deltas = [(r + padding) // stride for r in range(stride)]
    j0 = [(r + padding) % stride for r in range(stride)]
    amin = min(deltas) - (nt - 1)
    rows = [deltas[r] - (nt - 1) - amin for r in range(stride)]
    span = max(deltas) - amin
    taps = [[j0[r] + (nt - 1 - t) * stride for t in range(nt)]
            for r in range(stride)]
    return nt, amin, rows, span, taps


# ----------------------------------------------------------------------
# device weights
# ----------------------------------------------------------------------

@dataclass
class MrfWeights:
    """One level's weights for the MRF wrappers, made once by
    :func:`prepare_mrf`. The plain versions read ``packed`` (from
    :func:`pack_mrf_tc_weights`), ``ups`` and ``post``. For weights on a
    CUDA device the CUDA routes read the same weights in the kernels'
    format for ``dtype`` (None on the CPU): ``blk[j][i]`` = (w1, b1, w2,
    b2) of chain j, dilation i, staged for the engine of the level's width,
    ``blk_ups`` the staged upsample, and ``post_dev`` = ((k, C) float32
    taps, bias)."""
    dtype: torch.dtype
    device: torch.device
    kernel_sizes: tuple
    dilations: tuple
    packed: list
    ups: Optional[tuple] = None       # (w (C_in, C, k), b (C,), stride, pad)
    post: Optional[tuple] = None      # (w (1, C, k), b (1,))
    post_dev: Optional[tuple] = None
    p: int = 0                        # phases (fused_mrf_ptc_f's weights)
    blk: Optional[list] = None        # the engines' staged chains
    blk_ups: Optional[tuple] = None   # the staged upsample


def prepare_mrf(packed, kernel_sizes, dilations, ups=None, post=None):
    """:class:`MrfWeights` of one level, in the dtype and on the device of
    ``packed``. ``ups`` = (w, b, stride, padding) of the level's
    ConvTranspose1d and ``post`` = (w, b) of conv_post, for
    :func:`fused_mrf_phase`.

    Off the CPU, the chains of a level whose width an engine serves are
    staged for it (``blk``: per chain and step (w1, b1, w2, b2)): in bf16
    the taps by :func:`pack_stage_bf16` with the stages of
    :data:`TC_BF_CFG` (the wide levels) or :data:`CT_BF_CFG` (the levels of
    :data:`CT_CHANNELS`; :func:`pack_stage_bf16_pairs` at C = 8), in
    float32 by :func:`pack_stage_tf32` with :data:`TC_F32_CFG`'s. The
    stages depend on the width only, so a chain level's weights also serve
    its fallback to ``fused_mrf_ct``. With an upsample the phase kernel
    serves (:data:`PHASE_BF_CFG`, :data:`PHASE_F32_UKCH`), ``blk_ups`` holds
    it staged per phase, with its bias and the bytes of a phase."""
    cdt, device = packed[0].dtype, packed[0].device
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    mrf = MrfWeights(cdt, device, kernel_sizes, dilations, list(packed),
                     ups=ups, post=post)
    if device.type == 'cpu':
        return mrf
    C = packed[0].shape[-1]
    stage = _chain_stage(cdt, C)
    if stage is not None:
        mrf.blk = []
        for j, dils in enumerate(dilations):
            w1, b1, w2, b2 = packed[4 * j:4 * j + 4]
            mrf.blk.append([(stage(w1[i]), b1[i].float().contiguous(),
                             stage(w2[i]), b2[i].float().contiguous())
                            for i in range(len(dils))])
    if ups is not None and stage is not None:
        w, b, stride, padding = ups
        _, _, _, _, taps = ups_geometry(w.shape[-1], stride, padding)
        phases = [torch.stack([w[:, :, j] for j in tp]) for tp in taps]
        if cdt == torch.bfloat16 and (w.shape[0], C) in PHASE_BF_CFG:
            cfg = PHASE_BF_CFG[w.shape[0], C]
            staged = [pack_stage_bf16(t, cfg.utps, cfg.ukch) for t in phases]
            mrf.blk_ups = (torch.cat(staged), b.float().contiguous(),
                           2 * staged[0].numel())
        elif cdt == torch.float32 and (w.shape[0], C) in PHASE_F32_UKCH:
            ukch = PHASE_F32_UKCH[w.shape[0], C]
            staged = [pack_stage_tf32(t, ukch) for t in phases]
            mrf.blk_ups = (torch.cat(staged), b.float().contiguous(),
                           4 * staged[0].numel())
    if post is not None:
        w, b = post
        mrf.post_dev = (w.to(cdt).float()[0].transpose(0, 1).contiguous(),
                        float(b.float()[0]))
    return mrf


def _chain_stage(cdt, C):
    """The engines' staging of a chain conv's (taps, C, C) weights at width
    C in ``cdt`` (one form per width: the tc, phase and ct kernels of a
    width read the same stages), or None where no engine serves C."""
    if cdt == torch.bfloat16:
        cfg = TC_BF_CFG.get(C) or CT_BF_CFG.get(C)
        if cfg is None:
            return None
        if C == 8:
            return lambda w: pack_stage_bf16_pairs(w, cfg.tps)
        return lambda w: pack_stage_bf16(w, cfg.tps, cfg.kch)
    cfg = TC_F32_CFG.get(C) if cdt == torch.float32 else None
    return None if cfg is None else (lambda w: pack_stage_tf32(w, cfg.kch))


# ----------------------------------------------------------------------
# CUDA launches
# ----------------------------------------------------------------------

_I64, _I32, _F32, _P = ctypes.c_int64, ctypes.c_int, ctypes.c_float, \
    ctypes.c_void_p


def _fn(lib, name, argtypes):
    f = getattr(_build.library(lib), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _check_cuda_input(x, name, channels, c):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'{name}: dtype {x.dtype} not supported '
                         '(bfloat16 or float32)')
    if c not in channels:
        raise ValueError(f'{name}: C={c} has no CUDA instantiation '
                         f'(built for {channels})')


def _check_kernel_sizes(name, kernel_sizes):
    bad = [k for k in kernel_sizes if k not in KERNEL_SIZES]
    if bad:
        raise ValueError(f'{name}: kernel sizes {bad} have no CUDA '
                         f'instantiation (built for {KERNEL_SIZES})')


def _check_weights(name, x, mrf):
    if x.dtype != mrf.dtype or x.device != mrf.device:
        raise ValueError(f'{name}: x is {x.dtype} on {x.device} but the '
                         f'weights were prepared as {mrf.dtype} on '
                         f'{mrf.device}')


def fused_mrf_tc(x, mrf):
    """Fused MRF group of a wide level. x: (B, T, C) in bfloat16 or float32;
    ``mrf`` from :func:`prepare_mrf` in x's dtype. Returns (B, T, C) in x's
    dtype. On a CUDA tensor this launches ``mrf_tc.cu`` (or raises), one
    launch per chain: the block-resident bf16 engine (``tc_bf_kernel``) in
    bf16, its float32 counterpart on the tensor cores in 3xTF32
    (``tc_f32_kernel``) in float32. On a CPU tensor it runs
    :func:`mrf_tc_plain`.

    ``fused_mrf_tc.launches`` counts CUDA launches;
    ``fused_mrf_tc.calls`` counts CUDA-route calls by x's shape (and
    'float32' for a float32 call)."""
    if x.device.type == 'cpu':
        return mrf_tc_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations)
    C = x.shape[2]
    _check_cuda_input(x, 'fused_mrf_tc', TC_CHANNELS, C)
    _check_kernel_sizes('fused_mrf_tc', mrf.kernel_sizes)
    _check_weights('fused_mrf_tc', x, mrf)
    out = _launch_tc_chains(fused_mrf_tc, x, mrf)
    fused_mrf_tc.calls[tuple(x.shape) + (
        ('float32',) if x.dtype == torch.float32 else ())] += 1
    return out


fused_mrf_tc.launches = 0
fused_mrf_tc.calls = collections.Counter()


def _empty_on(device):
    return lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device)


def fused_mrf_phase(x, mrf):
    """Upsample + fused MRF group (+ conv_post) of a narrow level.

    x: (B, C_in, T_in), the level's PRE-upsample activation in the compute
    dtype (bfloat16 or float32; any strides, e.g. a transposed (B, T, C)
    tensor). ``mrf`` from :func:`prepare_mrf` in x's dtype, with ``ups``
    (the level's ConvTranspose1d) and, at the last level, ``post``
    (conv_post). Returns the level output (B, C, stride*T_in), or with
    ``post`` the waveform (B, 1, stride*T_in) after tanh, in x's dtype. On
    a CUDA tensor this launches ``mrf_phase.cu`` (or raises); on a CPU
    tensor it runs :func:`mrf_phase_plain`.

    The CUDA route is one launch a call: the block-resident
    ``phase_bf_kernel`` in bf16, its float32 counterpart on the tensor
    cores in 3xTF32 (``phase_f32_kernel``) in float32.
    ``fused_mrf_phase.launches`` counts CUDA launches;
    ``fused_mrf_phase.calls`` counts CUDA-route calls by x's shape (and
    'float32' for a float32 call)."""
    if mrf.ups is None:
        raise ValueError('fused_mrf_phase: the weights carry no upsample')
    if x.device.type == 'cpu':
        return mrf_phase_plain(x, mrf.packed, mrf.kernel_sizes,
                               mrf.dilations, mrf.ups, mrf.post)
    out = _launch_phase_engine(fused_mrf_phase, x, mrf)
    fused_mrf_phase.calls[tuple(x.shape) + (
        ('float32',) if x.dtype == torch.float32 else ())] += 1
    return out


fused_mrf_phase.launches = 0
fused_mrf_phase.calls = collections.Counter()


# ----------------------------------------------------------------------
# the bf16 block-resident engine (csrc/mrf_chain_bf16.cuh)
# ----------------------------------------------------------------------
#
# A block owns block_m output samples of one utterance and runs a chain's
# steps on its window, block_m + 2*halo rows, on chip. The launch plans
# below fix every block's window (the CPU tests replay them); block_m is
# the largest whose window fits the shared memory the kernel's layout needs
# (mirrored here from the .cuh).

SMEM_MAX = 232448             # dynamic shared memory of one H100 block


@dataclass(frozen=True)
class BfCfg:
    """A bf16 engine kernel's geometry (``mrf_chain_bf16.cuh`` TcBfCfg /
    PhaseBfCfg, ``mrf_ct.cuh`` CtBfCfg: warps, taps and input channels per
    weight stage of the chain convs and of the upsample, ring slots, and
    where its float32 windows live: ``r_smem``, shared memory, else a
    per-block slice of a global scratch, which stays in L2; ``mg``: 64-row
    groups a warpgroup takes per pass). The kernel checks the stages and
    ``r_smem``."""
    nw: int
    tps: int
    kch: int
    nbuf: int
    r_smem: bool
    utps: int = 0
    ukch: int = 0
    mg: int = 1


TC_BF_CFG = {128: BfCfg(16, 1, 64, 3, True), 256: BfCfg(16, 1, 32, 4, False)}
PHASE_BF_CFG = {(128, 64): BfCfg(16, 2, 64, 3, True, 2, 64),
                (64, 32): BfCfg(16, 3, 32, 3, True, 2, 64)}
# the bf16 level kernel of the levels without upsample (``CtBfCfg``; its
# float32 windows always in shared memory): at C = 64 and 32 the phase
# kernel's chain stages (a chain level's weights serve its ct fallback); at
# C = 8 ``tps`` counts tap pairs and ``kch`` is a pair's 16 values
# (pack_stage_bf16_pairs)
CT_BF_CFG = {64: BfCfg(16, 2, 64, 3, True, mg=2),
             32: BfCfg(16, 3, 32, 4, True, mg=2),
             16: BfCfg(16, 3, 16, 6, True, mg=4),
             8: BfCfg(16, 2, 16, 6, True, mg=4)}


def stage_taps(taps, tps):
    """The taps of each stage group of the bf16 engine: groups of ``tps``
    from tap 0; the last group, when ``tps`` does not divide ``taps``, is
    the last ``tps`` taps (its taps an earlier group holds get zero
    weights), so every group issues the same MMAs and reads only rows of
    the conv's window. Returns [(first tap, taps it adds)] per group."""
    if taps < tps:
        raise ValueError(f'{taps} taps in groups of {tps}')
    G = -(-taps // tps)
    return [(min(g * tps, taps - tps), min(tps, taps - g * tps))
            for g in range(G)]


_STAGE_ORDER = {}


def _stage_order(kind, shape, tps, kch, device):
    """The source index of every word of a staged weight tensor (the packer's
    permutation of the weights, computed once per shape and device on an
    index tensor, so that staging a weight is one gather); bf16: an index
    of taps*C_in*C_out reads a zero, tf32: the source is (hi, lo)."""
    key = (kind, shape, tps, kch, device)
    idx = _STAGE_ORDER.get(key)
    if idx is None:
        taps, ci, co = shape
        n = taps * ci * co
        if kind == 'bf16':
            idx = _order_bf16(torch.arange(n).reshape(shape), n, tps, kch)
        else:
            idx = torch.arange(2 * n).reshape(
                2, taps, ci // kch, kch // 8, 2, 4, co // 8, 8)
            # [hl][tap][kc][ks][h][t][n8][g] -> [tap][kc][ks][n8][g][t][hl][h]
            idx = idx.permute(1, 2, 3, 6, 7, 5, 0, 4).reshape(-1)
        idx = _STAGE_ORDER[key] = idx.to(device)
    return idx


def _order_bf16(src, zero, tps, kch):
    """:func:`pack_stage_bf16`'s order of the (taps, C_in, C_out) entries of
    ``src``; ``zero`` where a group repeats a tap an earlier group holds."""
    taps, ci, co = src.shape
    if taps % tps:
        groups = []
        for t0, n in stage_taps(taps, tps):
            g = src[t0:t0 + tps].clone()
            g[:tps - n] = zero          # taps an earlier group holds
            groups.append(g)
        w = torch.stack(groups)         # [g][tp][ci][co]
    else:                               # the groups tile the taps
        w = src.reshape(taps // tps, tps, ci, co)
    # [g][kc][tp][n][k]
    w = w.reshape(w.shape[0], tps, ci // kch, kch, co).permute(0, 2, 1, 4, 3)
    key = swizzle_key(co, 2 * kch)
    pos = torch.arange(kch)
    s = (((pos[None, :] >> 3) ^ key[:, None]) << 3) | (pos[None, :] & 7)
    return torch.gather(w, 4, s.expand(w.shape).contiguous()).reshape(-1)


def pack_stage_bf16(w_kio, tps, kch):
    """(taps, C_in, C_out) -> bfloat16 in the staged order the bf16 engine
    copies into shared memory (``mrf_chain_bf16.cuh``): stage s =
    g*(C_in/kch) + kc holds group g's taps (:func:`stage_taps`) x input
    channels [kc*kch, (kc+1)*kch), as [tap][output channel n][kch], the
    16-byte chunks (8 values) of row n swizzled by :func:`swizzle_key` for
    rows of 2*kch bytes."""
    taps = w_kio.shape[0]
    w = w_kio.to(torch.bfloat16).reshape(-1).view(torch.int16)
    if taps % tps:
        w = torch.cat([w, w.new_zeros(1)])
    idx = _stage_order('bf16', tuple(w_kio.shape), tps, kch, w.device)
    return w[idx].view(torch.bfloat16)


def pack_stage_bf16_pairs(w_kio, tps):
    """(taps, 8, C_out) -> the bf16 engine's staged order at C = 8, where a
    k16 step reads a pair of taps (``ConvSS::PAIR``): pair v holds taps t =
    min(2v, taps - 2) and t + 1 as one tap of 16 input channels (tap t's 8,
    then tap t + 1's; an odd count's last pair repeats tap t with zero
    weights), staged by :func:`pack_stage_bf16` in groups of ``tps``
    pairs with 16 channels a stage."""
    taps = w_kio.shape[0]
    if taps < 2:
        raise ValueError(f'{taps} taps: a tap pair needs two')
    pairs = []
    for v in range((taps + 1) // 2):
        t = min(2 * v, taps - 2)
        first = w_kio[t] if t == 2 * v else torch.zeros_like(w_kio[t])
        pairs.append(torch.cat([first, w_kio[t + 1]]))
    return pack_stage_bf16(torch.stack(pairs), tps, 16)


def _pass_rows(C, nw, mg=1):
    """Output rows of one pass of a conv (``ConvSS::ROWS``): the warpgroups
    over C's column groups of 128, ``mg`` groups of 64 rows each."""
    return (nw // 4) // (C // min(C, 128)) * 64 * mg


def _conv_passes(M, rows):
    return -(-M // rows)


def _chain_convs(k, dils, wrows):
    """The output rows of a chain's convs on a window of ``wrows`` rows, in
    order (conv1, conv2 of each step)."""
    half = (k - 1) // 2
    rows, cur = [], wrows
    for d in dils:
        rows += [cur - 2 * d * half, cur - 2 * d * half - 2 * half]
        cur = rows[-1]
    return rows


def _round64(m):
    return -(-m // 64) * 64


def tile_rows(k, dils, wrows, g=64):
    """Rows a chain's conv tile holds on a window of ``wrows`` rows
    (``mrf_chain_bf16.cuh`` tile_rows): a warpgroup's MMAs read g = 64*mg
    rows from its first, so a conv over M rows reads rows up to M rounded
    up to g, - 1 + (k - 1)*d."""
    half = (k - 1) // 2
    rt, cur = wrows, wrows
    for d in dils:
        m1 = cur - 2 * d * half
        m2 = m1 - 2 * half
        rt = max(rt, -(-m1 // g) * g + 2 * d * half, -(-m2 // g) * g + 2 * half)
        cur = m2
    return rt


def _tc_bf_smem(C, cfg, k, dils, bm):
    """Shared memory of a ``tc_bf_kernel`` block (``TcBfLayout``)."""
    wrows = bm + 2 * chain_halo(k, dils)
    rows = _pass_rows(C, cfg.nw)
    n_sched = sum(_conv_passes(M, rows) for M in _chain_convs(k, dils, wrows))
    return (cfg.nbuf * cfg.tps * C * 2 * cfg.kch
            + tile_rows(k, dils, wrows) * 2 * C
            + (wrows * (C + 8) * 4 if cfg.r_smem else 0) + 16 * n_sched)


def _largest_block(n_per_utt, step, fits):
    """The largest block_m (a multiple of ``step``, at most the utterance
    rounded up) whose window fits the shared memory: the larger the block,
    the less halo it recomputes and the fewer times the weights stream.
    (On the card a cost model of waves, 64-row granules and weight passes
    picked no faster blocks, within the run-to-run spread: PERF.md, PR
    10.)"""
    best = None
    for bm in range(step, -(-n_per_utt // step) * step + 1, step):
        if not fits(bm):
            break
        best = bm
    if best is None:
        raise ValueError('no block size fits the shared memory')
    return best


def tc_bf_block(C, k, dils, T):
    """``tc_bf_kernel``'s block_m for one chain of a (B, T, C) group."""
    cfg = TC_BF_CFG[C]
    return _largest_block(
        T, 8, lambda bm: _tc_bf_smem(C, cfg, k, dils, bm) <= SMEM_MAX)


@dataclass
class TcBfLaunch:
    """One launch of ``tc_bf_kernel`` (bf16) or ``tc_f32_kernel``
    (float32): chain ``weights`` (per step: staged w1, b1, staged w2, b2)
    of an MRF group over blocks of ``block_m`` output samples. Block i of
    utterance b reads x samples [i*block_m - halo, (i+1)*block_m + halo)
    (zero outside [0, T)), runs the chain's steps with valid convs on that
    window and, for samples n in [i*block_m, min((i+1)*block_m, T)), writes
    the chain into ``sum`` (a (B, T, C) float32 buffer of its own; WRITE)
    or (FINAL) writes ((the earlier chains' buffers ``sum[:n_acc]`` summed
    in order) + chain) * scale into ``out``. ``r_smem``: the float32 window
    in shared memory, else a scratch slice of (block_m + 2*halo) rows per
    resident block (C + 8 floats a row in bf16, C in float32)."""
    x: torch.Tensor
    sum: Optional[torch.Tensor]
    out: torch.Tensor
    mode: int
    n_acc: int
    scale: float
    weights: list
    k: int
    dils: tuple
    halo: int
    block_m: int
    n_blocks: int
    r_smem: bool


def _group_plan(x, chains, kernel_sizes, dilations, alloc, slots, block,
                r_smem, row_floats):
    """One chain-kernel launch per chain of an MRF group: the first chains
    WRITE their own float32 buffer, the last (FINAL) reads them and writes
    the mean. ``block(k, dils)``: a chain's block_m; ``row_floats``: a
    scratch row's floats. Returns (launches, out, scratch floats)."""
    B, T, C = x.shape
    nb = len(kernel_sizes)
    sums = alloc((nb - 1, B, T, C), torch.float32) if nb > 1 else None
    out = alloc((B, T, C), x.dtype)
    launches, scratch = [], 0
    for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        final = j == nb - 1
        bm = block(k, tuple(dils))
        h = chain_halo(k, dils)
        n_blocks = -(-T // bm)
        launches.append(TcBfLaunch(
            x, sums if final else sums[j], out, FINAL if final else WRITE,
            j if final else 0, 1.0 / nb, chains[j], k, tuple(dils), h, bm,
            n_blocks, r_smem))
        if not r_smem:
            scratch = max(scratch, (bm + 2 * h) * row_floats
                          * min(B * n_blocks, slots))
    return launches, out, scratch


def _tc_bf_plan(x, chains, kernel_sizes, dilations, alloc, slots):
    """Launch plan of the bf16 :func:`fused_mrf_tc`: (launches, out), one
    launch per chain, and the scratch floats the launches need (0 when
    every window is in shared memory); ``slots``: resident blocks (SMs)."""
    B, T, C = x.shape
    cfg = TC_BF_CFG[C]
    return _group_plan(x, chains, kernel_sizes, dilations, alloc, slots,
                       lambda k, d: tc_bf_block(C, k, d, T), cfg.r_smem,
                       C + 8)


_TC_BF_ARGTYPES = ([_P, _I64, _I32, _P, _I64, _I64, _P, _I64, _I32, _I32,
                    _F32, _P, _P] + [_I32] * 8 + [_P, _I64, _I32, _P])
_TC_F32_ARGTYPES = ([_P, _I64, _I32, _P, _I64, _I64, _P, _I64, _I32, _I32,
                     _F32, _P, _P] + [_I32] * 6 + [_P, _I64, _I32, _P])


def _scratch(n, device):
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def _launch_tc_chains(wrapper, x, mrf):
    """The chain-kernel launches of a :func:`fused_mrf_tc` (or
    :func:`fused_resblock1`) call: ``tc_bf_kernel`` in bf16,
    ``tc_f32_kernel`` in float32, counted on ``wrapper``."""
    B, T, C = x.shape
    f32 = x.dtype == torch.float32
    if mrf.blk is None:
        raise ValueError(
            f'{wrapper.__name__}: the weights carry no '
            f'{"float32" if f32 else "bf16"} engine form '
            '(prepare_mrf on the card)')
    x = aligned(x)
    slots = sm_count(x.device)
    plan = _tc_f32_plan if f32 else _tc_bf_plan
    launches, out, n_scratch = plan(x, mrf.blk, mrf.kernel_sizes,
                                    mrf.dilations, _empty_on(x.device), slots)
    scratch = _scratch(n_scratch, x.device)
    if f32:
        fn = _fn('mrf_tc', 'mrf_tc_f32_chain', _TC_F32_ARGTYPES)
        cfg_args = (TC_F32_CFG[C].kch,)
    else:
        fn = _fn('mrf_tc', 'mrf_tc_bf_chain', _TC_BF_ARGTYPES)
        cfg = TC_BF_CFG[C]
        cfg_args = (int(cfg.r_smem), cfg.tps, cfg.kch)
    stream = _build.stream_ptr(x)
    for st in launches:
        wp = (ctypes.c_int64 * (4 * len(st.dils)))(
            *(t.data_ptr() for w in st.weights for t in w))
        dl = (ctypes.c_int * len(st.dils))(*st.dils)
        acc = st.sum if st.sum is not None else st.out
        b_dim = 1 if st.mode == FINAL else 0
        err = fn(_build.ptr(x), x.stride(0), T, _build.ptr(acc),
                 acc.stride(b_dim), acc.stride(0) if b_dim else 0,
                 _build.ptr(st.out), st.out.stride(0), st.mode, st.n_acc,
                 st.scale, ctypes.cast(wp, ctypes.c_void_p),
                 ctypes.cast(dl, ctypes.c_void_p), len(st.dils), st.k, C, B,
                 st.block_m, *cfg_args, _build.ptr(scratch), scratch.numel(),
                 slots, stream)
        _build.check(err, f'MRF {"float32" if f32 else "bf16"} chain (C={C}, '
                     f'k={st.k}, block_m={st.block_m})')
        wrapper.launches += 1
    return out


# ----------------------------------------------------------------------
# the float32 chain kernel (mrf_chain_f32.cuh): 3xTF32 on the tensor cores
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class F32Cfg:
    """The float32 chain kernels' geometry per width C (``mrf_chain_f32.cuh``
    TcF32Cfg): warps, a warp's tile of 16*mt rows x 8*nt columns, input
    channels per weight stage (one tap a stage), ring slots. The kernels
    check ``kch``."""
    nw: int
    mt: int
    nt: int
    kch: int
    nbuf: int


# the wide levels' tc_f32_kernel, the narrow levels' phase_f32_kernel chains
TC_F32_CFG = {128: F32Cfg(8, 2, 8, 32, 2), 256: F32Cfg(8, 4, 8, 8, 2),
              64: F32Cfg(8, 2, 8, 32, 2), 32: F32Cfg(8, 2, 4, 32, 2),
              16: F32Cfg(8, 8, 2, 16, 4), 8: F32Cfg(8, 8, 1, 8, 4)}
# the float32 level kernel (``CtF32Cfg``): whether the float32 windows (the
# residual and the chain sum) live in shared memory, else in a per-block
# scratch slice
CT_F32_R_SMEM = {64: False, 32: False, 16: True, 8: True}
# phase_f32_kernel's upsample (C_in -> C): input channels per weight stage
# (``PhaseF32Cfg``; its warps and tiles are the chains')
PHASE_F32_UKCH = {(128, 64): 32, (64, 32): 32}


def tf32(x):
    """cvt.rna.tf32.f32 (``tf32x3.cuh`` to_tf32): the nearest value with 10
    mantissa bits, ties away from zero (the low 13 bits of the pattern
    cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_stage_tf32(w_kio, kch):
    """(taps, C_in, C_out) float32 -> the staged float32 words the float32
    chain kernel copies into shared memory (``mrf_chain_f32.cuh``): stage s
    = tap*(C_in/kch) + kc holds input channels [kc*kch, (kc+1)*kch) of one
    tap, as [k8 step][n-tile of 8 output channels][lane = 4g + t][hi0, hi1,
    lo0, lo1], the mma.sync m16n8k8 B fragment (b0: input channel t, b1: t +
    4, output channel g of the n-tile) split once into TF32 halves, hi =
    tf32(w), lo = tf32(w - hi)."""
    w = w_kio.float()
    hi = tf32(w)
    idx = _stage_order('tf32', tuple(w.shape), 1, kch, w.device)
    return torch.stack([hi, tf32(w - hi)]).reshape(-1)[idx]


def _f32_pass_rows(C, cfg):
    """Output rows of one pass of a conv (``ConvF32::ROWS``)."""
    return cfg.nw // (C // (8 * cfg.nt)) * 16 * cfg.mt


def _tc_f32_smem(C, cfg, k, dils, bm):
    """Shared memory of a ``tc_f32_kernel`` block (``TcF32Layout``): the
    weight ring, the float32 conv tile (rows of C + 4 floats), the
    schedule."""
    wrows = bm + 2 * chain_halo(k, dils)
    rows = _f32_pass_rows(C, cfg)
    n_sched = sum(_conv_passes(M, rows) for M in _chain_convs(k, dils, wrows))
    return (cfg.nbuf * cfg.kch * C * 8 + wrows * (C + 4) * 4 + 16 * n_sched)


def tc_f32_block(C, k, dils, T):
    """``tc_f32_kernel``'s block_m for one chain of a (B, T, C) group."""
    cfg = TC_F32_CFG[C]
    return _largest_block(
        T, 8, lambda bm: _tc_f32_smem(C, cfg, k, dils, bm) <= SMEM_MAX)


def _tc_f32_plan(x, chains, kernel_sizes, dilations, alloc, slots):
    """Launch plan of the float32 :func:`fused_mrf_tc` (and
    :func:`fused_resblock1`): :func:`_tc_bf_plan`'s launches with the
    float32 kernel's blocks; every residual window in the scratch."""
    B, T, C = x.shape
    return _group_plan(x, chains, kernel_sizes, dilations, alloc, slots,
                       lambda k, d: tc_f32_block(C, k, d, T), False, C)


def _phase_bf_smem(C_in, C, cfg, ks, dils, stride, span, P, hx, bm):
    """Shared memory of a ``phase_bf_kernel`` block (``PhaseBfLayout``), or
    None where the launch would refuse it: past :data:`SMEM_MAX`, or where
    conv_post's sums or the transposed tile would not fit in X0 and A."""
    wrows = bm + 2 * hx
    prows = _pass_rows(C, cfg.nw)
    chain_rows = [(k, d, bm + 2 * chain_halo(k, d) + 2 * P)
                  for k, d in zip(ks, dils)]
    n_sched = stride * _conv_passes(wrows // stride, prows) + sum(
        _conv_passes(M, prows) for k, d, w in chain_rows
        for M in _chain_convs(k, d, w))
    rt = max([wrows] + [tile_rows(k, d, w) for k, d, w in chain_rows])
    x0 = wrows * 2 * C
    a = rt * 2 * C
    orows = bm + 2 * P
    if orows * (C + 1) * 4 > x0 + a or C * (bm + 8) * 2 > x0 + a:
        return None
    ring = cfg.nbuf * max(cfg.tps * C * 2 * cfg.kch,
                          cfg.utps * C * 2 * cfg.ukch)
    r = wrows * (C + 8) * 4 if cfg.r_smem else 0
    xq = max(wrows // stride, _round64(wrows // stride)) * 2 * C_in + \
        span * 2 * C_in
    o = orows * (C + 8) * 4 if cfg.r_smem else 0
    total = ring + x0 + a + max(r, xq) + o + 16 * n_sched
    return total if total <= SMEM_MAX else None


def _phase_f32_smem(C_in, C, ks, dils, stride, span, P, hx, bm):
    """Shared memory of a ``phase_f32_kernel`` block (``PhaseF32Layout``),
    or None where the launch would refuse it: the ring, X0 (the window's
    upsample) and the conv tile A (the widest chain's window, or the x
    tile while the upsample runs), rows of C + 4 floats (the x tile's C_in
    + 4), and the schedule; conv_post's sums and the transposed output tile
    must fit in X0 and A."""
    cfg, ukch = TC_F32_CFG[C], PHASE_F32_UKCH[C_in, C]
    wrows = bm + 2 * hx
    prows = _f32_pass_rows(C, cfg)
    chain_rows = [(k, d, bm + 2 * chain_halo(k, d) + 2 * P)
                  for k, d in zip(ks, dils)]
    n_sched = stride * _conv_passes(wrows // stride, prows) + sum(
        _conv_passes(M, prows) for k, d, w in chain_rows
        for M in _chain_convs(k, d, w))
    x0 = wrows * (C + 4) * 4
    a = max(max(w for _, _, w in chain_rows) * (C + 4) * 4,
            (wrows // stride + span) * (C_in + 4) * 4)
    orows = bm + 2 * P
    if orows * (C + 1) * 4 > x0 + a or C * (bm + 4) * 4 > x0 + a:
        return None
    ring = cfg.nbuf * max(cfg.kch, ukch) * C * 8
    total = ring + x0 + a + 16 * n_sched
    return total if total <= SMEM_MAX else None


@dataclass
class PhaseLaunch:
    """The launch of ``phase_bf_kernel`` (bf16) or ``phase_f32_kernel``
    (float32) for a narrow level. Block i of utterance b owns output
    samples [n0, n0 + block_m), n0 = i*block_m; its window is samples [n0 -
    hx, n0 + block_m + hx). It reads lrelu(x) at input samples (n0 -
    hx)/stride + amin + q for q < window/stride + span (zero outside [0,
    T_in)), runs the upsample into the window (output sample stride*m + r:
    taps t < ntaps of input row m + rows[r] + t), each chain on its own
    window [n0 - halo - P, n0 + block_m + halo + P), sums the chains over
    [n0 - P, n0 + block_m + P) and writes the mean (B, C, N) or conv_post's
    waveform (B, 1, N). ``r_smem``: the float32 windows in shared memory,
    else a scratch slice per resident block (bf16: (window + block_m + 2P)
    x (C + 8) floats; float32: (the widest chain's window + block_m + 2P) x
    C floats); fdot's float32 X0 adds window x C floats to the slice."""
    x: torch.Tensor
    out: torch.Tensor
    chains: list
    ups: tuple
    post: Optional[tuple]
    kernel_sizes: tuple
    dilations: tuple
    stride: int
    ntaps: int
    amin: int
    rows: list
    span: int
    N: int
    hx: int
    P: int
    block_m: int
    n_blocks: int
    r_smem: bool
    scratch: int


def _phase_engine_plan(x, mrf, alloc, slots, f32, fdot=False):
    """Launch plan of :func:`fused_mrf_phase` on a chain kernel
    (``phase_f32_kernel`` when ``f32``, else ``phase_bf_kernel``, with its
    X0 in float32 in the scratch when ``fdot``): a :class:`PhaseLaunch`,
    block_m the largest whose window fits the kernel's shared memory."""
    w_u, _, stride, padding = mrf.ups
    B, C_in, T_in = x.shape
    C = w_u.shape[1]
    ks, dils = mrf.kernel_sizes, mrf.dilations
    ntaps, amin, rows, span, _ = ups_geometry(w_u.shape[-1], stride, padding)
    post_w = mrf.post
    post_k = post_w[0].shape[-1] if post_w is not None else 1
    P = (post_k - 1) // 2
    hmax = max(chain_halo(k, d) for k, d in zip(ks, dils))
    hx = -(-(hmax + P) // stride) * stride
    N = stride * T_in
    step = 8 * stride // math.gcd(8, stride)
    if f32:
        def smem(bm):
            return _phase_f32_smem(C_in, C, ks, dils, stride, span, P, hx, bm)
        r_smem = False
    else:
        cfg = PHASE_BF_CFG[C_in, C]

        def smem(bm):
            return _phase_bf_smem(C_in, C, cfg, ks, dils, stride, span, P,
                                  hx, bm)
        r_smem = cfg.r_smem
    bm = _largest_block(N, step, lambda bm: smem(bm) is not None)
    n_blocks = -(-N // bm)
    out = alloc((B, 1 if post_w is not None else C, N), x.dtype)
    resident = min(B * n_blocks, slots)
    if f32:
        scratch = (bm + 2 * hmax + 2 * P + bm + 2 * P) * C * resident
    else:
        scratch = ((0 if r_smem else (2 * bm + 2 * hx + 2 * P) * (C + 8))
                   + ((bm + 2 * hx) * C if fdot else 0)) * resident
    return PhaseLaunch(x, out, mrf.blk, mrf.blk_ups, post_w, ks, dils,
                       stride, ntaps, amin, rows, span, N, hx, P, bm,
                       n_blocks, r_smem, scratch)


def _phase_bf_plan(x, mrf, alloc, slots, fdot=False):
    """Launch plan of the bf16 :func:`fused_mrf_phase`, or (``fdot``) of
    :func:`fused_mrf_ptc_f`: the same blocks, its float32 upsample output
    in the scratch."""
    return _phase_engine_plan(x, mrf, alloc, slots, False, fdot)


def _phase_f32_plan(x, mrf, alloc, slots):
    """Launch plan of the float32 :func:`fused_mrf_phase`: every float32
    window (the residual, the chain sum) in the scratch."""
    return _phase_engine_plan(x, mrf, alloc, slots, True)


_PHASE_ARGTYPES = ([_P, _I64, _I64, _I64, _I32, _P, _I64, _P, _P, _F32,
                    _F32, _I32, _I32, _I32, _P, _I64, _I32, _P])


def _phase_args(pl, stages, post_dev):
    """The C entry's pointer and int arrays (``mrf_phase.cu``
    phase_params); ``stages``: the kernel's (taps, input channels) per
    stage of the chain convs and of the upsample."""
    wu, bu, wu_phase = pl.ups
    ptrs = [wu.data_ptr(), bu.data_ptr(),
            post_dev[0].data_ptr() if pl.post is not None else 0]
    ints = [pl.stride, pl.ntaps, pl.amin, pl.span]
    ints += list(pl.rows) + [0] * (8 - pl.stride)
    ints += [pl.N, pl.hx, pl.P, pl.post[0].shape[-1] if pl.post is not None
             else 0, pl.block_m, *stages, int(pl.r_smem), wu_phase,
             len(pl.chains)]
    for k, dils, steps in zip(pl.kernel_sizes, pl.dilations, pl.chains):
        ints += [k, len(dils)] + list(dils) + [0] * (4 - len(dils))
        ptrs += [t.data_ptr() for st in steps for t in st]
    return ptrs, ints


def _launch_phase_engine(wrapper, x, mrf, fdot=False):
    """The chain-kernel launch of a :func:`fused_mrf_phase` call,
    ``phase_bf_kernel`` in bf16 and ``phase_f32_kernel`` in float32, or
    (``fdot``) of a :func:`fused_mrf_ptc_f` call, ``phase_bf_kernel`` with
    a float32 upsample output; counted on ``wrapper``."""
    name = wrapper.__name__
    w_u = mrf.ups[0]
    B, C_in, T_in = x.shape
    C = w_u.shape[1]
    f32 = x.dtype == torch.float32
    _check_cuda_input(x, name, PHASE_CHANNELS, C)
    _check_kernel_sizes(name, mrf.kernel_sizes)
    _check_weights(name, x, mrf)
    cfgs = PHASE_F32_UKCH if f32 else PHASE_BF_CFG
    if (C_in, C) not in cfgs:
        raise ValueError(f'{name}: upsample {C_in}->{C} has no CUDA '
                         f'instantiation (built for {tuple(cfgs)})')
    if mrf.blk is None or mrf.blk_ups is None:
        raise ValueError(
            f'{name}: the weights carry no {"float32" if f32 else "bf16"} '
            'engine form (prepare_mrf on the card)')
    # channel-last rows of 16-byte-aligned channels, or channel-major
    chunk = 16 // x.element_size()
    if x.stride(1) == 1:
        if x.stride(2) % chunk or x.stride(0) % chunk or x.data_ptr() % 16:
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif x.stride(2) != 1:
        x = x.contiguous()
    slots = sm_count(x.device)
    pl = _phase_f32_plan(x, mrf, _empty_on(x.device), slots) if f32 else \
        _phase_bf_plan(x, mrf, _empty_on(x.device), slots, fdot)
    if f32:
        stages = (1, TC_F32_CFG[C].kch, 1, PHASE_F32_UKCH[C_in, C])
    else:
        cfg = PHASE_BF_CFG[C_in, C]
        stages = (cfg.tps, cfg.kch, cfg.utps, cfg.ukch)
    scratch = _scratch(pl.scratch, x.device)
    ptrs, ints = _phase_args(pl, stages, mrf.post_dev)
    pa = (ctypes.c_int64 * len(ptrs))(*ptrs)
    ia = (ctypes.c_int * len(ints))(*ints)
    out = pl.out
    kind = 'f32' if f32 else 'fdot' if fdot else 'bf'
    err = _fn('mrf_phase', f'mrf_phase_{kind}', _PHASE_ARGTYPES)(
        _build.ptr(x), x.stride(0), x.stride(1), x.stride(2), T_in,
        _build.ptr(out), out.stride(0), ctypes.cast(pa, ctypes.c_void_p),
        ctypes.cast(ia, ctypes.c_void_p),
        1.0 / len(mrf.kernel_sizes),
        mrf.post_dev[1] if pl.post is not None else 0.0, C_in, C, B,
        _build.ptr(scratch), scratch.numel(), slots, _build.stream_ptr(x))
    _build.check(err, f'MRF {kind} phase level ({C_in}->{C}, '
                 f'block_m={pl.block_m})')
    wrapper.launches += 1
    return out


# ----------------------------------------------------------------------
# the levels without fused upsample (csrc/mrf_ct.cuh: ct_kernel over
# CtBf or CtF32), HiFi-GAN V2's: one launch a level
# ----------------------------------------------------------------------

def _ct_windows(ks, dils, bm):
    """(k, dilations, window rows) of each chain of a block of ``bm``
    output samples."""
    return [(k, d, bm + 2 * chain_halo(k, d)) for k, d in zip(ks, dils)]


def _ct_sched(ks, dils, bm, rows):
    return sum(_conv_passes(M, rows) for k, d, w in _ct_windows(ks, dils, bm)
               for M in _chain_convs(k, d, w))


def _bf_rs(C):
    """Floats a row of the bf16 engine's float32 windows (``ChainBf::RS``)."""
    return 8 if C == 8 else C + 8


def _ct_bf_smem(C, cfg, ks, dils, bm):
    """Shared memory of a bf16 level kernel block (``CtLayout<CtBf<C>>``):
    the weight ring, the bf16 conv tile (the chains' widest ``tile_rows``,
    C/8 chunks), the residual window of the widest chain and the chain sum
    (bm rows), rows of :func:`_bf_rs` floats, and the schedule."""
    wins = _ct_windows(ks, dils, bm)
    wrows = max(w for _, _, w in wins)
    return (cfg.nbuf * cfg.tps * C * 2 * cfg.kch
            + max(tile_rows(k, d, w, 64 * cfg.mg) for k, d, w in wins) * 2 * C
            + (wrows + bm) * _bf_rs(C) * 4
            + 16 * _ct_sched(ks, dils, bm, _pass_rows(C, cfg.nw, cfg.mg)))


def _ct_f32_smem(C, ks, dils, bm, r_smem):
    """Shared memory of a float32 level kernel block
    (``CtLayout<CtF32<C>>``): the weight ring, the float32 conv tile (the
    widest window, rows of C + 4 floats), with ``r_smem`` the residual
    window and the chain sum (bm rows), rows of C floats, and the
    schedule."""
    cfg = TC_F32_CFG[C]
    wrows = bm + 2 * max(chain_halo(k, d) for k, d in zip(ks, dils))
    r = (wrows + bm) * C * 4 if r_smem else 0
    return (cfg.nbuf * cfg.kch * C * 8 + wrows * (C + 4) * 4 + r
            + 16 * _ct_sched(ks, dils, bm, _f32_pass_rows(C, cfg)))


def _ct_geometry(C, f32):
    """(r_smem, shared memory of a block of bm samples, the weight stages
    of one pass of a conv of k taps, the pass's rows, a scratch row's
    floats) of the level kernel at width C."""
    if f32:
        cfg, r_smem = TC_F32_CFG[C], CT_F32_R_SMEM[C]
        return (r_smem, lambda ks, dils, bm: _ct_f32_smem(C, ks, dils, bm,
                                                          r_smem),
                lambda k: k * (C // cfg.kch), _f32_pass_rows(C, cfg), C)
    cfg = CT_BF_CFG[C]
    vt = (lambda k: (k + 1) // 2) if C == 8 else (lambda k: k)
    kc = 1 if C == 8 else C // cfg.kch
    return (cfg.r_smem, lambda ks, dils, bm: _ct_bf_smem(C, cfg, ks, dils, bm),
            lambda k: -(-vt(k) // cfg.tps) * kc, _pass_rows(C, cfg.nw, cfg.mg),
            _bf_rs(C))


@functools.lru_cache(maxsize=None)
def _ct_item_stages(C, f32, ks, dils):
    """The weight stages one item of the level kernel at width C streams
    (each one block barrier and one pass's MMAs), per block size bm = 8,
    16, ... up to the largest whose window fits the shared memory: an
    int64 array, entry i for bm = 8*(i + 1). It depends on neither B nor
    T, so it is built once per width and chain shape."""
    _, smem, stages, rows, _ = _ct_geometry(C, f32)
    per_item = []
    bm = 8
    while smem(ks, dils, bm) <= SMEM_MAX:
        per_item.append(sum(_conv_passes(M, rows) * stages(k)
                            for k, d, w in _ct_windows(ks, dils, bm)
                            for M in _chain_convs(k, d, w)))
        bm += 8
    if not per_item:
        raise ValueError('no block size fits the shared memory')
    return np.array(per_item, dtype=np.int64)


@functools.lru_cache(maxsize=256)
def ct_block(C, f32, ks, dils, B, T, slots):
    """The level kernel's (``ct_kernel`` over CtBf, over CtF32 when
    ``f32``) block_m for a (B, T, C) level on ``slots`` resident blocks:
    of the blocks whose window fits the shared memory (multiples of 8, at
    most T rounded up), the one with the least waves of items
    (ceil(B*ceil(T/bm) / slots)) x weight stages an item streams
    (:func:`_ct_item_stages`), the larger on a tie. Where items outnumber
    the blocks many times over this is about the largest block that fits;
    at a short level (V2's L0 at B = 8: 65536 samples) it spreads the
    items over the card instead of leaving most SMs idle. A new B or T
    costs one vector minimum on the host."""
    per_item = _ct_item_stages(C, f32, ks, dils)
    n = min(len(per_item), -(-T // 8))
    if n < 1:
        raise ValueError(f'no block size for a level of {T} samples')
    bms = 8 * np.arange(1, n + 1, dtype=np.int64)
    cost = -(-B * -(-T // bms) // slots) * per_item[:n]
    return int(bms[n - 1 - int(np.argmin(cost[::-1]))])


@dataclass
class CtLaunch:
    """The launch of the level kernel (``ct_kernel`` over CtBf in bf16,
    over CtF32 in float32) for a level without upsample. Block i of
    utterance b owns output samples [n0, n0 + block_m), n0 = i*block_m.
    Per chain j it reads x over
    [n0 - halos[j], n0 + block_m + halos[j]) (zero outside [0, T)), runs
    the chain's steps with valid convs on that window and adds the chain
    into the block's float32 chain sum; the last chain writes ((the sum) +
    chain) * scale for samples [n0, min(n0 + block_m, T)) into ``out``.
    ``r_smem``: the float32 windows in shared memory, else a scratch slice
    per resident block ((the widest window + block_m) rows of
    :func:`_bf_rs` floats in bf16, C in float32), ``scratch`` floats in
    all."""
    x: torch.Tensor
    out: torch.Tensor
    chains: list
    kernel_sizes: tuple
    dilations: tuple
    halos: tuple
    block_m: int
    n_blocks: int
    r_smem: bool
    scratch: int


def _ct_plan(x, mrf, alloc, slots, block_m=None):
    """Launch plan of ``fused_mrf_ct`` / ``fused_mrf_phase_noups`` on the
    level kernel of x's dtype: a :class:`CtLaunch`, block_m by
    :func:`ct_block` unless given."""
    B, T, C = x.shape
    f32 = x.dtype == torch.float32
    ks, dils = mrf.kernel_sizes, mrf.dilations
    r_smem, _, _, _, row_floats = _ct_geometry(C, f32)
    bm = block_m or ct_block(C, f32, ks, dils, B, T, slots)
    halos = tuple(chain_halo(k, d) for k, d in zip(ks, dils))
    n_blocks = -(-T // bm)
    scratch = 0 if r_smem else \
        (2 * bm + 2 * max(halos)) * row_floats * min(B * n_blocks, slots)
    return CtLaunch(x, alloc((B, T, C), x.dtype), mrf.blk, ks, dils, halos,
                    bm, n_blocks, r_smem, scratch)


def _ct_args(pl, stages):
    """The C entry's pointer and int arrays (``mrf_ct.cu`` ct_params);
    ``stages``: the kernel's taps and input channels per weight stage."""
    ptrs = [t.data_ptr() for steps in pl.chains for st in steps for t in st]
    ints = [pl.block_m, *stages, int(pl.r_smem), len(pl.chains)]
    for k, dils in zip(pl.kernel_sizes, pl.dilations):
        ints += [k, len(dils)] + list(dils) + [0] * (4 - len(dils))
    return ptrs, ints


# ----------------------------------------------------------------------
# one ResBlock1 chain (port of vocoder_kernels.py:134-235, 1542-1559)
# ----------------------------------------------------------------------

def pack_resblock_weights(rb_params, n_dil):
    """Port of ``pack_resblock_weights``: one ResBlock1's params (torch
    (out, in, k) convs) -> (w1, b1, w2, b2), w (n_dil, k, C_in, C_out) and
    b (n_dil, C)."""
    def stack(prefix):
        convs = [rb_params[f'{prefix}_{i}'] for i in range(n_dil)]
        return (torch.stack([c['w'].permute(2, 1, 0) for c in convs]),
                torch.stack([c['b'] for c in convs]))
    return stack('convs1') + stack('convs2')


def resblock1_plain(x, w1, b1, w2, b2, kernel_size, dilations, tile=4096):
    """The plain version of :func:`fused_resblock1`: x zero-padded once by
    the chain's receptive field, then valid convs (conv inputs lrelu'd and
    rounded to x's dtype, float32 sums), in x's dtype."""
    if x.shape[1] % tile:
        raise ValueError(f'T={x.shape[1]} not a multiple of tile={tile}')
    return mrf_tc_plain(x, [w1, b1, w2, b2], (kernel_size,),
                        (tuple(dilations),))


def fused_resblock1(x, w1, b1, w2, b2, kernel_size, dilations, tile=4096):
    """One ResBlock1 chain (``fused_resblock1``, the TPU kernel with zero
    SAME padding at the edges collapsed to one padding of the input). x:
    (B, T, C) bfloat16 or float32, T a multiple of ``tile`` (the TPU
    kernel's time tile; the result does not depend on it); w1/w2 (n_dil,
    k, C_in, C_out) and b1/b2 (n_dil, C) from
    :func:`pack_resblock_weights`, in x's dtype on the card. Returns (B, T,
    C) in x's dtype. On a CUDA tensor this stages the weights for the chain
    kernels (:func:`prepare_mrf`) and launches ``mrf_tc.cu`` once (C in
    :data:`TC_CHANNELS`, or raises): the group of one chain of
    :func:`fused_mrf_tc`, ``tc_bf_kernel`` in bf16 and ``tc_f32_kernel``
    (3xTF32 on the tensor cores) in float32. On a CPU tensor it runs
    :func:`resblock1_plain`.

    ``fused_resblock1.launches`` counts CUDA launches;
    ``fused_resblock1.calls`` counts CUDA-route calls by (B, T, C, k,
    dilations, dtype name)."""
    B, T, C = x.shape
    if x.device.type == 'cpu':
        return resblock1_plain(x, w1, b1, w2, b2, kernel_size, dilations,
                               tile)
    if T % tile:
        raise ValueError(f'T={T} not a multiple of tile={tile}')
    _check_cuda_input(x, 'fused_resblock1', TC_CHANNELS, C)
    _check_kernel_sizes('fused_resblock1', (kernel_size,))
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f'fused_resblock1: weights {w1.dtype} for x '
                         f'{x.dtype}; the kernel takes them in x\'s dtype')
    ks, dils = (kernel_size,), (tuple(dilations),)
    mrf = prepare_mrf([w1, b1, w2, b2], ks, dils)
    _check_weights('fused_resblock1', x, mrf)
    out = _launch_tc_chains(fused_resblock1, x, mrf)
    fused_resblock1.calls[tuple(x.shape) + (kernel_size, dils[0],
                                            str(x.dtype)[6:])] += 1
    return out


fused_resblock1.launches = 0
fused_resblock1.calls = collections.Counter()


# ----------------------------------------------------------------------
# int8-static tier: quantisation helpers (port of vocoder_kernels.py:37-107)
# ----------------------------------------------------------------------
#
# The f32 operations keep the JAX package's order, and every division by a
# constant divides by a tensor on the same device: on CUDA, PyTorch turns a
# division by a Python number into a multiplication by its reciprocal,
# which is another rounding (and flips int8 values by one). The dequant
# epilogues ``acc * scale + bias`` round once, as a fused multiply-add: the
# JAX kernels compile them so on the CPU (bit-identical to the port's plain
# versions there), and the CUDA kernels use ``__fmaf_rn``.

def _const(x, value):
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _fma(a, b, c):
    """a * b + c in float32 with one rounding: the product of an int32
    accumulator (|a| < 2^29) and a float32 is exact in float64. (Rounding
    the float64 sum to float32 differs from a true FMA only when that sum
    falls on a float32 tie.)"""
    return (a.double() * b.double() + c.double()).float()


def quantize_rows(w, row_axes=(0,)):
    """Symmetric int8 quantisation per output row: (q int8, scale f32),
    the scale's amax taken over every axis but ``row_axes``."""
    reduce = tuple(a for a in range(w.ndim) if a not in row_axes)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce, keepdim=True)
    s = amax.clamp(min=1e-30) / _const(wf, 127.0)
    return torch.round(wf / s).to(torch.int8), s


def quantize_static(x, inv_s):
    """int8 of x with a static per-channel multiplier: rint(x * inv_s),
    saturated at +-127 (``_quantize_static``)."""
    return torch.round(x * inv_s).clamp(-127.0, 127.0).to(torch.int8)


def quantize_lrelu_static(x, inv_s):
    """int8 of lrelu(x) with a static per-channel multiplier ``inv_s``
    (127/amax of the calibration): the slope folds into the multiplier.
    Rounds half to even and saturates at +-127."""
    m = torch.where(x >= 0, inv_s, LRELU_SLOPE * inv_s)
    return torch.round(x * m).clamp(-127.0, 127.0).to(torch.int8)


def requant_lrelu_s32(acc, b_i32, mult):
    """The conv1 -> conv2 boundary in the s32 domain: int8 of
    lrelu(acc*sw1 + b1) at the next conv's static scale, with
    ``b_i32`` = round(b1/sw1) and ``mult`` = sw1*inv2."""
    accb = acc + b_i32
    m = torch.where(accb >= 0, mult, LRELU_SLOPE * mult)
    return torch.round(accb.float() * m).clamp(-127.0, 127.0).to(torch.int8)


def fuse_boundary_consts(sw1, b1, inv2):
    """(b_i32, mult) of :func:`requant_lrelu_s32`; the s32 bias is clipped
    to +-2^30 so an all-zero weight row cannot overflow the cast."""
    b_i32 = torch.round(b1.float() / sw1).clamp(-2.0 ** 30, 2.0 ** 30)
    return b_i32.to(torch.int32), (sw1 * inv2).float()


def _act_scale(s_cal, margin, like):
    """Static activation step from a calibrated amax: max(s, 1e-30) *
    margin / 127, per channel."""
    s = torch.as_tensor(s_cal, dtype=torch.float32, device=like.device)
    return s.clamp(min=1e-30) * margin / _const(s, 127.0)


def pack_mrf_tc_int8_weights(params, level, kernel_sizes, dilations,
                             act_scales, margin=1.1):
    """Port of ``pack_mrf_tc_int8_weights``: per block [wq1, inv1, b1i, m1,
    wq2, sw2, b2] with wq (n_dil, k, C_in, C_out) int8 (the act scales
    folded into the input channels, quantised per output channel) and
    (n_dil, 1, C) vectors. ``act_scales``: the level's [(s1, s2) per
    block] from :func:`calibrate_act_scales`, s shaped (n_dil, C)."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        packed = {}
        for prefix, s_cal in zip(('convs1', 'convs2'), act_scales[j]):
            wqs, sws, invs, bs = [], [], [], []
            for i in range(len(dils)):
                w = rb[f'{prefix}_{i}']['w'].permute(2, 1, 0)    # (k, ci, co)
                s = _act_scale(s_cal[i], margin, w)
                wq, sw = quantize_rows((w.float() * s[None, :, None])
                                       .permute(2, 0, 1))       # rows = co
                wqs.append(wq.permute(1, 2, 0))
                sws.append(sw[:, 0, 0])
                invs.append(1.0 / s)
                bs.append(rb[f'{prefix}_{i}']['b'].float())
            packed[prefix] = (torch.stack(wqs), torch.stack(sws)[:, None],
                              torch.stack(invs)[:, None],
                              torch.stack(bs)[:, None])
        wq1, sw1, inv1, b1 = packed['convs1']
        wq2, sw2, inv2, b2 = packed['convs2']
        b1i, m1 = fuse_boundary_consts(sw1, b1, inv2)
        out += [wq1, inv1, b1i, m1, wq2, sw2, b2]
    return out


# ----------------------------------------------------------------------
# phase-tc packers and geometry (port of vocoder_kernels.py:870, 1591-1788)
# ----------------------------------------------------------------------
#
# The TPU kernel keeps p phases x C channels in its 128 lanes: row q of a
# (B, Q, p*C) phase-tc tensor holds samples p*q .. p*q + p - 1, so it is a
# reshape of the sample-major (B, p*Q, C) tensor the port keeps. The
# packers build the TPU kernel's shift matrices (held to JAX's by the
# tests); :func:`prepare_mrf_ptc` reads the per-tap weights back out of
# them for the port's sample-domain kernels.

def _ptc_spec(k, d, p):
    """Shift table of one dilated conv in phase-tc layout."""
    half = (k - 1) // 2
    ent = {}
    for r in range(p):
        for t in range(k):
            s_, a = divmod(r + d * (t - half), p)
            ent.setdefault(s_, []).append((a, r, t))
    shifts = tuple(sorted(ent))
    return dict(shifts=shifts, smin=shifts[0], smax=shifts[-1],
                span=shifts[-1] - shifts[0], entries=ent)


def _ptc_band(w, d, p, s_cal=None, margin=1.1):
    """torch (C_out, C_in, k) -> (S, p*C_in, p*C_out) float32 shift
    matrices with the static act scales folded into the input rows (none
    when ``s_cal`` is None: the dynamic and float forms), the kernel-side
    activation multiplier (1, p*C_in) and the shift table."""
    C_out, C_in, k = w.shape
    spec = _ptc_spec(k, d, p)
    s = (torch.ones(C_in, device=w.device) if s_cal is None
         else _act_scale(s_cal, margin, w))
    wf = w.permute(1, 0, 2).float() * s[:, None, None]        # (ci, co, k)
    M = wf.new_zeros((len(spec['shifts']), p * C_in, p * C_out))
    for si, s_ in enumerate(spec['shifts']):
        for a, r, t in spec['entries'][s_]:
            M[si, a * C_in:(a + 1) * C_in, r * C_out:(r + 1) * C_out] += \
                wf[:, :, t]
    return M, (1.0 / s).repeat(p)[None, :], spec


def _ptc_quant(M):
    """Joint per-output-column int8 quantisation across the shift
    matrices (they sum into one s32 accumulator)."""
    amax = M.abs().amax(dim=(0, 1))
    sw = amax.clamp(min=1e-30) / _const(amax, 127.0)
    return torch.round(M / sw[None, None, :]).to(torch.int8), sw[None, :]


def pack_mrf_ptc_weights(params, level, kernel_sizes, dilations, p,
                         act_scales=None, margin=1.1):
    """Port of ``pack_mrf_ptc_weights``. With ``act_scales`` the static
    form: per (block, dilation) [W1 (S1, p*C, p*C) int8, inv1, b1i, m1, W2
    (S2, ...) int8, sw2, b2] with (1, p*C) row vectors. Without, the
    dynamic (``dyn``) form: [W1, sw1, b1, W2, sw2, b2]."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        s1_cal, s2_cal = act_scales[j] if act_scales is not None \
            else ((None,) * len(dils),) * 2
        for i, d in enumerate(dils):
            b1t = rb[f'convs1_{i}']['b'].float().repeat(p)[None, :]
            b2t = rb[f'convs2_{i}']['b'].float().repeat(p)[None, :]
            M1, inv1, _ = _ptc_band(rb[f'convs1_{i}']['w'], d, p, s1_cal[i],
                                    margin)
            M2, inv2, _ = _ptc_band(rb[f'convs2_{i}']['w'], 1, p, s2_cal[i],
                                    margin)
            q1, sw1 = _ptc_quant(M1)
            q2, sw2 = _ptc_quant(M2)
            if act_scales is None:
                out += [q1, sw1, b1t, q2, sw2, b2t]
                continue
            b1i, m1 = fuse_boundary_consts(sw1, b1t, inv2)
            out += [q1, inv1, b1i, m1, q2, sw2, b2t]
    return out


def pack_mrf_ptc_f_weights(params, level, kernel_sizes, dilations, p,
                           dtype=torch.bfloat16):
    """Port of ``pack_mrf_ptc_f_weights`` (``fused_mrf_ptc``'s fdot form):
    per (block, dilation) [W1 (S1, p*C, p*C) in ``dtype``, b1 (1, p*C)
    float32, W2, b2], the int8 packer's shift matrices unquantised."""
    out = []
    for j, dils in enumerate(dilations):
        rb = params[f'resblock_{level}_{j}']
        for i, d in enumerate(dils):
            for prefix, dd in (('convs1', d), ('convs2', 1)):
                M, _, _ = _ptc_band(rb[f'{prefix}_{i}']['w'], dd, p)
                out += [M.to(dtype),
                        rb[f'{prefix}_{i}']['b'].float().repeat(p)[None, :]]
    return out


def _ups_phase_entries(k, stride, padding, p_in):
    """(r, j, a, delta) contributions of a phase-layout transposed conv:
    output phase r takes kernel tap j of input phase a at row offset
    delta; also the offsets' range."""
    if k - 2 * padding != stride:
        raise ValueError('phase transposed conv requires k - 2*padding == '
                         f'stride (got k={k}, padding={padding}, '
                         f'stride={stride})')
    entries = []
    for r in range(stride * p_in):
        for j in range(k):
            if (r + padding - j) % stride != 0:
                continue
            e = (r + padding - j) // stride
            entries.append((r, j, e % p_in, e // p_in))
    return (entries, min(d for *_, d in entries),
            max(d for *_, d in entries))


def _ups_ptc_band(w, stride, padding, p_in):
    """ConvTranspose1d (torch (C_in, C_out, k)) -> the phase-tc upsample's
    float32 shift matrices (S, p_in*C_in, stride*p_in*C_out) and shifts."""
    C_in, C_out, k = w.shape
    entries, _, _ = _ups_phase_entries(k, stride, padding, p_in)
    shifts = tuple(sorted({d for *_, d in entries}))
    sidx = {s_: i for i, s_ in enumerate(shifts)}
    U = w.new_zeros((len(shifts), p_in * C_in, stride * p_in * C_out),
                    dtype=torch.float32)
    wf = w.float()
    for r, j, a, d in entries:
        U[sidx[d], a * C_in:(a + 1) * C_in, r * C_out:(r + 1) * C_out] += \
            wf[:, :, j]
    return U, shifts


def pack_ups_ptc_weights(w, b, stride, padding, p_in):
    """ConvTranspose1d (torch (C_in, C_out, k)) -> the phase-tc upsample
    weights (Uq (S, p_in*C_in, po*C_out) int8, sw (1, po*C_out), bias
    (1, po*C_out), shifts): one weight scale per (output phase, channel);
    the activation scale is dynamic, one per tile."""
    U, shifts = _ups_ptc_band(w, stride, padding, p_in)
    Uq, sw = _ptc_quant(U)
    return Uq, sw, b.float().repeat(stride * p_in)[None, :], shifts


def pack_ups_ptc_f_weights(w, b, stride, padding, p_in,
                           dtype=torch.bfloat16):
    """Port of ``pack_ups_ptc_f_weights``: the fdot form of
    :func:`pack_ups_ptc_weights`, (U in ``dtype``, bias (1, po*C_out)
    float32, shifts)."""
    U, shifts = _ups_ptc_band(w, stride, padding, p_in)
    return U.to(dtype), b.float().repeat(stride * p_in)[None, :], shifts


def pack_post_ptc_weights(w, b, p, dtype=torch.float32):
    """conv_post (torch (C_out, C_in, k)) -> phase-tc epilogue weights
    (P (S, p*C_in, p*C_out) in ``dtype``, bias (1, p*C_out) float32, k)."""
    C_out, C_in, k = w.shape
    spec = _ptc_spec(k, 1, p)
    P = w.new_zeros((len(spec['shifts']), p * C_in, p * C_out),
                    dtype=torch.float32)
    wf = w.permute(1, 0, 2).float()
    for si, s_ in enumerate(spec['shifts']):
        for a, r, t in spec['entries'][s_]:
            P[si, a * C_in:(a + 1) * C_in, r * C_out:(r + 1) * C_out] += \
                wf[:, :, t]
    return P.to(dtype), b.float().repeat(p)[None, :], k


def ptc_chain_halo(kernel_sizes, dilations, p):
    """Per-side halo in phase-tc rows of the fused chain, 64-aligned."""
    worst = max(sum(_ptc_spec(k, d, p)['span'] + _ptc_spec(k, 1, p)['span']
                    for d in dils)
                for k, dils in zip(kernel_sizes, dilations))
    return -(-worst // 64) * 64


def _ptc_chain_geometry(kernel_sizes, dilations, p, tile, halo):
    """Per block (row offset, rows left) after the fused chain."""
    geo = []
    for k, dils in zip(kernel_sizes, dilations):
        off, cur_len = 0, tile + 2 * halo
        for d in dils:
            sp1, sp2 = _ptc_spec(k, d, p), _ptc_spec(k, 1, p)
            off += -sp1['smin'] - sp2['smin']
            cur_len -= sp1['span'] + sp2['span']
        geo.append((off, cur_len))
    return geo


def ptc_post_feasible(kernel_sizes, dilations, p, post_k, tile):
    """True when the chain halo leaves room for the conv_post window."""
    halo = ptc_chain_halo(kernel_sizes, dilations, p)
    sp = _ptc_spec(post_k, 1, p)
    for off, cur_len in _ptc_chain_geometry(kernel_sizes, dilations, p,
                                            tile, halo):
        start = halo + sp['smin'] - off
        if start < 0 or start + tile + sp['span'] > cur_len:
            return False
    return True


def ptc_halo_in(halo, ups_shifts):
    """Per-side halo in input rows of the upsample prologue, 64-aligned
    (``_fused_mrf_ptc_jit``'s ``halo_in``)."""
    return -(-max(halo - ups_shifts[0], halo + ups_shifts[-1]) // 64) * 64


def ptc_tile(rows, tile=8192):
    """The phase-tc tile: ``tile`` rows halved until it divides ``rows``
    (``hifigan._pallas_mrf_ptc``); None when 64 rows do not."""
    while rows % tile and tile > 64:
        tile //= 2
    return None if rows % tile else tile


# ----------------------------------------------------------------------
# fused_mrf_ptc, fdot mode: the bf16 tier's phase-tc form
# ----------------------------------------------------------------------
#
# Unquantised bf16 dots on the shift matrices: the float phase kernel's
# function (upsample prologue, chains, conv_post epilogue; every tile's
# window covers its receptive field, so the tile does not matter) but for
# the prologue's output x0 = acc + b_u, which the TPU kernel keeps in
# float32 (vocoder_kernels.py:1835) where the banded phase kernel rounds it
# to the compute dtype (:1121). The dots are bf16 whatever x's dtype
# (``hifigan._pallas_mrf_ptc`` packs bf16 weights), conv_post's weights are
# in x's dtype. On the card it is the bf16 engine's ``phase_bf_kernel``
# with its X0 in float32, in a per-block scratch slice, on the bf16 level's
# blocks (:func:`_phase_bf_plan` with ``fdot``).

def prepare_mrf_ptc_f(packed, kernel_sizes, dilations, p, ups, post=None):
    """:class:`MrfWeights` of a narrow level for :func:`fused_mrf_ptc_f`,
    the per-tap weights read back out of the fdot packers: ``packed`` from
    :func:`pack_mrf_ptc_f_weights`; ``ups`` = (U, bias, shifts) from
    :func:`pack_ups_ptc_f_weights` followed by the ConvTranspose1d's (k,
    stride, padding, p_in); ``post`` = (P, bias, post_k) from
    :func:`pack_post_ptc_weights` at the last level."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C = packed[0].shape[2] // p
    taps, n = [], 0
    for k, dils in zip(kernel_sizes, dilations):
        w1, b1, w2, b2 = [], [], [], []
        for d in dils:
            M1, c1, M2, c2 = packed[n:n + 4]
            n += 4
            w1.append(_ptc_taps(M1, k, d, p, C, C))
            w2.append(_ptc_taps(M2, k, 1, p, C, C))
            b1.append(c1[0, :C])
            b2.append(c2[0, :C])
        taps += [torch.stack(w1), torch.stack(b1), torch.stack(w2),
                 torch.stack(b2)]
    U, b_u, shifts, k_u, stride, padding, p_in = ups
    if stride * p_in != p:
        raise ValueError(f'upsample stride {stride} x input phases {p_in} '
                         f'!= {p} phases')
    C_in = U.shape[1] // p_in
    sidx = {s_: i for i, s_ in enumerate(shifts)}
    cols = {}
    for r, j, a, d in _ups_phase_entries(k_u, stride, padding, p_in)[0]:
        cols.setdefault(j, U[sidx[d], a * C_in:(a + 1) * C_in,
                             r * C:(r + 1) * C])
    w_u = torch.stack([cols[j] for j in range(k_u)], dim=2)   # (C_in, C, k)
    pst = None
    if post is not None:
        P, b_p, post_k = post
        pst = (_ptc_taps(P, post_k, 1, p, C, 1).permute(2, 1, 0),
               b_p[0, :1])
    mrf = prepare_mrf(taps, kernel_sizes, dilations,
                      (w_u, b_u[0, :C], stride, padding), pst)
    mrf.p = p
    return mrf


def _check_ptc_f(mrf, T_in, tile):
    rows = T_in // (mrf.p // mrf.ups[2])
    if rows % tile:
        raise ValueError(f'rows={rows} not a multiple of tile={tile}')
    if mrf.post is not None and not ptc_post_feasible(
            mrf.kernel_sizes, mrf.dilations, mrf.p, mrf.post[0].shape[-1],
            tile):
        raise ValueError('chain halo too small for conv_post epilogue')


def mrf_ptc_f_plain(x, mrf, tile):
    """The plain version of :func:`fused_mrf_ptc_f`."""
    _check_ptc_f(mrf, x.shape[2], tile)
    return mrf_phase_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations,
                           mrf.ups, mrf.post, fdot=True)


def fused_mrf_ptc_f(x, mrf, tile):
    """Upsample + fused MRF group (+ conv_post) of a narrow level in
    ``fused_mrf_ptc``'s fdot mode. x: (B, C_in, T_in), the level's
    PRE-upsample activation (any strides: the phase-tc rows (B, rows,
    p_in*C_in) are the transposed (B, T_in, C_in) tensor); ``mrf`` from
    :func:`prepare_mrf_ptc_f`; ``tile`` the TPU kernel's phase-tc rows per
    tile (divides rows; conv_post must fit its halo). Returns (B, C, N), or
    with ``mrf.post`` the waveform (B, 1, N), N = p*rows, in x's dtype. On
    a CUDA tensor (bfloat16) this launches ``mrf_phase.cu``'s
    ``phase_bf_kernel`` with a float32 upsample output, one launch a call
    (or raises); on a CPU tensor it runs :func:`mrf_ptc_f_plain`. The tile
    sets what ``_check_ptc_f`` accepts and, through the caller, whether
    conv_post fuses, not the kernel's blocks.

    ``fused_mrf_ptc_f.launches`` counts CUDA launches;
    ``fused_mrf_ptc_f.calls`` counts CUDA-route calls by x's shape and mode
    'fdot'."""
    if mrf.ups is None or not mrf.p:
        raise ValueError('fused_mrf_ptc_f: the weights are not '
                         'prepare_mrf_ptc_f\'s')
    if x.device.type == 'cpu':
        return mrf_ptc_f_plain(x, mrf, tile)
    _check_ptc_f(mrf, x.shape[2], tile)
    if x.dtype != torch.bfloat16:
        raise ValueError('fused_mrf_ptc_f: the CUDA route takes bfloat16 '
                         f'activations, not {x.dtype}')
    out = _launch_phase_engine(fused_mrf_ptc_f, x, mrf, fdot=True)
    fused_mrf_ptc_f.calls[tuple(x.shape) + ('fdot',)] += 1
    return out


fused_mrf_ptc_f.launches = 0
fused_mrf_ptc_f.calls = collections.Counter()


# ----------------------------------------------------------------------
# int8-static weights in the port's sample domain
# ----------------------------------------------------------------------

@dataclass
class MrfQ8Weights:
    """One level's int8-static weights for :func:`fused_mrf_tc_q8` and
    :func:`fused_mrf_ptc`, per tap in the sample domain:
    ``chains[j][i]`` = (wq1 (k, C, C) int8, inv1 (C,), b1i (C,) int32, m1,
    wq2 (k, C, C) int8, sw2, b2) of chain j, dilation i. For the phase-tc
    kernel also ``ups`` = (wq (stride, ntaps, C_in, C) int8, sw (stride,
    C), bias (C,), stride, padding, k) with its phase-tc ``ups_shifts``,
    ``p`` / ``p_in`` (phases after / before the upsample) and, at the last
    level, ``post`` = (w (k, C) float32 of ``post_dtype`` values, bias
    (1,) float32, post_dtype). For weights on a CUDA device the ``*_dev``
    fields hold the kernels' format (None on the CPU); in
    ``ops/mrf_int8.py``'s ct and phase forms ``blk_dev`` / ``blk_ups_dev``
    hold the staged form in their place.

    ``dynamic`` weights (the int8-dynamic tier, ``ops/mrf_int8.py``) hold
    per step (wq1, sw1, b1, wq2, sw2, b2) with float32 (C,) vectors: the
    activation scales are taken per tile at run time. ``q8s`` weights (the
    static tier with the float32 conv1 -> conv2 boundary) hold (wq1, sw1,
    inv1, b1, wq2, sw2, inv2, b2)."""
    device: torch.device
    kernel_sizes: tuple
    dilations: tuple
    chains: list
    dynamic: bool = False
    q8s: bool = False
    p: int = 1
    p_in: int = 1
    ups: Optional[tuple] = None
    ups_shifts: tuple = ()
    post: Optional[tuple] = None
    chains_dev: Optional[list] = None
    ups_dev: Optional[tuple] = None
    post_dev: Optional[tuple] = None
    blk_dev: Optional[list] = None
    blk_ups_dev: Optional[tuple] = None

    @property
    def mode(self):
        """The chain weights' form: 'dynamic', 'q8f' or 'q8s'."""
        return 'dynamic' if self.dynamic else 'q8s' if self.q8s else 'q8f'


def swizzle_key(rows, row_bytes):
    """The 16-byte-chunk XOR key of each row of an s8 tile with
    ``row_bytes`` bytes per row (``mrf_chain_q8.cuh`` ``swz_key``): chunk c
    of row r is stored at chunk c ^ key[r]."""
    r = torch.arange(rows)
    if row_bytes >= 128:
        return r & 7
    return (r // (128 // row_bytes)) & (row_bytes // 16 - 1)


def pack_stage_s8(w_kio, tps, kch):
    """(taps, C_in, C_out) int8 -> bytes in the staged order the
    block-resident kernels copy into shared memory (``mrf_chain_q8.cuh``
    ``Conv``): stage s = g*(C_in/kch) + kc holds taps [g*tps, (g+1)*tps)
    (zeros past the last) x input channels [kc*kch, (kc+1)*kch), as
    [tap][output channel n][kch bytes], the 16-byte chunks of row n
    swizzled by :func:`swizzle_key`."""
    taps, ci, co = w_kio.shape
    G = -(-taps // tps)
    w = F.pad(w_kio.to(torch.int8), (0, 0, 0, 0, 0, G * tps - taps))
    # [g][kc][tp][n][byte]
    w = w.reshape(G, tps, ci // kch, kch, co).permute(0, 2, 1, 4, 3)
    key = swizzle_key(co, kch).to(w.device)
    pos = torch.arange(kch, device=w.device)
    src = (((pos[None, :] >> 4) ^ key[:, None]) << 4) | (pos[None, :] & 15)
    w = torch.gather(w, 4, src.expand(w.shape).contiguous())
    return w.contiguous().reshape(-1)


def prepare_mrf_tc_q8(packed, kernel_sizes, dilations):
    """:class:`MrfQ8Weights` of a wide level from
    :func:`pack_mrf_tc_int8_weights` (or the JAX packer's arrays)."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    chains = []
    for j, dils in enumerate(dilations):
        wq1, inv1, b1i, m1, wq2, sw2, b2 = packed[7 * j:7 * j + 7]
        chains.append([(wq1[i], inv1[i, 0].float(), b1i[i, 0].int(),
                        m1[i, 0].float(), wq2[i], sw2[i, 0].float(),
                        b2[i, 0].float()) for i in range(len(dils))])
    mrf = MrfQ8Weights(packed[0].device, kernel_sizes, dilations, chains)
    C = chains[0][0][0].shape[-1]
    if mrf.device.type == 'cuda' and C in TC_Q8_CFG:
        mrf.chains_dev = staged_chains(chains, *TC_Q8_CFG[C][1:])
    return mrf


def staged_chains(chains, tps, kch):
    """The block-resident kernels' format of q8f per-step weights: taps by
    :func:`pack_stage_s8`, vectors contiguous."""
    return [[tuple(pack_stage_s8(a, tps, kch) if a.dtype == torch.int8
                   else a.contiguous().clone() for a in st) for st in steps]
            for steps in chains]


def _ptc_taps(M, k, d, p, C_in, C_out):
    """The (k, C_in, C_out) taps of output phase 0 in shift matrices M:
    tap t of a conv with dilation d reads phase a of row offset s, with
    p*s + a = d*(t - half). Every output phase holds the same taps."""
    idx = {s_: i for i, s_ in enumerate(_ptc_spec(k, d, p)['shifts'])}
    half = (k - 1) // 2
    taps = []
    for t in range(k):
        s_, a = divmod(d * (t - half), p)
        taps.append(M[idx[s_], a * C_in:(a + 1) * C_in, :C_out])
    return torch.stack(taps)


def _vec(v, C):
    """The first C entries of a packed row or column vector, as the
    per-step vectors hold them (int32 kept, the rest float32)."""
    v = v.reshape(-1)[:C]
    return v.int() if v.dtype == torch.int32 else v.float()


def prepare_mrf_ptc(packed, kernel_sizes, dilations, p, ups, post=None):
    """:class:`MrfQ8Weights` of a narrow level from the phase-tc packers:
    ``packed`` from :func:`pack_mrf_ptc_weights` (static when its steps
    have seven arrays, dynamic when six); ``ups`` = (Uq, sw, bias, shifts)
    from :func:`pack_ups_ptc_weights` followed by the ConvTranspose1d's (k,
    stride, padding, p_in); ``post`` = (P, bias, post_k) from
    :func:`pack_post_ptc_weights` at the last level."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C = packed[0].shape[2] // p
    n_steps = sum(len(d) for d in dilations)
    per = len(packed) // n_steps
    if per not in (6, 7) or per * n_steps != len(packed):
        raise ValueError(f'{len(packed)} arrays for {n_steps} chain steps')
    chains, n = [], 0
    for k, dils in zip(kernel_sizes, dilations):
        steps = []
        for d in dils:
            st = packed[n:n + per]
            n += per
            t2 = per - 3                      # W2's place in the step
            steps.append(tuple(
                _ptc_taps(a, k, d if m == 0 else 1, p, C, C) if m in (0, t2)
                else _vec(a, C) for m, a in enumerate(st)))
        chains.append(steps)
    Uq, sw_u, b_u, shifts, k_u, stride, padding, p_in = ups
    if stride * p_in != p:
        raise ValueError(f'upsample stride {stride} x input phases {p_in} '
                         f'!= {p} phases')
    C_in = Uq.shape[1] // p_in
    entries, _, _ = _ups_phase_entries(k_u, stride, padding, p_in)
    where = {(r, j): (a, d) for r, j, a, d in entries}
    sidx = {s_: i for i, s_ in enumerate(shifts)}
    _, _, _, _, taps = ups_geometry(k_u, stride, padding)
    wq_u = torch.stack([torch.stack([
        Uq[sidx[where[r, j][1]],
           where[r, j][0] * C_in:(where[r, j][0] + 1) * C_in,
           r * C:(r + 1) * C] for j in taps[r]]) for r in range(stride)])
    sw = torch.stack([sw_u[0, r * C:(r + 1) * C].float()
                      for r in range(stride)])
    mrf = MrfQ8Weights(packed[0].device, kernel_sizes, dilations, chains,
                       dynamic=per == 6, p=p, p_in=p_in,
                       ups_shifts=tuple(shifts),
                       ups=(wq_u, sw, b_u[0, :C].float(), stride, padding,
                            k_u))
    if post is not None:
        P, b_p, post_k = post
        w_p = _ptc_taps(P, post_k, 1, p, C, 1)[:, :, 0].float()   # (k, C)
        mrf.post = (w_p, b_p[0, :1].float(), P.dtype)
    if mrf.device.type == 'cuda':
        st = Q8_STAGES.get((C_in, C))
        if st is not None and mrf.dynamic:   # the segment-synchronised engine
            mrf.blk_dev = staged_chains(chains, st.tps, st.kch)
            mrf.blk_ups_dev = (torch.cat([
                pack_stage_s8(wq_u[r], st.utps, st.ukch)
                for r in range(stride)]), sw.contiguous(),
                mrf.ups[2].contiguous())
        elif st is not None:     # static: ptc_fused_q8_kernel
            mrf.chains_dev = staged_chains(chains, st.tps, st.kch)
            mrf.ups_dev = (torch.cat([pack_stage_s8(wq_u[r], st.utps, st.ukch)
                                      for r in range(stride)]),
                           sw.contiguous().clone(),
                           mrf.ups[2].contiguous().clone())
        if mrf.post is not None:
            mrf.post_dev = (mrf.post[0].contiguous(),
                            float(mrf.post[1][0]))
    return mrf


# ----------------------------------------------------------------------
# int8-static plain versions
# ----------------------------------------------------------------------

def _int_conv(q, w, d, L_out):
    """Valid dilated conv of int8 (B, L, C_in) by int8 taps (k, C_in,
    C_out): the exact int32 sums, as the TPU kernel's per-tap s8 dots.
    One float32 matmul per tap is exact (|partial sums| <= C_in * 127^2 <
    2^24); the taps sum in int32."""
    if w.shape[1] * 127 * 127 >= 1 << 24:
        raise ValueError(f'C_in={w.shape[1]}: a tap sum may leave float32')
    qf = q.float()
    acc = None
    for t in range(w.shape[0]):
        c = torch.matmul(qf[:, t * d:t * d + L_out], w[t].float()).to(
            torch.int32)
        acc = c if acc is None else acc + c
    return acc


def _chain_q8(cur, steps, k, dils):
    """One ResBlock1 chain in an int8-static form by valid convs on float32
    (B, L, C): q8f, or q8s when its steps hold eight arrays (the conv1 ->
    conv2 boundary dequantised, lrelu'd and requantised in float32).
    Returns (B, L - 2*chain_halo, C)."""
    half = (k - 1) // 2
    for st, d in zip(steps, dils):
        L1 = cur.shape[1] - 2 * d * half
        L2 = L1 - 2 * half
        if len(st) == 8:
            wq1, sw1, inv1, b1, wq2, sw2, inv2, b2 = st
            acc = _int_conv(quantize_static(_lrelu(cur), inv1), wq1, d, L1)
            q2 = quantize_static(_lrelu(_fma(acc, sw1, b1)), inv2)
        else:
            wq1, inv1, b1i, m1, wq2, sw2, b2 = st
            acc = _int_conv(quantize_lrelu_static(cur, inv1), wq1, d, L1)
            q2 = requant_lrelu_s32(acc, b1i, m1)
        acc2 = _int_conv(q2, wq2, 1, L2)
        sh = d * half + half
        cur = cur[:, sh:sh + L2] + _fma(acc2, sw2, b2)
    return cur


def mrf_tc_q8_plain(x, mrf):
    """The plain version of :func:`fused_mrf_tc_q8` (``fused_mrf_tc``,
    ``q8=True``), and of every int8-static chain whose tile does not
    matter (q8f or q8s). x: (B, T, C); returns (B, T, C) in x's dtype."""
    T = x.shape[1]
    xp = F.pad(x.float(), (0, 0) + (max(
        chain_halo(k, d) for k, d in zip(mrf.kernel_sizes,
                                         mrf.dilations)),) * 2)
    acc = None
    with full_f32():
        for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
            y = _chain_q8(xp, mrf.chains[j], k, dils)
            extra = (y.shape[1] - T) // 2
            y = y[:, extra:extra + T]
            acc = y if acc is None else acc + y
    return (acc * (1.0 / len(mrf.kernel_sizes))).to(x.dtype)


def ptc_amax(x, p_in, tile, halo_in):
    """Per (utterance, tile) amax of lrelu(x) over the tile's upsample
    input window, rows [t*tile - halo_in, (t+1)*tile + halo_in), zero
    outside the utterance, clamped at 1e-30. x: (B, rows*p_in, C_in);
    returns float32 (B * n_tiles,) and the lrelu'd windows."""
    B, T_in, C_in = x.shape
    W = (tile + 2 * halo_in) * p_in
    xin = F.pad(x.float(), (0, 0, halo_in * p_in, halo_in * p_in))
    win = _lrelu(xin.unfold(1, W, tile * p_in).transpose(2, 3)
                 .reshape(-1, W, C_in))
    return win.abs().amax(dim=(1, 2)).clamp(min=1e-30), win


# ----------------------------------------------------------------------
# int8-static CUDA launches
# ----------------------------------------------------------------------

Q8_TC_CHANNELS = (128, 256)

_AMAX_ARGTYPES = [_P, _I64] + [_I32] * 6 + [_P, _I32, _P]


def check_q8_input(name, x, mrf, channels, c, mode=None):
    """Raise unless x (bfloat16, C = ``c`` in ``channels``) and the int8
    weights ``mrf`` (of form ``mode``, any when None) can launch."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f'{name}: the int8 kernels take bfloat16 '
                         f'activations, not {x.dtype}')
    if c not in channels:
        raise ValueError(f'{name}: C={c} has no CUDA instantiation '
                         f'(built for {channels})')
    _check_kernel_sizes(name, mrf.kernel_sizes)
    if mode is not None and mrf.mode != mode:
        raise ValueError(f'{name}: the weights are the {mrf.mode} form, not '
                         f'{mode}')
    if x.device != mrf.device or (mrf.chains_dev is None
                                  and mrf.blk_dev is None):
        raise ValueError(f'{name}: x is on {x.device} but the weights were '
                         f'prepared on {mrf.device}')


# tc_chain_q8_kernel's geometry per C (mrf_tc_q8.cu TcCfg): output samples
# per block, taps and input channels per staged weight stage
TC_Q8_CFG = {128: (128, 1, 128), 256: (128, 1, 128)}
class Q8Stage(NamedTuple):
    """How the int8 block kernels stage one (C_in, C)'s weights (taps and
    input channels per ring stage; csrc ``DynCfg`` and ``PtcCfg``, which a
    test holds to this table)."""
    tps: int            # chain convs: taps per staged weight stage
    kch: int            # chain convs: input channels per stage
    utps: int           # the upsample's taps per stage
    ukch: int           # the upsample's input channels per stage


# per (C_in, C); C_in == C without upsample (the upsample's entries repeat
# the chains'). The dynamic engine and ptc_fused_q8_kernel stage a (C_in,
# C) alike, and a width's chain convs alike at every C_in, so one staged
# form serves every int8 block kernel of a level and of its fallback.
Q8_STAGES = {(256, 256): Q8Stage(1, 128, 1, 128),
             (128, 128): Q8Stage(1, 128, 1, 128),
             (128, 64): Q8Stage(4, 64, 2, 128),
             (64, 32): Q8Stage(8, 32, 2, 64),
             (64, 64): Q8Stage(4, 64, 4, 64),
             (32, 32): Q8Stage(8, 32, 8, 32)}
# ptc_fused_q8_kernel's output samples per block (mrf_ptc_fused.cuh
# PtcCfg BM): per upsample (C_in, C), and per C without its prologue (the
# static ct levels and the static phase kernel without prologue)
PTC_Q8_BM = {(128, 64): 128, (64, 32): 256}
PTC_Q8_NOUPS_BM = {64: 136, 32: 392}


class DynBlkCfg(NamedTuple):
    """The segment-synchronised dynamic engine's geometry for one (C_in, C)
    (csrc/mrf_dyn_blk.cuh ``DynCfg``; a test holds the two together; its
    stages are :data:`Q8_STAGES`')."""
    wrows: int          # the most rows a block holds (owned plus halos)
    rows_pass: int      # rows of one MMA pass (``Conv::ROWS``)
    r_smem: bool        # R in shared memory, else in a global scratch slice


# per (C_in, C); C_in == C without upsample (mrf_int8.fused_mrf_ct_q8 and,
# at C = 64/32, fused_mrf_phase_q8_noups), else a narrow level's
# (mrf_int8.fused_mrf_phase_q8 and fused_mrf_ptc dynamic)
DYN_BLK_CFG = {(256, 256): DynBlkCfg(256, 128, False),
               (128, 128): DynBlkCfg(248, 256, True),
               (128, 64): DynBlkCfg(256, 256, True),
               (64, 32): DynBlkCfg(512, 512, True),
               (64, 64): DynBlkCfg(256, 256, True),
               (32, 32): DynBlkCfg(512, 512, True)}
_TC_Q8_ARGTYPES = ([_P, _I64, _I32, _P, _I64, _P, _I64, _I32, _I32, _F32,
                    _P, _P] + [_I32] * 7 + [_P, _I64, _I32, _P])


@dataclass
class TcChainLaunch:
    """One launch of ``tc_chain_q8_kernel``: chain ``weights`` (per step)
    of an MRF group over blocks of ``block_m`` output samples. Block i of
    utterance b reads x samples [i*block_m - halo, (i+1)*block_m + halo)
    (zero outside [0, T)), runs the chain's steps with valid convs on that
    window and, for samples n in [i*block_m, min((i+1)*block_m, T)), writes
    the chain into ``sum`` (WRITE), adds it there (ADD) or writes
    ((sum + chain) if has_acc else chain) * scale into ``out`` (FINAL)."""
    x: torch.Tensor
    sum: Optional[torch.Tensor]
    out: torch.Tensor
    mode: int
    has_acc: bool
    scale: float
    weights: list
    k: int
    dils: tuple
    halo: int
    block_m: int
    n_blocks: int


def _tc_q8_plan(x, chains, kernel_sizes, dilations, alloc, block_m=None):
    """Launch plan of :func:`fused_mrf_tc_q8`: (launches, out), one launch
    per chain; ``block_m`` defaults to the kernel's for x's C."""
    B, T, C = x.shape
    bm = block_m or TC_Q8_CFG[C][0]
    nb = len(kernel_sizes)
    acc = alloc((B, T, C), torch.float32) if nb > 1 else None
    out = alloc((B, T, C), x.dtype)
    launches = []
    for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        mode = FINAL if j == nb - 1 else (WRITE if j == 0 else ADD)
        launches.append(TcChainLaunch(x, acc, out, mode, j > 0, 1.0 / nb,
                                      chains[j], k, tuple(dils),
                                      chain_halo(k, dils), bm, -(-T // bm)))
    return launches, out


def sm_count(device):
    """Streaming multiprocessors of ``device``: the persistent kernels' grid
    (one block per SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(x):
    """x, copied if its data is not 16-byte aligned (the kernels read rows
    with 16-byte loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fused_mrf_tc_q8(x, mrf):
    """Fused MRF group of a wide level, int8-static (``fused_mrf_tc`` with
    ``q8=True``). x: (B, T, C) bfloat16; ``mrf`` from
    :func:`prepare_mrf_tc_q8`. Returns (B, T, C) in x's dtype. On a CUDA
    tensor this launches ``mrf_tc_q8.cu`` (or raises); on a CPU tensor it
    runs :func:`mrf_tc_q8_plain`.

    ``fused_mrf_tc_q8.launches`` counts CUDA launches (one per chain);
    ``fused_mrf_tc_q8.calls`` counts CUDA-route calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_tc_q8_plain(x, mrf)
    B, T, C = x.shape
    check_q8_input('fused_mrf_tc_q8', x, mrf, Q8_TC_CHANNELS, C, 'q8f')
    x = aligned(x)
    launches, out = _tc_q8_plan(x, mrf.chains_dev, mrf.kernel_sizes,
                                mrf.dilations, _empty_on(x.device))
    bm, tps, kch = TC_Q8_CFG[C]
    slots = sm_count(x.device)
    # C = 256 keeps each block's residual window in a global scratch slice
    per = 0 if C <= 128 else (bm + 2 * max(st.halo for st in launches)) \
        * (C + 8)
    scratch = torch.empty(max(per * slots, 1), dtype=torch.float32,
                          device=x.device)
    fn = _fn('mrf_tc_q8', 'mrf_tc_q8_chain', _TC_Q8_ARGTYPES)
    stream = _build.stream_ptr(x)
    for st in launches:
        wp = (ctypes.c_int64 * (7 * len(st.dils)))(
            *(t.data_ptr() for w in st.weights for t in w))
        dl = (ctypes.c_int * len(st.dils))(*st.dils)
        acc = st.sum if st.sum is not None else st.out
        err = fn(_build.ptr(x), x.stride(0), T, _build.ptr(acc),
                 acc.stride(0), _build.ptr(st.out), st.out.stride(0),
                 st.mode, int(st.has_acc), st.scale,
                 ctypes.cast(wp, ctypes.c_void_p),
                 ctypes.cast(dl, ctypes.c_void_p), len(st.dils), st.k, C, B,
                 bm, tps, kch, _build.ptr(scratch), scratch.numel(), slots,
                 stream)
        _build.check(err, f'MRF q8 chain (C={C}, k={st.k})')
        fused_mrf_tc_q8.launches += 1
    fused_mrf_tc_q8.calls[tuple(x.shape)] += 1
    return out


fused_mrf_tc_q8.launches = 0
fused_mrf_tc_q8.calls = collections.Counter()

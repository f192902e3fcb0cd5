"""HiFi-GAN MRF kernels: the CUDA kernels ``csrc/mrf_tc.cu`` and
``csrc/mrf_phase.cu``, their plain PyTorch versions and their wrappers.

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

Both wrappers take one level's weights as :class:`MrfWeights`, made once by
:func:`prepare_mrf` (the plain layout and the kernels' layout side by side).
Both CUDA routes run one launch per (chain, dilation) step
(``mrf_common.cuh::step_kernel``); the sample ranges of every launch are
planned here (:func:`_chain_steps`) so the CPU tests can replay the plan.
HBM traffic per group on the card: each step reads its float32 input and
writes its float32 output over the (B, T + 2E, C) buffers, ~9 float32
read+write passes for V1, against 252*B*T*C^2 FLOPs.
"""
import collections
import contextlib
import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import _build

LRELU_SLOPE = 0.1
TC_CHANNELS = (128, 256)
PHASE_CHANNELS = (32, 64)
PHASE_UPS = ((128, 64), (64, 32))     # (C_in, C_out) of the fused upsample
KERNEL_SIZES = (3, 7, 11)

WRITE, ADD, FINAL = 0, 1, 2           # step modes (mrf_common.cuh StepMode)


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


def _ups_extended(x, w, b, stride, padding, ext, cdt):
    """lrelu(x) zero-extended -> ConvTranspose1d, evaluated at samples
    [-ext, stride*T + ext) (bias beyond the transposed conv's support),
    rounded to ``cdt``; returned as float32 (B, C_out, N + 2*ext)."""
    B, _, T_in = x.shape
    N = stride * T_in
    xin = _lrelu(x.float()).to(cdt).float()
    y = F.conv_transpose1d(xin, w.float(), stride=stride)
    lo = ext - padding                      # y[:, :, i] is sample i - padding
    if lo < 0 or lo + y.shape[2] > N + 2 * ext:
        raise ValueError('upsample extension smaller than its padding')
    x0 = y.new_zeros(B, w.shape[1], N + 2 * ext)
    x0[:, :, lo:lo + y.shape[2]] = y
    return (x0 + b.float()[:, None]).to(cdt).float()


def _phase_ext(kernel_sizes, dilations, post_k):
    return (max(chain_halo(k, d) for k, d in zip(kernel_sizes, dilations))
            + (post_k - 1) // 2)


def mrf_phase_plain(x, weights, kernel_sizes, dilations, ups, post=None):
    """The plain version of :func:`fused_mrf_phase`."""
    cdt = x.dtype
    w_u, b_u, stride, padding = ups
    post_k = post[0].shape[-1] if post is not None else 1
    P = (post_k - 1) // 2
    E = _phase_ext(kernel_sizes, dilations, post_k)
    N = stride * x.shape[2]
    acc = None
    with full_f32():
        x0 = _ups_extended(x, w_u, b_u, stride, padding, E, cdt)
        for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
            w1, b1, w2, b2 = weights[4 * j:4 * j + 4]
            h = chain_halo(k, dils)
            win = x0[:, :, E - h - P:E + N + h + P]
            y = _chain_plain(win, w1, b1, w2, b2, k, dils, cdt)
            acc = y if acc is None else acc + y
        mean = acc * (1.0 / len(kernel_sizes))       # samples [-P, N + P)
        if post is None:
            return mean.to(cdt)
        t = _lrelu(mean).to(cdt).float()
        y = F.conv1d(t, post[0].to(cdt).float()) + post[1].float()[:, None]
    return torch.tanh(y).to(cdt)


# ----------------------------------------------------------------------
# launch plan (shared by the CUDA route and the CPU replay in the tests)
# ----------------------------------------------------------------------

@dataclass
class Step:
    """One launch of ``step_kernel``. Sample n of utterance b lives at
    ``src[b, n + src_off]`` (zero outside [src_lo, src_hi)) and
    ``dst[b, n + dst_off]``; the launch computes samples [n_lo, n_hi).
    ``fin`` is a (B, N, C)-indexed view of the final output (FINAL mode)."""
    src: torch.Tensor
    src_off: int
    src_lo: int
    src_hi: int
    dst: torch.Tensor
    dst_off: int
    mode: int
    has_acc: bool
    scale: float
    fin: Optional[torch.Tensor]
    weights: tuple            # (w1, b1, w2, b2) of this (chain, dilation)
    k: int
    d: int
    n_lo: int
    n_hi: int


def _chain_steps(x0, x0_off, x0_lo, x0_hi, prep, kernel_sizes, dilations, N,
                 P, bufs, E, fin):
    """The launches of one MRF group. ``x0``: the chains' shared input;
    ``prep[j][i]``: the weights of chain j, dilation i; ``bufs``: three
    float32 (B, N + 2E, C) buffers (two step ping-pong buffers and the
    chain sum), sample n at index n + E. Each chain's last step covers
    [-P, N + P) (P: conv_post's reach); ``fin`` given, the last chain's
    last step writes the mean there, else the chain sum stays in bufs[2]."""
    steps = []
    nb = len(kernel_sizes)
    for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        half = (k - 1) // 2
        reach = [d * half + half for d in dils]
        src, off, lo, hi = x0, x0_off, x0_lo, x0_hi
        for i, d in enumerate(dils):
            after = sum(reach[i + 1:]) + P
            n_lo, n_hi = -after, N + after
            last = i == len(dils) - 1
            has_acc = False
            if not last:
                dst, mode = bufs[i % 2], WRITE
            elif fin is not None and j == nb - 1:
                dst, mode, has_acc = bufs[2], FINAL, j > 0
            else:
                dst, mode = bufs[2], (WRITE if j == 0 else ADD)
            steps.append(Step(src, off, lo, hi, dst, E, mode, has_acc,
                              1.0 / nb, fin if mode == FINAL else None,
                              prep[j][i], k, d, n_lo, n_hi))
            src, off, lo, hi = dst, E, n_lo, n_hi
    return steps


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

def pack_mma(w_kio):
    """(taps, C_in, C_out) -> bfloat16 words in the m16n8k16 B-fragment
    order ``conv_gemm`` reads: [tap][n-tile][k-tile][lane][4]."""
    taps, ci, co = w_kio.shape
    w = w_kio.to(torch.bfloat16).reshape(taps, ci // 16, 2, 4, 2, co // 8, 8)
    return w.permute(0, 5, 1, 6, 3, 2, 4).contiguous().reshape(-1)


def _device_taps(w_kio, cdt):
    if cdt == torch.bfloat16:
        return pack_mma(w_kio)
    return w_kio.float().contiguous().reshape(-1)


@dataclass
class MrfWeights:
    """One level's weights for the MRF wrappers, made once by
    :func:`prepare_mrf`. The plain versions read ``packed`` (from
    :func:`pack_mrf_tc_weights`), ``ups`` and ``post``. For weights on a
    CUDA device the CUDA routes read the same weights in the kernels'
    format for ``dtype`` (None on the CPU): ``chains[j][i]`` = (w1, b1, w2,
    b2) of chain j, dilation i, ``ups_dev`` = (per-phase taps, float32
    bias) and ``post_dev`` = ((k, C) float32 taps, bias)."""
    dtype: torch.dtype
    device: torch.device
    kernel_sizes: tuple
    dilations: tuple
    packed: list
    chains: Optional[list] = None
    ups: Optional[tuple] = None       # (w (C_in, C, k), b (C,), stride, pad)
    ups_dev: Optional[tuple] = None
    post: Optional[tuple] = None      # (w (1, C, k), b (1,))
    post_dev: Optional[tuple] = None


def prepare_mrf(packed, kernel_sizes, dilations, ups=None, post=None):
    """:class:`MrfWeights` of one level, in the dtype and on the device of
    ``packed``. ``ups`` = (w, b, stride, padding) of the level's
    ConvTranspose1d and ``post`` = (w, b) of conv_post, for
    :func:`fused_mrf_phase`."""
    cdt, device = packed[0].dtype, packed[0].device
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    mrf = MrfWeights(cdt, device, kernel_sizes, dilations, list(packed),
                     ups=ups, post=post)
    if device.type != 'cuda':
        return mrf
    mrf.chains = []
    for j, dils in enumerate(dilations):
        w1, b1, w2, b2 = packed[4 * j:4 * j + 4]
        mrf.chains.append([(_device_taps(w1[i], cdt),
                            b1[i].float().contiguous(),
                            _device_taps(w2[i], cdt),
                            b2[i].float().contiguous())
                           for i in range(len(dils))])
    if ups is not None:
        w, b, stride, padding = ups
        _, _, _, _, taps = ups_geometry(w.shape[-1], stride, padding)
        mrf.ups_dev = (torch.cat([_device_taps(torch.stack(
            [w[:, :, j] for j in tp]), cdt) for tp in taps]),
            b.float().contiguous())
    if post is not None:
        w, b = post
        mrf.post_dev = (w.to(cdt).float()[0].transpose(0, 1).contiguous(),
                        float(b.float()[0]))
    return mrf


# ----------------------------------------------------------------------
# CUDA launches
# ----------------------------------------------------------------------

_I64, _I32, _F32, _P = ctypes.c_int64, ctypes.c_int, ctypes.c_float, \
    ctypes.c_void_p
_STEP_ARGTYPES = ([_P, _I64, _I32, _I32, _I32, _I32, _P, _I64, _I32, _P,
                   _I64, _I64, _I64, _I32, _I32, _F32, _P, _P, _P, _P]
                  + [_I32] * 7 + [_P])


def _fn(lib, name, argtypes):
    f = getattr(_build.library(lib), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _launch_step(fn, st, B, C, cdt):
    fs = st.fin.stride() if st.fin is not None else (0, 0, 0)
    w1, b1, w2, b2 = st.weights
    err = fn(_build.ptr(st.src), st.src.stride(0), st.src_off, st.src_lo,
             st.src_hi, int(st.src.dtype == torch.float32),
             _build.ptr(st.dst), st.dst.stride(0), st.dst_off,
             _build.ptr(st.fin) if st.fin is not None else None,
             fs[0], fs[1], fs[2], st.mode, int(st.has_acc), st.scale,
             _build.ptr(w1), _build.ptr(b1), _build.ptr(w2), _build.ptr(b2),
             C, st.k, st.d, st.n_lo, st.n_hi, B,
             int(cdt == torch.bfloat16), _build.stream_ptr(st.dst))
    _build.check(err, f'MRF step (C={C}, k={st.k}, d={st.d})')


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


def _tc_plan(x, prep, kernel_sizes, dilations, alloc):
    """Launch plan of :func:`fused_mrf_tc`: (steps, out). ``alloc(shape,
    dtype)`` makes the buffers (``torch.empty`` on the card)."""
    B, T, C = x.shape
    E = -(-max(chain_halo(k, d) for k, d in zip(kernel_sizes, dilations))
          // 8) * 8
    bufs = alloc((3, B, T + 2 * E, C), torch.float32)
    out = alloc((B, T, C), x.dtype)
    return _chain_steps(x, 0, 0, T, prep, kernel_sizes, dilations, T, 0,
                        bufs, E, out), out


def _check_weights(name, x, mrf):
    if x.dtype != mrf.dtype or x.device != mrf.device:
        raise ValueError(f'{name}: x is {x.dtype} on {x.device} but the '
                         f'weights were prepared as {mrf.dtype} on '
                         f'{mrf.device}')


def fused_mrf_tc(x, mrf):
    """Fused MRF group of a wide level. x: (B, T, C) in bfloat16 or float32;
    ``mrf`` from :func:`prepare_mrf` in x's dtype. Returns (B, T, C) in x's
    dtype. On a CUDA tensor this launches ``mrf_tc.cu`` (or raises); on a
    CPU tensor it runs :func:`mrf_tc_plain`.

    ``fused_mrf_tc.launches`` counts CUDA launches (one per chain step);
    ``fused_mrf_tc.calls`` counts CUDA-route calls by x's shape."""
    if x.device.type == 'cpu':
        return mrf_tc_plain(x, mrf.packed, mrf.kernel_sizes, mrf.dilations)
    B, T, C = x.shape
    _check_cuda_input(x, 'fused_mrf_tc', TC_CHANNELS, C)
    _check_kernel_sizes('fused_mrf_tc', mrf.kernel_sizes)
    _check_weights('fused_mrf_tc', x, mrf)
    x = x.contiguous()
    steps, out = _tc_plan(x, mrf.chains, mrf.kernel_sizes, mrf.dilations,
                          _empty_on(x.device))
    fn = _fn('mrf_tc', 'mrf_tc_step', _STEP_ARGTYPES)
    for st in steps:
        _launch_step(fn, st, B, C, x.dtype)
        fused_mrf_tc.launches += 1
    fused_mrf_tc.calls[tuple(x.shape)] += 1
    return out


fused_mrf_tc.launches = 0
fused_mrf_tc.calls = collections.Counter()


def _empty_on(device):
    return lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device)


@dataclass
class Upsample:
    """The launch of ``ups_kernel``: X0[b, n + out_off] for samples
    n = stride*m + r in [n_lo, n_hi), m in [m_lo, m_hi); phase r sums taps
    t < ntaps of lrelu(x) at input m + amin + rows[r] + t."""
    x: torch.Tensor
    out: torch.Tensor
    out_off: int
    weights: tuple
    stride: int
    ntaps: int
    amin: int
    rows: list
    span: int
    m_lo: int
    m_hi: int
    n_lo: int
    n_hi: int


@dataclass
class Post:
    """The launch of ``post_kernel``: out[b, 0, n] for n in [0, N) from the
    chain sum ``src`` (sample n at n + src_off) times ``scale``."""
    src: torch.Tensor
    src_off: int
    scale: float
    weights: tuple
    k: int
    out: torch.Tensor


def _phase_plan(x, prep, ups_prep, kernel_sizes, dilations, ups, post,
                post_prep, alloc):
    """Launch plan of :func:`fused_mrf_phase`: (upsample, steps, post or
    None, out)."""
    w_u, _, stride, padding = ups
    B, _, T_in = x.shape
    C = w_u.shape[1]
    ntaps, amin, rows, span, _ = ups_geometry(w_u.shape[-1], stride, padding)
    post_k = post[0].shape[-1] if post is not None else 1
    E = -(-_phase_ext(kernel_sizes, dilations, post_k) // 16) * 16
    if E % stride or E < padding:
        raise ValueError(f'fused_mrf_phase: stride {stride} must divide '
                         f'the extension {E}')
    N = stride * T_in
    x0 = alloc((B, N + 2 * E, C), x.dtype)
    upsample = Upsample(x, x0, E, ups_prep, stride, ntaps, amin, rows, span,
                        -(E // stride), T_in + E // stride, -E, N + E)
    bufs = alloc((3, B, N + 2 * E, C), torch.float32)
    if post is None:
        out = alloc((B, C, N), x.dtype)
        fin = out.transpose(1, 2)
    else:
        out = alloc((B, 1, N), x.dtype)
        fin = None
    steps = _chain_steps(x0, E, -E, N + E, prep, kernel_sizes, dilations, N,
                         (post_k - 1) // 2, bufs, E, fin)
    tail = None if post is None else Post(bufs[2], E, 1.0 / len(kernel_sizes),
                                          post_prep, post_k, out)
    return upsample, steps, tail, out


_UPS_ARGTYPES = ([_P, _I64, _I64, _I64, _I32, _P, _I64, _I32, _P, _P]
                 + [_I32] * 4 + [_P] + [_I32] * 8 + [_P])
_POST_ARGTYPES = [_P, _I64, _I32, _I32, _F32, _P, _F32, _I32, _P, _I32,
                  _I32, _I32, _P]


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

    ``fused_mrf_phase.launches`` counts CUDA launches (the upsample, one
    per chain step, conv_post); ``fused_mrf_phase.calls`` counts
    CUDA-route calls by x's shape."""
    if mrf.ups is None:
        raise ValueError('fused_mrf_phase: the weights carry no upsample')
    if x.device.type == 'cpu':
        return mrf_phase_plain(x, mrf.packed, mrf.kernel_sizes,
                               mrf.dilations, mrf.ups, mrf.post)
    w_u, _, stride, _ = mrf.ups
    B, C_in, T_in = x.shape
    C = w_u.shape[1]
    cdt = x.dtype
    _check_cuda_input(x, 'fused_mrf_phase', PHASE_CHANNELS, C)
    _check_kernel_sizes('fused_mrf_phase', mrf.kernel_sizes)
    _check_weights('fused_mrf_phase', x, mrf)
    if (C_in, C) not in PHASE_UPS:
        raise ValueError(f'fused_mrf_phase: upsample {C_in}->{C} has no '
                         f'CUDA instantiation (built for {PHASE_UPS})')
    up, steps, tail, out = _phase_plan(
        x, mrf.chains, mrf.ups_dev, mrf.kernel_sizes, mrf.dilations, mrf.ups,
        mrf.post, mrf.post_dev, _empty_on(x.device))
    stream = _build.stream_ptr(x)
    bf = int(cdt == torch.bfloat16)
    w_p, b_p = up.weights
    err = _fn('mrf_phase', 'mrf_phase_ups', _UPS_ARGTYPES)(
        _build.ptr(x), x.stride(0), x.stride(1), x.stride(2), T_in,
        _build.ptr(up.out), up.out.stride(0), up.out_off, _build.ptr(w_p),
        _build.ptr(b_p), stride, up.ntaps, up.amin, up.span,
        ctypes.cast((ctypes.c_int * stride)(*up.rows), ctypes.c_void_p),
        up.m_lo, up.m_hi, up.n_lo, up.n_hi, C_in, C, B, bf, stream)
    _build.check(err, 'MRF upsample')
    fused_mrf_phase.launches += 1
    fn = _fn('mrf_phase', 'mrf_phase_step', _STEP_ARGTYPES)
    for st in steps:
        _launch_step(fn, st, B, C, cdt)
        fused_mrf_phase.launches += 1
    if tail is not None:
        w_t, b_t = tail.weights
        err = _fn('mrf_phase', 'mrf_phase_post', _POST_ARGTYPES)(
            _build.ptr(tail.src), tail.src.stride(0), tail.src_off, C,
            tail.scale, _build.ptr(w_t), b_t, tail.k, _build.ptr(out),
            stride * T_in, B, bf, stream)
        _build.check(err, 'MRF conv_post')
        fused_mrf_phase.launches += 1
    fused_mrf_phase.calls[tuple(x.shape)] += 1
    return out


fused_mrf_phase.launches = 0
fused_mrf_phase.calls = collections.Counter()

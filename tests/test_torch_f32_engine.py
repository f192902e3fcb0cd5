"""The float32 chain kernels (daft_exprt_torch/ops/csrc/mrf_chain_f32.cuh:
``tc_f32_kernel``, for the float32 ``fused_mrf_tc`` and ``fused_resblock1``,
and ``phase_f32_kernel``, for the float32 ``fused_mrf_phase``) and
``fused_resblock1`` in bf16 (the bf16 engine's group of one chain), their
launch plans replayed on the CPU block by block.

- Each block's window is emulated as the kernel computes it (its own x
  rows, zero outside the utterance), then the chain by valid convs on it;
  in float32 each conv with the kernel's arithmetic: every product as three
  TF32 products of split halves (x_hi = tf32(x), x_lo = tf32(x - x_hi)),
  small terms first, each weight stage (one tap, ``kch`` input channels) in
  a fresh accumulator added to the conv's sum in stage order. The replays
  must agree with the plain versions at the float32 band (rel-L2 1e-5),
  and with JAX's ``fused_resblock1`` and ``fused_mrf_phase`` in interpret
  mode; with one TF32 product per product (hi.hi) the replay misses the
  band, so the test can tell the two apart. The phase kernel's blocks also
  run the upsample (one ConvF32 of C_in channels per phase, stages of
  ``PHASE_F32_UKCH`` channels) on their own x window.
- Every output sample is written by exactly one block; the buffers start
  as NaN.
- ``pack_stage_tf32`` matches the kernel's indexing, ``TC_F32_CFG`` and
  ``PHASE_F32_UKCH`` the kernels' configurations, and ``_tc_f32_smem`` /
  ``_phase_f32_smem``, which pick block_m, the kernels' own layout code
  (compiled for the host with g++ and the declarations in
  ``tests/cuda_host``).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_bf16_engine import (
    CSRC, _kernel_layouts, _nan_alloc, _phase_case, _replay_tc,
)
from tests.torch_port_utils import (
    max_abs, mm_tf32, one_torch_thread, rel_l2, tf32,
)

BAND = 1e-5
KS = (3, 7, 11)
DILS = (1, 3, 5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


def _weights(rng, C, ks, dtype=torch.float32):
    """Packed chains (w1, b1, w2, b2 per chain) with unit-gain convs, so the
    branches, not the residual, carry the checked values."""
    out = []
    for k in ks:
        for _ in range(2):
            w = rng.randn(len(DILS), k, C, C) * (C * k) ** -0.5
            out.append(torch.from_numpy(w.astype(np.float32)))
            out.append(torch.from_numpy((rng.randn(len(DILS), C) * 0.05
                                         ).astype(np.float32)))
    return [t.to(dtype) for t in out]


def _conv(t, w, d, kch, terms):
    """Valid conv of (N, C_in, L) with (k, C_in, C_out) as the kernel sums
    it: K = k*C_in in tap-major order, stages of ``kch``."""
    k, ci, co = w.shape
    M = t.shape[2] - (k - 1) * d
    a = torch.cat([t[:, :, i * d:i * d + M] for i in range(k)], 1)
    return mm_tf32(a.transpose(1, 2), w.reshape(k * ci, co), terms,
                   kch).transpose(1, 2)


def _chain_tf32(cur, steps, k, dils, kch, terms):
    """One chain on float32 windows (N, C, L) in the kernel's arithmetic."""
    half = (k - 1) // 2
    for (w1, b1, w2, b2), d in zip(steps, dils):
        a = _conv(vk._lrelu(cur), w1, d, kch, terms) + b1[:, None]
        a2 = _conv(vk._lrelu(a), w2, 1, kch, terms) + b2[:, None]
        sh = d * half + half
        cur = cur[:, :, sh:cur.shape[2] - sh] + a2
    return cur


def _replay_f32(launches, x, weights, terms=3):
    """What the ``tc_f32_kernel`` launches compute: every block's window
    from x (zero outside the utterance), all blocks of a launch at once;
    returns the output and how often each launch wrote each sample."""
    B, T, C = x.shape
    kch = vk.TC_F32_CFG[C].kch
    xc = x.transpose(1, 2)
    writes = []
    for j, st in enumerate(launches):
        steps = [tuple(t[i] for t in weights[4 * j:4 * j + 4])
                 for i in range(len(st.dils))]
        s = (torch.arange(st.n_blocks)[:, None] * st.block_m
             + torch.arange(-st.halo, st.block_m + st.halo)[None, :])
        ok = (s >= 0) & (s < T)
        win = torch.where(ok[None, None], xc[:, :, s.clamp(0, T - 1)],
                          torch.zeros(()))            # (B, C, n_blocks, W)
        win = win.permute(0, 2, 1, 3).reshape(B * st.n_blocks, C, -1)
        y = _chain_tf32(win, steps, st.k, st.dils, kch, terms)
        y = y.reshape(B, st.n_blocks, C, st.block_m).permute(0, 1, 3, 2)
        y = y.reshape(B, -1, C)
        seen = torch.zeros(B, T, dtype=torch.int64)
        for i in range(st.n_blocks):
            n0, n1 = i * st.block_m, min((i + 1) * st.block_m, T)
            seen[:, n0:n1] += 1
            yb = y[:, n0:n1]
            if st.mode == vk.WRITE:
                st.sum[:, n0:n1] = yb
                continue
            tot = None
            for a in range(st.n_acc):
                e = st.sum[a, :, n0:n1]
                tot = e if tot is None else tot + e
            tot = yb if tot is None else tot + yb
            st.out[:, n0:n1] = tot * st.scale
        writes.append(seen)
    return launches[-1].out, writes


def _case(C, B, T, ks, seed):
    rng = np.random.RandomState(seed)
    w = _weights(rng, C, ks)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32))
    return w, x


@pytest.mark.parametrize('C,B,T,ks,slots', [
    # fused_resblock1: one chain, three blocks
    (128, 1, 600, (11,), 132),
    # two utterances of two blocks over three resident blocks
    (256, 2, 200, (7,), 3),
    # the float32 fused_mrf_tc group: two WRITE chains and a FINAL one
    (256, 1, 150, KS, 132),
    # the utterance shorter than the halo
    (128, 1, 40, KS, 132),
])
def test_tc_f32_plan_replays_plain(C, B, T, ks, slots):
    w, x = _case(C, B, T, ks, C + T)
    dils = (DILS,) * len(ks)
    launches, out, scratch = vk._tc_f32_plan(x, [None] * len(ks), ks, dils,
                                             _nan_alloc, slots)
    nb = len(ks)
    assert [st.mode for st in launches] == [vk.WRITE] * (nb - 1) + [vk.FINAL]
    assert launches[-1].n_acc == nb - 1 and launches[-1].scale == 1.0 / nb
    assert not any(st.r_smem for st in launches)
    # every residual window in the scratch: C floats a row, a slice per
    # resident block
    assert scratch == max((st.block_m + 2 * st.halo) * C
                          * min(B * st.n_blocks, slots) for st in launches)
    out, writes = _replay_f32(launches, x, w)
    assert all(bool((n == 1).all()) for n in writes)
    if T >= 200:
        assert max(st.n_blocks for st in launches) > 1
    ref = vk.mrf_tc_plain(x, w, ks, dils)
    assert torch.isfinite(out).all()
    assert rel_l2(out, ref) <= BAND
    assert max_abs(out, x) > 0.05        # the branches carry the values


@pytest.mark.parametrize('k', [3, 11])
def test_tc_f32_replay_matches_jax_resblock1(k):
    """The float32 kernel's plan and arithmetic for fused_resblock1 against
    JAX's Pallas kernel in interpret mode (two utterances of two tiles)."""
    C, T, tile = 128, 256, 128
    w, x = _case(C, 2, T, (k,), k)
    ref = np.asarray(jvk.fused_resblock1(
        jnp.asarray(x.numpy()), *(jnp.asarray(t.numpy()) for t in w),
        kernel_size=k, dilations=DILS, tile=tile, interpret=True))
    launches, _, _ = vk._tc_f32_plan(x, [None], (k,), (DILS,), _nan_alloc,
                                     132)
    assert len(launches) == 1 and launches[0].sum is None
    out, _ = _replay_f32(launches, x, w)
    assert rel_l2(out.numpy(), ref) <= BAND
    assert rel_l2(vk.resblock1_plain(x, *w, k, DILS, tile).numpy(),
                  ref) <= BAND


def test_one_tf32_product_misses_the_band():
    """Three TF32 products per product are what holds the band: with hi.hi
    alone the same replay leaves it."""
    w, x = _case(128, 1, 256, (7,), 5)
    launches, _, _ = vk._tc_f32_plan(x, [None], (7,), (DILS,), _nan_alloc,
                                     132)
    ref = vk.resblock1_plain(x, *w, 7, DILS, 256)
    one, _ = _replay_f32(launches, x, w, terms=1)
    assert rel_l2(one, ref) > 10 * BAND


def _replay_phase_f32(pl, x, mrf, terms=3):
    """What the ``phase_f32_kernel`` launch computes, every block at once:
    its x window (lrelu, zero outside the utterance), the upsample per
    phase (acc + bias) over its window X0, each chain on its own window of
    X0, the chain sum times 1/3, then the (B, C, N) mean or lrelu ->
    conv_post -> tanh; each product in the kernel's arithmetic. Returns the
    output and how often each sample was written."""
    w_u, b_u, stride, padding = mrf.ups
    _, _, _, _, taps = vk.ups_geometry(w_u.shape[-1], stride, padding)
    B, C_in, T_in = x.shape
    C = w_u.shape[1]
    kch, ukch = vk.TC_F32_CFG[C].kch, vk.PHASE_F32_UKCH[C_in, C]
    nb, bm, hx, P = pl.n_blocks, pl.block_m, pl.hx, pl.P
    W = bm + 2 * hx
    mu = W // stride
    base = (torch.arange(nb) * bm - hx) // stride + pl.amin
    q = base[:, None] + torch.arange(mu + pl.span)[None, :]
    ok = (q >= 0) & (q < T_in)
    xq = torch.where(ok[None, None], x[:, :, q.clamp(0, T_in - 1)],
                     torch.zeros(()))            # (B, C_in, nb, rows)
    xq = vk._lrelu(xq).permute(0, 2, 1, 3).reshape(B * nb, C_in, -1)
    x0 = torch.empty(B * nb, C, W)
    for r in range(stride):
        wr = torch.stack([w_u[:, :, j] for j in taps[r]])
        y = _conv(xq[:, :, pl.rows[r]:pl.rows[r] + mu + pl.ntaps - 1], wr, 1,
                  ukch, terms)
        x0[:, :, r::stride] = y + b_u[:, None]
    acc = None
    for j, (k, dils) in enumerate(zip(mrf.kernel_sizes, mrf.dilations)):
        h = vk.chain_halo(k, dils)
        steps = [tuple(t[i] for t in mrf.packed[4 * j:4 * j + 4])
                 for i in range(len(dils))]
        y = _chain_tf32(x0[:, :, hx - h - P:hx + bm + h + P], steps, k, dils,
                        kch, terms)
        acc = y if acc is None else acc + y
    mean = acc * (1.0 / len(mrf.kernel_sizes))      # samples [n0 - P, ...)
    if pl.post is not None:
        mean = torch.tanh(F.conv1d(vk._lrelu(mean), pl.post[0])
                          + pl.post[1][:, None])
    y = mean.reshape(B, nb, -1, bm)
    seen = torch.zeros(B, pl.N, dtype=torch.int64)
    for i in range(nb):
        n0, n1 = i * bm, min((i + 1) * bm, pl.N)
        seen[:, n0:n1] += 1
        pl.out[:, :, n0:n1] = y[:, i, :, :n1 - n0]
    return pl.out, seen


@pytest.mark.parametrize('C_in,C,B,T_in,post,slots', [
    # V1 L2: two blocks per utterance, two utterances over three slots
    (128, 64, 2, 150, False, 3),
    # V1 L3 with conv_post, two blocks
    (64, 32, 1, 320, True, 132),
    # the utterance shorter than the halo
    (128, 64, 1, 20, False, 132),
    (64, 32, 1, 24, True, 132),
])
def test_phase_f32_plan_replays_plain(C_in, C, B, T_in, post, slots):
    """The float32 level's plan and arithmetic against ``mrf_phase_plain``
    in float32, from a transposed (B, T, C) input as the generator hands
    over, on NaN buffers: every output sample written once."""
    _, mrf, x = _phase_case(C_in, C, B, T_in, post, torch.float32)
    pl = vk._phase_f32_plan(x, mrf, _nan_alloc, slots)
    assert not pl.r_smem and pl.P == (3 if post else 0)
    assert pl.hx % pl.stride == 0 and pl.block_m % pl.stride == 0
    hmax = max(vk.chain_halo(k, d) for k, d in zip(KS, (DILS,) * 3))
    assert pl.hx >= hmax + pl.P
    # the residual window (the widest chain's) and the chain sum in the
    # scratch: C floats a row, a slice per resident block
    assert pl.scratch == (2 * pl.block_m + 2 * hmax + 4 * pl.P) * C * min(
        B * pl.n_blocks, slots)
    out, seen = _replay_phase_f32(pl, x, mrf)
    assert bool((seen == 1).all())
    if 2 * T_in > 256:
        assert pl.n_blocks > 1
    ref = vk.mrf_phase_plain(x, mrf.packed, KS, (DILS,) * 3, mrf.ups,
                             mrf.post)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert rel_l2(out, ref) <= BAND


def test_phase_f32_replay_matches_jax():
    """The float32 level's plan and arithmetic against JAX's Pallas kernel
    (``fused_mrf_phase`` with the upsample prologue and the conv_post
    epilogue, float32, interpret mode)."""
    from daft_exprt_tpu.models.hifigan import _pallas_mrf_phase
    C_in, C, T_in = 64, 32, 128
    params, mrf, x = _phase_case(C_in, C, 1, T_in, True, torch.float32, 2)
    pl = vk._phase_f32_plan(x, mrf, _nan_alloc, 132)
    out, _ = _replay_phase_f32(pl, x, mrf)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y, applied = _pallas_mrf_phase(
        jp, jvk.to_phase(jnp.asarray(x.numpy()), 2), 0,
        {'resblock_kernel_sizes': KS, 'resblock_dilation_sizes': (DILS,) * 3},
        4, post=jp['conv_post'], ups=dict(jp['ups_0'], stride=2, padding=1,
                                          p_in=2), interpret=True)
    assert applied
    ref = np.asarray(jvk.from_phase(y, 4))
    assert out.shape == ref.shape
    assert rel_l2(out.numpy(), ref) <= BAND


@pytest.mark.parametrize('C,T', [(128, 300), (256, 500)])
def test_resblock1_bf16_plan_replays_plain(C, T):
    """fused_resblock1 in bf16: the bf16 engine's plan as a group of one
    chain, a single FINAL launch with no chain buffers and scale 1."""
    w, x = _case(C, 1, T, (7,), C)
    w, x = [t.to(torch.bfloat16) for t in w], x.to(torch.bfloat16)
    launches, out, _ = vk._tc_bf_plan(x, [None], (7,), (DILS,), _nan_alloc,
                                      132)
    assert len(launches) == 1
    st = launches[0]
    assert (st.mode, st.n_acc, st.scale, st.sum) == (vk.FINAL, 0, 1.0, None)
    out, writes = _replay_tc(launches, x, w, torch.bfloat16)
    assert bool((writes[0] == 1).all()) and st.n_blocks > 1
    ref = vk.resblock1_plain(x, *w, 7, DILS, T)
    assert torch.isfinite(out.float()).all()
    assert rel_l2(out.float(), ref.float()) < 1e-2


@pytest.mark.parametrize('taps,kch,co', [(3, 16, 128), (11, 8, 256),
                                         (7, 16, 16)])
def test_pack_stage_tf32_matches_kernel_indexing(taps, kch, co):
    """Stage s = tap*KC + kc, k8 step ks, n-tile n8, lane 4g + t: the
    kernel reads the float4 at ((s*KS + ks)*(C_out/8) + n8)*32 + lane and
    takes (hi, lo) of input channel kc*kch + 8ks + t (words 0, 2) and + 4
    (words 1, 3), output channel 8*n8 + g. Every weight is applied once,
    split as tf32(w) + tf32(w - tf32(w))."""
    rng = np.random.RandomState(taps * kch)
    ci = 2 * kch
    w = torch.from_numpy(rng.randn(taps, ci, co).astype(np.float32))
    packed = vk.pack_stage_tf32(w, kch)
    KC, KS, N8 = ci // kch, kch // 8, co // 8
    assert packed.numel() == taps * ci * co * 2
    q = packed.reshape(taps * KC, KS, N8, 32, 4)
    hi = torch.full((taps, ci, co), float('nan'))
    lo = torch.full((taps, ci, co), float('nan'))
    for s in range(taps * KC):
        tap, kc = divmod(s, KC)
        for ks in range(KS):
            for lane in range(32):
                g, t = divmod(lane, 4)
                c = kc * kch + 8 * ks + t
                n = 8 * torch.arange(N8) + g
                f = q[s, ks, :, lane]
                hi[tap, c, n], hi[tap, c + 4, n] = f[:, 0], f[:, 1]
                lo[tap, c, n], lo[tap, c + 4, n] = f[:, 2], f[:, 3]
    assert torch.equal(hi, tf32(w)) and torch.equal(lo, tf32(w - tf32(w)))
    assert torch.equal(vk.tf32(w), tf32(w))
    assert ((w - hi - lo).abs() <= w.abs() * 2 ** -22).all()


def _cfg(name):
    src = (CSRC / 'mrf_chain_f32.cuh').read_text()
    body = re.search(r'struct %s \{(.*?)\};' % re.escape(name), src,
                     re.S).group(1)
    return {m[0]: int(m[1]) for m in re.findall(r'(\w+) = (\d+)', body)}


@pytest.mark.parametrize('C', sorted(vk.TC_F32_CFG))
def test_tc_f32_cfg_matches_kernel(C):
    """The chain geometry per width: the wide levels' (tc_f32_kernel) and
    the narrow levels' (phase_f32_kernel's chains)."""
    k = _cfg(f'TcF32Cfg<{C}>')
    cfg = vk.TC_F32_CFG[C]
    assert (cfg.nw, cfg.mt, cfg.nt, cfg.kch, cfg.nbuf) == (
        k['NW'], k['MT'], k['NT'], k['KCH'], k['NBUF'])
    assert set(vk.TC_F32_CFG) == set(vk.TC_CHANNELS) | set(vk.CT_CHANNELS)
    if C in vk.CT_CHANNELS:
        # a warp's 16*mt x 8*nt tile divides the pass, the stages the width
        assert C % (8 * cfg.nt) == 0 and C % cfg.kch == 0
        assert cfg.nw % (C // (8 * cfg.nt)) == 0
        return
    # the planned blocks fit the kernel's shared memory at V1's shapes
    T = {256: 8192, 128: 65536}[C]
    for kk in KS:
        bm = vk.tc_f32_block(C, kk, DILS, T)
        assert vk._tc_f32_smem(C, cfg, kk, DILS, bm) <= vk.SMEM_MAX
        assert vk._tc_f32_smem(C, cfg, kk, DILS, bm + 8) > vk.SMEM_MAX
        assert bm % 8 == 0 and bm >= 64


@pytest.mark.parametrize('C_in,C', sorted(vk.PHASE_F32_UKCH))
def test_phase_f32_cfg_matches_kernel(C_in, C):
    """phase_f32_kernel's upsample stages (``PhaseF32Cfg``), and its planned
    blocks at V1's narrow levels: the largest whose window fits."""
    assert _cfg(f'PhaseF32Cfg<{C_in}, {C}>')['UKCH'] == \
        vk.PHASE_F32_UKCH[C_in, C]
    assert set(vk.PHASE_F32_UKCH) == set(vk.PHASE_BF_CFG)
    P = 3 if C == 32 else 0          # conv_post at V1's last level
    hx, span = _phase_hx(P), vk.ups_geometry(4, 2, 1)[3]
    bm = vk._largest_block(2 * {64: 65536, 32: 131072}[C], 8, lambda b: (
        vk._phase_f32_smem(C_in, C, KS, (DILS,) * 3, 2, span, P, hx, b)
        is not None))
    assert (hx, bm) == {64: (60, 240), 32: (64, 616)}[C]


def _phase_hx(P, dils=(DILS,) * 3, stride=2):
    """The narrow level's block reach per side, rounded to the stride."""
    return -(-(max(vk.chain_halo(k, d) for k, d in zip(KS, dils)) + P)
             // stride) * stride


# The kernels' TcF32Layout / PhaseF32Layout, compiled for the host: one
# line in per case ("tc C k n d.. bm" or "ph C_in C n (k n d..)*n bm hx
# stride span P"), one out ("total fits"; a phase case also its scratch
# floats), then kSmemMax.
_LAYOUT_MAIN = r"""
#include <cstdio>
#include <cstring>
#include "mrf_chain_f32.cuh"
using namespace mrf::f32e;
static void steps(StepBf* st, int* n, int* k) {
  scanf("%d %d", k, n);
  for (int i = 0; i < *n; ++i) scanf("%d", &st[i].dil);
}
template <class L> static void put(const L& l) { printf("%zu %d\n", l.total, (int)l.fits); }
template <class L> static void put_ph(const L& l) {
  printf("%zu %d %zu\n", l.total, (int)l.fits, l.scratch);
}
int main() {
  char kind[4];
  while (scanf("%3s", kind) == 1) {
    if (!strcmp(kind, "tc")) {
      TcF32Params p = {};
      int C;
      scanf("%d", &C);
      steps(p.steps, &p.n_steps, &p.k);
      scanf("%d", &p.bm);
      if (C == 128) put(TcF32Layout<128>(p)); else put(TcF32Layout<256>(p));
    } else {
      PhaseF32Params p = {};
      int cin, C;
      scanf("%d %d %d", &cin, &C, &p.n_chains);
      for (int j = 0; j < p.n_chains; ++j) steps(p.steps[j], &p.n_steps[j], &p.k[j]);
      scanf("%d %d %d %d %d", &p.bm, &p.hx, &p.stride, &p.span, &p.P);
      if (cin == 128) put_ph(PhaseF32Layout<128, 64>(p)); else put_ph(PhaseF32Layout<64, 32>(p));
    }
  }
  printf("%d\n", kSmemMax);
}
"""


def test_f32_smem_layout_matches_kernel(tmp_path):
    """``_tc_f32_smem`` / ``_phase_f32_smem`` and the fit against the
    kernels' own layout code at the planned blocks of V1's levels, one
    8-sample step past them, and small and odd blocks, with 3 and 2
    dilations (and the phase kernel with and without conv_post); the phase
    plan's scratch per block against the layout's."""
    cases, lines = [], []
    for C, T in ((256, 8192), (128, 65536)):
        cfg = vk.TC_F32_CFG[C]
        for k in KS:
            for d in ((1, 3, 5), (1, 3)):
                bm0 = vk.tc_f32_block(C, k, d, T)
                for bm in (8, 64, 200, bm0, bm0 + 8):
                    cases.append(('tc', vk._tc_f32_smem(C, cfg, k, d, bm),
                                  None))
                    lines.append(f'tc {C} {k} {len(d)} '
                                 f'{" ".join(map(str, d))} {bm}')
    stride, span = 2, vk.ups_geometry(4, 2, 1)[3]
    for (C_in, C), T_in in (((128, 64), 65536), ((64, 32), 131072)):
        for P, dils in ((0, (DILS,) * 3), (3, (DILS,) * 3), (3, ((1, 3),) * 3)):
            hx = _phase_hx(P, dils)
            ch = ' '.join(f'{k} {len(d)} ' + ' '.join(map(str, d))
                          for k, d in zip(KS, dils))
            bm0 = vk._largest_block(2 * T_in, 8, lambda bm: vk._phase_f32_smem(
                C_in, C, KS, dils, stride, span, P, hx, bm) is not None)
            for bm in (8, 64, 200, bm0, bm0 + 8):
                h = max(vk.chain_halo(k, d) for k, d in zip(KS, dils))
                cases.append(('ph', vk._phase_f32_smem(
                    C_in, C, KS, dils, stride, span, P, hx, bm),
                    (2 * bm + 2 * h + 4 * P) * C))
                lines.append(f'ph {C_in} {C} 3 {ch} {bm} {hx} {stride} '
                             f'{span} {P}')
    got, smem_max = _kernel_layouts(lines, tmp_path, _LAYOUT_MAIN)
    assert smem_max == vk.SMEM_MAX
    for (kind, py, scratch), out, ln in zip(cases, got, lines):
        total, fits = out[:2]
        if kind == 'tc':
            assert (py, py <= vk.SMEM_MAX) == (total, bool(fits)), ln
        else:       # None: the launch refuses the block
            assert (py is not None) == bool(fits), ln
            assert py is None or py == total, ln
            assert out[2] == scratch, ln
    # both sides of the fit at every planned block
    assert all(got[i + 3][1] and not got[i + 4][1]
               for i in range(0, len(got), 5))

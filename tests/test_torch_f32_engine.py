"""The float32 chain kernel (daft_exprt_torch/ops/csrc/mrf_chain_f32.cuh:
``tc_f32_kernel``, for the float32 ``fused_mrf_tc`` and ``fused_resblock1``)
and ``fused_resblock1`` in bf16 (the bf16 engine's group of one chain),
their launch plans replayed on the CPU block by block.

- Each block's window is emulated as the kernel computes it (its own x
  rows, zero outside the utterance), then the chain by valid convs on it;
  in float32 each conv with the kernel's arithmetic: every product as three
  TF32 products of split halves (x_hi = tf32(x), x_lo = tf32(x - x_hi)),
  small terms first, each weight stage (one tap, ``kch`` input channels) in
  a fresh accumulator added to the conv's sum in stage order. The replays
  must agree with the plain versions at the float32 band (rel-L2 1e-5),
  and with JAX's ``fused_resblock1`` in interpret mode; with one TF32
  product per product (hi.hi) the replay misses the band, so the test can
  tell the two apart.
- Every output sample is written by exactly one block; the buffers start
  as NaN.
- ``pack_stage_tf32`` matches the kernel's indexing, ``TC_F32_CFG`` the
  kernel's configuration, and ``_tc_f32_smem``, which picks block_m, the
  kernel's own layout code (compiled for the host with g++ and the
  declarations in ``tests/cuda_host``).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_bf16_engine import (
    CSRC, _kernel_layouts, _nan_alloc, _replay_tc,
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
    k = _cfg(f'TcF32Cfg<{C}>')
    cfg = vk.TC_F32_CFG[C]
    assert (cfg.nw, cfg.mt, cfg.nt, cfg.kch, cfg.nbuf) == (
        k['NW'], k['MT'], k['NT'], k['KCH'], k['NBUF'])
    assert set(vk.TC_F32_CFG) == set(vk.TC_CHANNELS)
    # the planned blocks fit the kernel's shared memory at V1's shapes
    T = {256: 8192, 128: 65536}[C]
    for kk in KS:
        bm = vk.tc_f32_block(C, kk, DILS, T)
        assert vk._tc_f32_smem(C, cfg, kk, DILS, bm) <= vk.SMEM_MAX
        assert vk._tc_f32_smem(C, cfg, kk, DILS, bm + 8) > vk.SMEM_MAX
        assert bm % 8 == 0 and bm >= 64


# The kernel's TcF32Layout, compiled for the host: "C k n d.. bm" per line
# in, "total fits" per line out, then kSmemMax.
_LAYOUT_MAIN = r"""
#include <cstdio>
#include "mrf_chain_f32.cuh"
using namespace mrf::f32e;
int main() {
  int C;
  while (scanf("%d", &C) == 1) {
    TcF32Params p = {};
    scanf("%d %d", &p.k, &p.n_steps);
    for (int i = 0; i < p.n_steps; ++i) scanf("%d", &p.steps[i].dil);
    scanf("%d", &p.bm);
    if (C == 128) {
      const TcF32Layout<128> l(p);
      printf("%zu %d\n", l.total, (int)l.fits);
    } else {
      const TcF32Layout<256> l(p);
      printf("%zu %d\n", l.total, (int)l.fits);
    }
  }
  printf("%d\n", kSmemMax);
}
"""


def test_f32_smem_layout_matches_kernel(tmp_path):
    """``_tc_f32_smem`` and the fit against the kernel's own layout code at
    the planned blocks of V1's levels, one 8-sample step past them, and
    small and odd blocks, with 3 and 2 dilations."""
    cases, lines = [], []
    for C, T in ((256, 8192), (128, 65536)):
        cfg = vk.TC_F32_CFG[C]
        for k in KS:
            for d in ((1, 3, 5), (1, 3)):
                bm0 = vk.tc_f32_block(C, k, d, T)
                for bm in (8, 64, 200, bm0, bm0 + 8):
                    cases.append(vk._tc_f32_smem(C, cfg, k, d, bm))
                    lines.append(f'{C} {k} {len(d)} {" ".join(map(str, d))} '
                                 f'{bm}')
    got, smem_max = _kernel_layouts(lines, tmp_path, _LAYOUT_MAIN)
    assert smem_max == vk.SMEM_MAX
    for py, (total, fits), ln in zip(cases, got, lines):
        assert (py, py <= vk.SMEM_MAX) == (total, bool(fits)), ln
    assert all(got[i + 3][1] and not got[i + 4][1]
               for i in range(0, len(got), 5))

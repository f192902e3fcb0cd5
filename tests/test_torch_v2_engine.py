"""The level kernels of HiFi-GAN V2's float levels (daft_exprt_torch/ops/
csrc/mrf_ct.cuh: ``ct_kernel`` over the bf16 engine's chains, ``CtBf``, or
the 3xTF32 chains, ``CtF32``), one launch a level behind ``fused_mrf_ct`` and
``fused_mrf_phase_noups``, replayed on the CPU block by block.

- Each block's window is emulated as the kernel computes it: per chain its
  own x rows, zero outside the utterance, the chain's steps by valid convs
  (bf16: each conv input rounded to bf16; float32: the kernel's 3xTF32
  arithmetic, ``mm_tf32``), the chains summed in order, the mean. The
  replays write NaN-filled outputs and must equal the plain version at C
  = 64, 32, 16 and 8, over several blocks, a tail block and an utterance
  shorter than the k = 11 chain's halo; the float32 arithmetic must equal
  the JAX kernels (``fused_mrf_ct`` with merged taps, ``fused_mrf_phase``
  without prologue) in interpret mode.
- The C = 8 tap-pair staging matches the kernel's indexing, the Python
  tables the kernels' compiled configurations, and the Python
  shared-memory layouts the kernels' own layout code (compiled for the
  host with g++ and the declarations in ``tests/cuda_host``).
- ``prepare_mrf`` stages the engines' form for a level without upsample
  and for a chain level (whose ct fallback reads it), and the wrappers
  refuse the widths and dtypes no kernel is built for.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_ct as mc
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_bf16_engine import CSRC, _chain, _kernel_layouts
from tests.test_torch_f32_engine import _chain_tf32
from tests.torch_port_utils import (
    max_abs, mrf_params, one_torch_thread, rel_l2, to_torch,
)

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
BAND_F32 = 1e-5
BAND_BF16 = 1e-2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


def _case(C, B, T, dtype, seed=0):
    """Unit-gain chain weights (tc layout) and a (B, T, C) input, from the
    seed, with a loud first quarter in the last utterance."""
    rng = np.random.RandomState(seed + 7 * C + T)
    params = mrf_params(rng, 0, C, KS, DILS, w_scale=(C * 7) ** -0.5)
    x = (rng.randn(B, T, C) * 0.5).astype(np.float32)
    x[-1, :T // 4] *= 4.0
    w = [t.to(dtype) for t in vk.pack_mrf_tc_weights(to_torch(params), 0,
                                                       KS, DILS)]
    return params, w, torch.from_numpy(x).to(dtype)


def _nan_alloc(shape, dtype):
    return torch.full(shape, float('nan'), dtype=dtype)


def _replay_ct(pl, x, weights, arith):
    """What the level kernel computes for ``pl`` on x, block by block:
    ``arith`` 'bf16' (conv inputs rounded to bf16), 'f32' (float32) or
    'tf32' (the float32 kernel's 3xTF32 arithmetic). Returns the output
    (NaN where no block wrote) and how often each sample was written."""
    B, T, C = x.shape
    nb, bm = pl.n_blocks, pl.block_m
    xc = x.transpose(1, 2).float()
    acc = None
    for j, (k, dils) in enumerate(zip(pl.kernel_sizes, pl.dilations)):
        h = pl.halos[j]
        assert h == vk.chain_halo(k, dils)
        s = (torch.arange(nb)[:, None] * bm
             + torch.arange(-h, bm + h)[None, :])
        ok = (s >= 0) & (s < T)
        win = torch.where(ok[None, None], xc[:, :, s.clamp(0, T - 1)],
                          torch.zeros(()))            # (B, C, nb, W)
        win = win.permute(0, 2, 1, 3).reshape(B * nb, C, -1)
        steps = [tuple(t[i] for t in weights[4 * j:4 * j + 4])
                 for i in range(len(dils))]
        if arith == 'tf32':
            y = _chain_tf32(win, [tuple(t.float() for t in st)
                                  for st in steps], k, dils,
                            vk.TC_F32_CFG[C].kch, 3)
        else:
            y = _chain(win, steps, k, dils,
                       torch.bfloat16 if arith == 'bf16' else torch.float32)
        acc = y if acc is None else acc + y
    mean = (acc * (1.0 / len(pl.kernel_sizes))).reshape(B, nb, C, bm)
    mean = mean.permute(0, 1, 3, 2).reshape(B, nb * bm, C)
    out = _nan_alloc((B, T, C), x.dtype)
    seen = torch.zeros(B, T, dtype=torch.int64)
    for i in range(nb):
        n0, n1 = i * bm, min((i + 1) * bm, T)
        out[:, n0:n1] = mean[:, n0:n1].to(x.dtype)
        seen[:, n0:n1] += 1
    return out, seen


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('C,B,T,block_m', [
    (64, 2, 400, 96),     # several blocks, a tail block of 16
    (32, 1, 300, 128),
    (16, 2, 200, None),   # the planned block
    (8, 1, 400, 72),
    (8, 2, 40, None),     # the utterance shorter than the k = 11 halo (60)
])
def test_ct_plan_replays_plain(C, B, T, block_m, dtype):
    f32 = dtype == torch.float32
    _, w, x = _case(C, B, T, dtype)
    mrf = vk.prepare_mrf(w, KS, DILS)
    pl = vk._ct_plan(x, mrf, _nan_alloc, 132, block_m)
    assert pl.out.shape == x.shape and pl.out.dtype == dtype
    assert pl.r_smem == (vk.CT_F32_R_SMEM[C] if f32 else
                         vk.CT_BF_CFG[C].r_smem)
    row = C if f32 else vk._bf_rs(C)
    assert pl.scratch == (0 if pl.r_smem else (2 * pl.block_m + 120) * row
                          * min(B * pl.n_blocks, 132))
    if block_m:
        assert pl.block_m == block_m and pl.n_blocks > 2
    out, seen = _replay_ct(pl, x, w, 'tf32' if f32 else 'bf16')
    assert bool((seen == 1).all())
    assert torch.isfinite(out.float()).all()
    ref = mc.mrf_ct_plain(x, mrf)
    if f32:
        assert max_abs(out, ref) < BAND_F32
    else:
        assert rel_l2(out.float(), ref.float()) < BAND_BF16
    assert max_abs(out.float(), x.float()) > 0.05   # the chains carry it


def _jax_out(y):
    return np.asarray(y.astype(jnp.float32)).transpose(0, 2, 1)


def test_ct_bf_replay_matches_jax_float32():
    """The bf16 level's blocks (``CtBf``'s plan at C = 64, several
    blocks) replayed in float32 against JAX's fused_mrf_ct with merged
    taps (the V2 L0 form), interpret mode."""
    C, B, T = 64, 1, 384
    params, w, x = _case(C, B, T, torch.float32, seed=1)
    pl = vk._ct_plan(x.bfloat16(), vk.prepare_mrf(w, KS, DILS), _nan_alloc,
                     132, 96)
    assert pl.n_blocks == 4 and pl.r_smem
    out, _ = _replay_ct(pl, x, w, 'f32')
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = _jax_out(jvk.fused_mrf_ct(
        jnp.asarray(x.numpy().transpose(0, 2, 1)),
        jvk.pack_mrf_weights(jp, 0, KS, DILS, merge_taps=True), KS, DILS,
        tile=128, merge_taps=True, interpret=True))
    assert max_abs(out.numpy(), ref) < BAND_F32


def test_ct_f32_replay_matches_jax():
    """The float32 level's plan and 3xTF32 arithmetic (``CtF32`` at C =
    32, several blocks) against JAX's fused_mrf_phase without prologue
    (the V2 L1 form, p = 4), interpret mode."""
    C, B, T, p = 32, 1, 384, 4
    params, w, x = _case(C, B, T, torch.float32, seed=2)
    pl = vk._ct_plan(x, vk.prepare_mrf(w, KS, DILS), _nan_alloc, 132, 104)
    assert pl.n_blocks == 4 and not pl.r_smem
    out, _ = _replay_ct(pl, x, w, 'tf32')
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = _jax_out(jvk.fused_mrf_phase(
        jnp.asarray(x.numpy().transpose(0, 2, 1)),
        jvk.pack_mrf_phase_weights(jp, 0, KS, DILS, p), KS, DILS, p,
        tile=T // p // 2, interpret=True))
    assert max_abs(out.numpy(), ref) < BAND_F32


@pytest.mark.parametrize('taps', [3, 7, 11])
def test_pack_stage_bf16_pairs_matches_kernel_indexing(taps):
    """C = 8 (ConvSS::PAIR): stage g's pair tp is pair v = v0 + tp (v0 =
    g*tps, or pairs - tps for the last group), whose k16 step reads taps t
    = min(2v, taps - 2) (values 0..7 of K) and t + 1 (values 8..15) of the
    same rows; the kernel's descriptor reads value c of row n of the
    pair's [n][32 bytes] tile at swz<32>. Every tap's weights are applied
    exactly once."""
    tps = vk.CT_BF_CFG[8].tps
    rng = np.random.RandomState(taps)
    w = torch.from_numpy(rng.randn(taps, 8, 8).astype(np.float32))
    packed = vk.pack_stage_bf16_pairs(w, tps).float().numpy()
    wb = w.to(torch.bfloat16).float().numpy()
    nv = (taps + 1) // 2
    G = -(-nv // tps)
    assert packed.size == G * tps * 8 * 16
    st = packed.reshape(G, tps, 8, 16)
    key = vk.swizzle_key(8, 32).numpy()
    applied = np.zeros_like(wb)
    for g in range(G):
        v0 = g * tps if g < G - 1 else nv - tps
        for tp in range(tps):
            t = min(2 * (v0 + tp), taps - 2)
            for n in range(8):
                pos = (((np.arange(16) >> 3) ^ key[n]) << 3) | \
                    (np.arange(16) & 7)
                vals = st[g, tp, n, pos]
                applied[t, :, n] += vals[:8]
                applied[t + 1, :, n] += vals[8:]
    assert np.array_equal(applied, wb)


def _cfg(header, name):
    src = (CSRC / header).read_text()
    body = re.search(r'struct %s \{(.*?)\};' % re.escape(name), src,
                     re.S).group(1)
    return {m[0]: int(m[1]) if m[1].isdigit() else m[1] == 'true'
            for m in re.findall(r'(\w+) = (\w+)', body)}


@pytest.mark.parametrize('C', vk.CT_CHANNELS)
def test_ct_cfg_matches_kernel(C):
    """CtBfCfg and CtF32Cfg (and the float32 chains' TcF32Cfg) per width;
    at C = 64 and 32 the bf16 stages are the phase kernel's chains' (one
    staged form per width)."""
    k = _cfg('mrf_ct.cuh', f'CtBfCfg<{C}>')
    cfg = vk.CT_BF_CFG[C]
    assert (cfg.nw, cfg.tps, cfg.kch, cfg.nbuf, cfg.mg) == (
        k['NW'], k['TPS'], k['KCH'], k['NBUF'], k['MG'])
    # CtBf keeps its float32 windows in shared memory at every width
    assert cfg.r_smem
    assert _cfg('mrf_ct.cuh', f'CtF32Cfg<{C}>')['R_SMEM'] == \
        vk.CT_F32_R_SMEM[C]
    assert C in vk.TC_F32_CFG
    if (2 * C, C) in vk.PHASE_BF_CFG:
        ph = vk.PHASE_BF_CFG[2 * C, C]
        assert (ph.tps, ph.kch) == (cfg.tps, cfg.kch)
    # the tap pairs at C = 8: a k16 step of two taps, every kernel size
    # holds a group of pairs
    assert cfg.kch == (16 if C == 8 else C)
    assert all((kk + 1) // 2 >= cfg.tps if C == 8 else kk >= cfg.tps
               for kk in KS)


# The kernel's CtLayout over CtBf / CtF32, compiled for the host: one line in
# per case ("cb|cf C n (k n d..)*n bm"), one out ("total fits slice"), then
# kSmemMax.
_LAYOUT_MAIN = r"""
#include <cstdio>
#include <cstring>
#include "mrf_ct.cuh"
using namespace mrf::ct;
template <class L> static void put(const L& l) {
  printf("%zu %d %zu\n", l.total, (int)l.fits, l.slice);
}
template <class P> static void read(P& p, int* C) {
  scanf("%d %d", C, &p.n_chains);
  for (int j = 0; j < p.n_chains; ++j) {
    scanf("%d %d", &p.k[j], &p.n_steps[j]);
    for (int i = 0; i < p.n_steps[j]; ++i) scanf("%d", &p.steps[j][i].dil);
  }
  scanf("%d", &p.bm);
}
int main() {
  char kind[4];
  while (scanf("%3s", kind) == 1) {
    int C;
    if (!strcmp(kind, "cb")) {
      CtParams<mrf::bf16> p = {};
      read(p, &C);
      if (C == 64) put(CtLayout<CtBf<64>>(p));
      else if (C == 32) put(CtLayout<CtBf<32>>(p));
      else if (C == 16) put(CtLayout<CtBf<16>>(p));
      else put(CtLayout<CtBf<8>>(p));
    } else {
      CtParams<float> p = {};
      read(p, &C);
      if (C == 64) put(CtLayout<CtF32<64>>(p));
      else if (C == 32) put(CtLayout<CtF32<32>>(p));
      else if (C == 16) put(CtLayout<CtF32<16>>(p));
      else put(CtLayout<CtF32<8>>(p));
    }
  }
  printf("%d\n", kSmemMax);
}
"""

# V2's levels at B = 8 x 1024 frames, and the 12-frame fallback's
V2_LEVELS = ((64, 8192), (32, 65536), (16, 131072), (8, 262144), (32, 768),
             (16, 1536))


def test_ct_smem_layouts_match_kernel(tmp_path):
    """``_ct_bf_smem`` / ``_ct_f32_smem``, the fit the launches check and
    the plan's scratch slice a block, against the kernels' own layout code:
    at the planned block of each V2 level (B = 8, 132 SMs), the largest
    that fits, one 8-sample step past it, and small and odd blocks, with 3
    and 2 dilations."""
    cases, lines = [], []
    for f32 in (False, True):
        for C, T in V2_LEVELS:
            for dils in (DILS, ((1, 3),) * 3):
                ch = ' '.join(f'{k} {len(d)} ' + ' '.join(map(str, d))
                              for k, d in zip(KS, dils))
                r_smem, smem, _, _, row = vk._ct_geometry(C, f32)
                bm0 = vk.ct_block(C, f32, KS, dils, 8, T, 132)
                big = vk._largest_block(1 << 20, 8, lambda bm: smem(
                    KS, dils, bm) <= vk.SMEM_MAX)
                for bm in (8, 64, 200, bm0, big, big + 8):
                    h = max(vk.chain_halo(k, d) for k, d in zip(KS, dils))
                    cases.append((smem(KS, dils, bm),
                                  0 if r_smem else (2 * bm + 2 * h) * row,
                                  bm in (bm0, big)))
                    lines.append(f'{"cf" if f32 else "cb"} {C} 3 {ch} {bm}')
    got, smem_max = _kernel_layouts(lines, tmp_path, _LAYOUT_MAIN)
    assert smem_max == vk.SMEM_MAX
    for (py, slice_, planned), (total, fits, sl), ln in zip(cases, got,
                                                            lines):
        assert (py, py <= vk.SMEM_MAX, slice_) == (total, bool(fits), sl), ln
        assert not planned or fits, ln
    # both sides of the fit at the largest block
    assert all(got[i + 4][1] and not got[i + 5][1]
               for i in range(0, len(got), 6))


@pytest.mark.parametrize('f32', [False, True])
def test_ct_block_matches_direct_search(f32):
    """``ct_block`` takes its per-item stages from a table built once per
    width and chain shape; its choice equals a direct search over every
    block that fits (the least waves x stages, the larger on a tie) at
    V2's levels, the fallback's, short and odd T, other batches and slot
    counts."""
    for C, T in V2_LEVELS + ((8, 5), (16, 100), (64, 999), (32, 4099)):
        _, smem, stages, rows, _ = vk._ct_geometry(C, f32)
        for B, slots in ((8, 132), (1, 132), (3, 7)):
            best = best_cost = None
            for bm in range(8, -(-T // 8) * 8 + 1, 8):
                if smem(KS, DILS, bm) > vk.SMEM_MAX:
                    break
                c = -(-B * -(-T // bm) // slots) * sum(
                    vk._conv_passes(M, rows) * stages(k)
                    for k, d, w in vk._ct_windows(KS, DILS, bm)
                    for M in vk._chain_convs(k, d, w))
                if best is None or c <= best_cost:
                    best, best_cost = bm, c
            assert vk.ct_block(C, f32, KS, DILS, B, T, slots) == best, \
                (C, T, B, slots)


def test_ct_block_spreads_short_levels():
    """The planned blocks at V2's levels (B = 8, 132 SMs): L0 (65536
    samples) takes one wave of items instead of the largest block's 56
    items; every planned block fits, and none is smaller than a third of
    the largest that fits where items outnumber the SMs many times."""
    for f32 in (False, True):
        for C, T in V2_LEVELS[:4]:
            _, smem, _, _, _ = vk._ct_geometry(C, f32)
            bm = vk.ct_block(C, f32, KS, DILS, 8, T, 132)
            big = vk._largest_block(T, 8, lambda b: smem(KS, DILS, b)
                                    <= vk.SMEM_MAX)
            items = 8 * -(-T // bm)
            assert smem(KS, DILS, bm) <= vk.SMEM_MAX and bm % 8 == 0
            if 8 * -(-T // big) < 132:
                assert 8 * -(-T // big) < items <= 132, (C, f32, bm, big)
            else:
                assert bm >= big // 3, (C, f32, bm, big)


def _meta_level(C, dtype, ups=False):
    """A level's weights prepared on the meta device: the engines' staging
    runs as on the card, without one."""
    rng = np.random.RandomState(C)
    tp = to_torch(mrf_params(rng, 0, C, KS, DILS))
    w = [t.to('meta', dtype) for t in vk.pack_mrf_tc_weights(tp, 0, KS,
                                                               DILS)]
    u = (torch.empty(2 * C, C, 4, device='meta', dtype=dtype),
         torch.empty(C, device='meta', dtype=dtype), 2, 1) if ups else None
    return vk.prepare_mrf(w, KS, DILS, u)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_prepare_mrf_stages_the_level_kernels(dtype):
    """A level without upsample at every width of CT_CHANNELS, and a chain
    level (its upsample fused, V1's C = 64 and 32: its ct fallback reads
    the same chains), carry the engine form of their width: staged taps of
    the kernel's stage size per step, float32 biases."""
    f32 = dtype == torch.float32
    for C in vk.CT_CHANNELS:
        for ups in (False, True) if C in vk.PHASE_CHANNELS else (False,):
            mrf = _meta_level(C, dtype, ups)
            assert (mrf.blk_ups is not None) == ups
            assert [len(ch) for ch in mrf.blk] == [3, 3, 3]
            for k, steps in zip(KS, mrf.blk):
                for w1, b1, w2, b2 in steps:
                    if f32:
                        n = 2 * k * C * C
                    else:
                        cfg = vk.CT_BF_CFG[C]
                        vt = (k + 1) // 2 if C == 8 else k
                        kc = 1 if C == 8 else C // cfg.kch
                        n = -(-vt // cfg.tps) * kc * cfg.tps * C * cfg.kch
                    assert w1.numel() == w2.numel() == n
                    assert w1.dtype == (torch.float32 if f32 else
                                        torch.bfloat16)
                    assert b1.dtype == b2.dtype == torch.float32
    # the CPU keeps the plain layout only
    _, w, _ = _case(8, 1, 16, dtype)
    assert vk.prepare_mrf(w, KS, DILS).blk is None


def test_wrappers_refuse_what_no_kernel_serves():
    """The level kernels are built for CT_CHANNELS in bf16 and float32:
    another width or dtype raises naming the built widths, weights without
    the engine form raise, and nothing falls back to the plain version off
    the CPU."""
    mrf = _meta_level(8, torch.bfloat16)
    for fn in (mc.fused_mrf_ct, mc.fused_mrf_phase_noups):
        n = fn.launches
        with pytest.raises(ValueError, match=r'built for \(8, 16, 32, 64\)'):
            fn(torch.empty(1, 64, 128, device='meta', dtype=torch.bfloat16),
               mrf)
        with pytest.raises(ValueError, match='not supported'):
            fn(torch.empty(1, 64, 8, device='meta', dtype=torch.float16), mrf)
        with pytest.raises(ValueError, match='engine form'):
            fn(torch.empty(1, 64, 8, device='meta', dtype=torch.bfloat16),
               dataclasses.replace(mrf, blk=None))
        with pytest.raises(ValueError, match='C=16'):
            fn(torch.empty(1, 64, 16, device='meta', dtype=torch.bfloat16),
               mrf)
        assert fn.launches == n

"""CPU replay of the segment-synchronised int8-dynamic engine
(daft_exprt_torch/ops/csrc/mrf_dyn_blk.cuh) and of the q8f phase route on
``ptc_fused_q8_kernel``'s plan (daft_exprt_torch/ops/mrf_int8.py).

The engine's plan (``mrf_int8._dyn_blk_plan``) is replayed block by block:
each block keeps its own float32 residual rows and quantised conv inputs on
NaN-filled buffers and computes each conv over ``dyn_block_range`` (its
owned samples grown by the reach still needed, cut to the conv's window),
reading only rows it wrote itself; at each segment barrier the blocks'
partial amaxes are reduced, and that reduction must equal the amax over the
conv's whole window. Segments run in each launch's waves, every block of
a wave's segments a distinct grid slot. The result must equal ``mrf_ct_q8_plain`` /
``mrf_phase_q8_plain`` at every sample (the chain mean before conv_post
exactly, the waveform within one bf16 ulp). The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, act_scales, unit_level

CSRC = Path(__file__).resolve().parent.parent / 'daft_exprt_torch' / 'ops' / 'csrc'
from tests.test_torch_int8_plan import _emulate_amax, _emulate_ptc_block
from tests.torch_port_utils import one_torch_thread, to_torch


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


def _alloc(shape, dtype):
    if dtype.is_floating_point:
        return torch.full(shape, float('nan'), dtype=dtype)
    return torch.full(shape, -7, dtype=dtype)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


def _q(v, amax):
    """The dynamic quantisation of lrelu(v) with the segment's amax, kept
    in float32 so that a NaN (an unwritten row) stays visible."""
    return torch.round(vk._lrelu(v) * (torch.full((), 127.0) / amax))


def _conv(A, a0, M, w, d):
    """Rows [0, M) of the s8 x s8 conv of quantised rows A (float, NaN for
    unwritten), output m reading A[a0 + m + t*d]: one float64 matmul over
    the taps' rows side by side (exact: every product and partial sum is
    an integer far below 2^53, so the order of the sum does not matter)."""
    k, ci, co = w.shape
    rows = torch.cat([A[a0 + t * d:a0 + t * d + M] for t in range(k)], 1)
    return (rows.double() @ w.reshape(k * ci, co).double()).float()


def _assert_within_bf16_ulp(out, ref):
    """The waveforms agree within one bf16 ulp of the reference: conv_post
    sums 7 x C float32 terms per sample, here by slices, in the plain
    version over the whole tile, and a last-bit difference can round to
    the neighbouring bf16 value."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126)))
                     - 7)
    assert bool(((out.float() - r).abs() <= ulp).all())


def _x0_segments(x, mrf, tile, plan):
    """The segments' x0 over X (the plain versions' windows): ct the
    zero-padded x windows, phase the int8 upsample prologue."""
    if mrf.ups is None:
        return mi._windows(x, tile, -plan.x_lo, plan.x_hi - plan.x_lo)
    halo, halo_in, _, _ = mi._phase_geometry(mrf, x.shape[1] // mrf.p_in,
                                             tile)
    return mi._phase_prologue_plain(x, mrf, tile, halo, halo_in)


def _replay(x, mrf, tile, slots, block_m=None):
    """The engine's launches of x on the CPU, block by block; returns the
    level's output as the wrapper would."""
    plan = mi._dyn_blk_plan(x, mrf, tile, None, _alloc, slots, block_m)
    B, T_in, _ = x.shape
    ct = mrf.ups is None
    x0 = _x0_segments(x, mrf, tile, plan)
    assert x0.shape[1] == plan.x_hi - plan.x_lo
    plan.sync.zero_()                   # the wrapper zeroes it
    means = torch.full((plan.S, plan.N, x0.shape[2]), float('nan'))
    j0 = 0                              # the launch's first chain
    for ln in plan.launches:
        G, bm = ln.G, ln.block_m
        assert (G - 1) * bm < plan.x_hi - plan.x_lo <= G * bm
        assert ln.spw * G <= slots and ln.n_waves * ln.spw >= plan.S
        seen = set()
        for wave in range(ln.n_waves):
            served = []                 # (segment, block) per grid block
            for g in range(slots):
                seg = wave * ln.spw + g // G
                if g < ln.spw * G and seg < plan.S:
                    served.append((seg, g % G))
            for seg in sorted({s_ for s_, _ in served}):
                # the wave holds every block of its segments, so a block
                # waits only on running blocks
                assert sorted(i for s_, i in served if s_ == seg) == \
                    list(range(G))
                seen.add(seg)
                _replay_segment(plan, ln, j0, mrf, x0[seg], seg, means)
        assert seen == set(range(plan.S))
        j0 += len(ln.chains)
    if ct:
        return plan.out
    if mrf.post is None:
        return (means * plan.scale).to(x.dtype).reshape(B, -1, x0.shape[2])
    return plan.out


def _replay_segment(plan, ln, j0, mrf, x0, seg, means):
    """One segment of one launch: its G blocks in lockstep, a barrier per
    conv (and, phase, one for x0's scale)."""
    G, bm, P = ln.G, ln.block_m, plan.P
    C = x0.shape[1]
    ct = mrf.ups is None
    b, t = divmod(seg, plan.n_tiles)
    wrows = bm + 2 * ln.hx
    own = [(plan.x_lo + i * bm, min(plan.x_lo + (i + 1) * bm, plan.x_hi))
           for i in range(G)]
    base = [o[0] - ln.hx for o in own]
    nan = float('nan')
    R = [torch.full((wrows, C), nan) for _ in range(G)]
    A1 = [torch.full((wrows, C), nan) for _ in range(G)]
    A2 = [torch.full((wrows, C), nan) for _ in range(G)]
    O = [torch.full((bm + 2 * P, C), nan) for _ in range(G)]
    bar = 0

    def barrier(partials, lo, hi, ranges):
        """The segment's blocks post their partial amaxes; the reduction
        must cover exactly the window [lo, hi)."""
        nonlocal bar
        cover = torch.zeros(hi - lo, dtype=torch.bool)
        for r0, r1 in ranges:
            if r1 > r0:
                assert lo <= r0 and r1 <= hi
                cover[r0 - lo:r1 - lo] = True
        assert bool(cover.all()), 'a window sample no block produces'
        a = torch.stack(partials).max()
        ln.sync[0, bar, seg] = a.view(torch.int32)   # the word's float bits
        ln.sync[1, bar, seg] = G
        bar += 1
        return a.clamp(min=1e-30)

    ax0 = None if not ct else vk._lrelu(x0).abs().max().clamp(min=1e-30)
    for j, ch in enumerate(ln.chains):
        k, half = ch.k, (ch.k - 1) // 2
        rng = [mi.dyn_block_range(plan, ln, i, ch.rem[0], (plan.x_lo, plan.x_hi))
               for i in range(G)]
        for i, (lo, hi) in enumerate(rng):
            R[i][lo - base[i]:hi - base[i]] = \
                x0[lo - plan.x_lo:hi - plan.x_lo]
        if ax0 is None:                 # phase: x0's scale, first chain
            ax0 = barrier([vk._lrelu(R[i][lo - base[i]:hi - base[i]]).abs()
                           .max() for i, (lo, hi) in enumerate(rng)],
                          plan.x_lo, plan.x_hi, rng)
            assert ax0 == vk._lrelu(x0).abs().max().clamp(min=1e-30)
        for i, (lo, hi) in enumerate(rng):
            A1[i][lo - base[i]:hi - base[i]] = _q(
                R[i][lo - base[i]:hi - base[i]], ax0)
        ax = ax0
        for si, d in enumerate(ch.dils):
            w1, sw1, b1, w2, sw2, b2 = mrf.chains[j0 + j][si]
            last = si == len(ch.dils) - 1
            # conv1
            r1 = [mi.dyn_block_range(plan, ln, i, ch.rem[2 * si + 1],
                                     ch.wins[2 * si]) for i in range(G)]
            sx = ax * (1.0 / 127.0)
            v1 = []
            for i, (lo, hi) in enumerate(r1):
                M = max(hi - lo, 0)
                acc = _conv(A1[i], lo - base[i] - d * half, M, w1, d)
                v = vk._fma(acc, sw1 * sx, b1)
                assert torch.isfinite(v).all(), 'conv1 read an unwritten row'
                v1.append(v)
            a1 = barrier([vk._lrelu(v).abs().max() if v.numel() else
                          torch.zeros(()) for v in v1], *ch.wins[2 * si], r1)
            for i, (lo, hi) in enumerate(r1):
                A2[i][lo - base[i]:hi - base[i]] = _q(v1[i], a1)
            # conv2 onto the residual
            r2 = [mi.dyn_block_range(plan, ln, i, ch.rem[2 * si + 2],
                                     ch.wins[2 * si + 1]) for i in range(G)]
            sx = a1 * (1.0 / 127.0)
            parts = []
            for i, (lo, hi) in enumerate(r2):
                M = max(hi - lo, 0)
                acc = _conv(A2[i], lo - base[i] - half, M, w2, 1)
                v = R[i][lo - base[i]:lo - base[i] + M] + vk._fma(
                    acc, sw2 * sx, b2)
                assert torch.isfinite(v).all(), 'conv2 read an unwritten row'
                if not last:
                    R[i][lo - base[i]:lo - base[i] + M] = v
                    parts.append(vk._lrelu(v).abs().max() if M else
                                 torch.zeros(()))
                    continue
                if ct:
                    o0, o1 = own[i]
                    n0, n1 = max(lo, o0), min(hi, o1)
                    if n1 <= n0:
                        continue
                    vv = v[n0 - lo:n1 - lo]
                    g0, g1 = t * plan.tile_in + n0, t * plan.tile_in + n1
                    if ln.mode == vk.WRITE:
                        plan.sum[b, g0:g1] = vv
                    elif ln.mode == vk.ADD:
                        plan.sum[b, g0:g1] = plan.sum[b, g0:g1] + vv
                    else:
                        tot = plan.sum[b, g0:g1] + vv if ln.has_acc else vv
                        plan.out[b, g0:g1] = (tot * plan.scale).to(
                            plan.out.dtype)
                else:
                    r0 = lo - (own[i][0] - P)
                    O[i][r0:r0 + M] = v if j == 0 else O[i][r0:r0 + M] + v
            if not last:
                ax = barrier(parts, *ch.wins[2 * si + 1], r2)
                for i, (lo, hi) in enumerate(r2):
                    A1[i][lo - base[i]:hi - base[i]] = _q(
                        R[i][lo - base[i]:hi - base[i]], ax)
    assert bar == ln.n_bar
    if ct:
        return
    for i, (o0, o1) in enumerate(own):      # the owned samples in [0, N)
        n0, n1 = max(o0, 0), min(o1, plan.N)
        if n1 <= n0:
            continue
        means[seg, n0:n1] = O[i][n0 - o0 + P:n1 - o0 + P]
        if mrf.post is not None:
            w, bias, pdt = mrf.post
            q = vk._lrelu(O[i][n0 - o0:n1 - o0 + 2 * P] * plan.scale).to(
                pdt).float().t()[None]
            y = F.conv1d(q, w.t()[None]) + bias
            plan.out[b, 0, t * plan.N + n0:t * plan.N + n1] = torch.tanh(
                y[0, 0]).to(plan.out.dtype)


def _ct_level(seed, C):
    rng = np.random.RandomState(seed)
    tp = _bf16(to_torch(unit_level(rng, 0, C)))
    return rng, mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
        mi.pack_mrf_weights(tp, 0, KS, DILS)), KS, DILS)


def _phase_level(seed, C_in, C, p_in, post, static=False):
    rng = np.random.RandomState(seed)
    p = 2 * p_in
    tp = _bf16(to_torch(unit_level(rng, 1, C, C_in=C_in, post=post)))
    scales = None
    if static:
        scales = [torch.from_numpy(s[i]) for s1, s2 in act_scales(rng, C)
                  for i in range(s1.shape[0]) for s in (s1, s2)]
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p, scales)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    ups = mi.quantize_ups_phase_weights(
        wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
    pst = mi.pack_post_phase_weights(tp['conv_post']['w'],
                                     tp['conv_post']['b'], p) if post else None
    return rng, mi.prepare_mrf_phase_q8(qw, KS, DILS, p,
                                        tuple(ups) + (4, 2, 1, p_in), pst)


@pytest.mark.parametrize('C,B,T,tile,slots,block_m', [
    (256, 1, 128, 64, 3, 128),     # V1 L0 width: 2 segments of 3 blocks
                                   # (the last 64 of 128), one a wave
    (128, 2, 256, 128, 9, 96),     # V1 L1 width: blocks of 96 (the last
                                   # 32), 4 segments, 2 a wave
    (128, 2, 256, 64, 7, None),    # the launches' own block sizes
])
def test_ct_engine_replays_plain(C, B, T, tile, slots, block_m):
    """x windows reaching into the zero padding at both utterance edges,
    one loud tile (its own scales)."""
    rng, mrf = _ct_level(11, C)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32)
                         ).bfloat16()
    x[-1, :tile] *= 6.0
    out = _replay(x, mrf, tile, slots, block_m)
    ref = mi.mrf_ct_q8_plain(x, mrf, tile)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize('C_in,C,p_in,post,cols,tile,slots,block_m', [
    (128, 64, 1, False, 512, 256, 8, 128),    # V1 L2: 4 segments of 8,
                                              # one a wave
    (64, 32, 2, True, 256, 64, 5, None),      # V1 L3, conv_post: 5 blocks
    (64, 32, 2, True, 256, 128, 11, 192),     # blocks of 192 (the last 80)
])
def test_phase_engine_replays_plain(C_in, C, p_in, post, cols, tile, slots,
                                    block_m):
    """The int8 upsample prologue with its per-tile scale, x0's scale
    reduced over the whole window, conv_post at L3; B = 2, one loud
    tile."""
    rng, mrf = _phase_level(12, C_in, C, p_in, post)
    x = torch.from_numpy((rng.randn(2, cols * p_in, C_in) * 0.5)
                         .astype(np.float32)).bfloat16()
    x[1, :tile * p_in] *= 5.0
    out = _replay(x, mrf, tile, slots, block_m)
    ref = mi.mrf_phase_q8_plain(x, mrf, tile)
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    if post:       # conv_post's float32 sum in another order
        _assert_within_bf16_ulp(out, ref)
        ref_mean = mi.mrf_phase_q8_plain(x, replace(mrf, post=None), tile)
        mean = _replay(x, replace(mrf, post=None), tile, slots, block_m)
        assert torch.equal(mean, ref_mean)
    else:
        assert torch.equal(out, ref)


def test_engine_plan_blocks_and_windows():
    """V1's B=8 x 1024-frame shapes on 132 slots: block sizes, blocks a
    segment and waves per launch, barriers a launch, block halos, and the
    conv windows nested inside each other (a conv reads only its input's
    window)."""
    cases = []
    _, ct256 = _ct_level(1, 256)
    _, ct128 = _ct_level(1, 128)
    _, ph64 = _phase_level(1, 128, 64, 1, False)
    _, ph32 = _phase_level(1, 64, 32, 2, True)
    cases = [(ct256, (8, 8192, 256), 2048, [(192, 12, 3), (144, 16, 4),
                                            (128, 18, 5)], 5),
             (ct128, (8, 65536, 128), 4096, [(198, 22, 22), (168, 26, 26),
                                             (99, 44, 43)], 5),
             (ph64, (8, 65536, 128), 8192, [(128, 132, 64)], 16),
             (ph32, (8, 131072, 64), 8192, [(256, 132, 64)], 16)]
    for mrf, shape, tile, blocks, n_bar in cases:
        x = torch.empty(shape, dtype=torch.bfloat16, device='meta')
        plan = mi._dyn_blk_plan(x, mrf, tile, None,
                                lambda s, d: torch.empty(s, dtype=d,
                                                         device='meta'), 132)
        # per launch (block_m, G, waves): the largest blocks its halo
        # allows, packed so that few of the 132 slots idle
        assert [(ln.block_m, ln.G, ln.n_waves) for ln in plan.launches] == \
            blocks
        assert [ln.n_bar for ln in plan.launches] == \
            [n_bar] * len(plan.launches)
        C_in = shape[2]
        wrows_max = mi.DYN_BLK_CFG[C_in, C_in if mrf.ups is None
                                   else C_in // 2][0]
        for ln in plan.launches:
            assert ln.block_m + 2 * ln.hx <= wrows_max
            for ch in ln.chains:
                half = (ch.k - 1) // 2
                prev = (plan.x_lo, plan.x_hi)
                for c, (lo, hi) in enumerate(ch.wins):
                    r = ch.dils[c // 2] * half if c % 2 == 0 else half
                    assert prev[0] <= lo - r and hi + r <= prev[1]
                    prev = (lo, hi)
                assert ch.wins[-1] == (plan.out_lo, plan.out_hi)
    with pytest.raises(ValueError, match='resident blocks'):
        x = torch.empty((8, 65536, 128), dtype=torch.bfloat16, device='meta')
        mi._dyn_blk_plan(x, ph64, 8192, None, lambda s, d: torch.empty(
            s, dtype=d, device='meta'), 114)


@pytest.mark.parametrize('C_in,C,p_in,post,block_m', [
    (128, 64, 1, False, 128),      # V1 L2, the kernel's block
    (64, 32, 2, True, 256),        # V1 L3 with conv_post
])
def test_phase_q8f_replays_on_ptc_fused_plan(C_in, C, p_in, post, block_m):
    """The q8f phase mode on ``ptc_fused_q8_kernel``'s plan with the phase
    tiles: the tile's upsample scale over the phase kernel's input window,
    the static chains per block from its own window."""
    rng, mrf = _phase_level(13, C_in, C, p_in, post, static=True)
    assert mrf.mode == 'q8f'
    cols, tile = 256, 128
    x = torch.from_numpy((rng.randn(1, cols * p_in, C_in) * 0.5)
                         .astype(np.float32)).bfloat16()
    x[0, :tile * p_in] *= 5.0
    plan = mi._ptc_fused_plan(x, mrf, tile, _alloc, block_m=block_m,
                              geometry=mi._phase_geometry)
    halo, halo_in, _, _ = mi._phase_geometry(mrf, cols, tile)
    assert (plan.halo_in, plan.win_len) == (halo_in * p_in,
                                            (tile + 2 * halo_in) * p_in)
    assert plan.hx <= halo * mrf.p
    _emulate_amax(plan)
    means = _alloc((1, cols * mrf.p, C), torch.float32)
    for seg in range(plan.amax.shape[0]):
        for i in range(plan.blocks_per_tile):
            _emulate_ptc_block(plan, mrf, seg, i, means)
    ref = mi.mrf_phase_q8_plain(x, mrf, tile)
    assert torch.isfinite(plan.out.float()).all()
    if post:
        _assert_within_bf16_ulp(plan.out, ref)
    else:
        assert torch.equal(plan.out, ref)


@pytest.mark.parametrize('C_in,C', sorted(mi.DYN_BLK_CFG))
def test_dyn_blk_cfg_matches_kernel(C_in, C):
    """``DYN_BLK_CFG`` holds the kernel's ``DynCfg`` (mrf_dyn_blk.cuh): the
    rows a block holds, the rows of one MMA pass (``Conv::ROWS`` of its
    warps), the staged weights' shapes and where R lives, from which the
    launcher sizes the global scratch. The q8f phase mode stages its
    weights by this table and runs ``ptc_fused_q8_kernel`` on
    ``PTC_Q8_CFG``'s stages, so the two agree."""
    src = (CSRC / 'mrf_dyn_blk.cuh').read_text()
    body = re.search(r'struct DynCfg<%d, %d> \{(.*?)\};' % (C_in, C), src,
                     re.S).group(1)
    k = {m[0]: m[1] for m in re.findall(r'(\w+) = (\w+)', body)}
    nw, wm = int(k['NW']), int(k['WM'])
    wn = min(C, 128)
    rows_pass = (nw // 4) // (C // wn) * 64 * (wm // 16)
    cfg = mi.DYN_BLK_CFG[C_in, C]
    assert cfg == (int(k['WROWS']), rows_pass, int(k['TPS']), int(k['KCH']),
                   int(k['UTPS']), int(k['UKCH']), k['R_SMEM'] == 'true')
    if C_in != C:
        assert vk.PTC_Q8_CFG[C_in, C][1:] == cfg[2:6]

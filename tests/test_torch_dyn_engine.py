"""CPU replay of the segment-synchronised int8-dynamic engine
(daft_exprt_torch/ops/csrc/mrf_dyn_blk.cuh: the dynamic ``fused_mrf_ct_q8``,
``fused_mrf_phase_q8`` with and without its prologue and, on the phase-tc
tiles, ``fused_mrf_ptc``) and of the static routes on
``ptc_fused_q8_kernel``'s plan: the q8f and q8s phase modes, and without
the prologue the static ct levels and the static phase kernel without
prologue (daft_exprt_torch/ops/mrf_int8.py).

The engine's plan (``mrf_int8._dyn_blk_plan``) is replayed block by block:
each block keeps its own float32 residual rows and quantised conv inputs on
NaN-filled buffers and computes each conv over ``dyn_block_range`` (its
owned samples grown by the reach still needed, cut to the conv's window),
reading only rows it wrote itself; at each segment barrier the blocks'
partial amaxes are reduced, and that reduction must equal the amax over the
conv's whole window. Segments run in each launch's waves, every block of
a wave's segments a distinct grid slot. The result must equal ``mrf_ct_q8_plain`` /
``mrf_phase_q8_plain`` / ``mrf_phase_q8_noups_plain`` / ``mrf_ptc_plain``
at every sample (the chain mean
before conv_post exactly, the waveform within one bf16 ulp), and JAX's
``fused_mrf_ptc(dyn=True)`` in interpret mode. The
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

from tests.test_torch_int8 import KS, DILS, _t, act_scales, unit_level

CSRC = Path(__file__).resolve().parent.parent / 'daft_exprt_torch' / 'ops' / 'csrc'
from tests.test_torch_int8_dynamic import _jp
from tests.test_torch_int8_plan import _emulate_amax, _emulate_ptc_block
from tests.test_torch_ptc_modes import _case as _ptc_case, _jax_ptc
from tests.torch_port_utils import max_abs, one_torch_thread, to_torch


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


def _x0_segments(x, mrf, tile, plan, geometry):
    """The segments' x0 over X (the plain versions' windows): without
    upsample the zero-padded x windows, phase and ptc the int8 upsample
    prologue."""
    if mrf.ups is None:
        return mi._windows(x, plan.N, -plan.x_lo, plan.x_hi - plan.x_lo)
    halo, halo_in, _, _ = geometry(mrf, x.shape[1] // mrf.p_in, tile)
    return mi._phase_prologue_plain(x, mrf, tile, halo, halo_in)


def _replay(x, mrf, tile, slots, block_m=None, geometry=mi._phase_geometry,
            p=1):
    """The engine's launches of x on the CPU, block by block (a narrow
    level on ``geometry``'s tiles: the phase kernel's or, ptc, the phase-tc
    kernel's; a level without upsample on the windows of ``p`` phases);
    returns the level's output as the wrapper would."""
    plan = mi._dyn_blk_plan(x, mrf, tile, None, _alloc, slots, block_m,
                            geometry, p)
    B, T_in, _ = x.shape
    level = _level_form(mrf, x.shape[2])
    x0 = _x0_segments(x, mrf, tile, plan, geometry)
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
    if not level:
        return plan.out
    if mrf.post is None:
        return (means * plan.scale).to(x.dtype).reshape(B, -1, x0.shape[2])
    return plan.out


def _level_form(mrf, C_in):
    """Whether a launch holds the level's chains and sums them on chip
    (``DynTypes::LEVEL`` in mrf_dyn_blk.cuh), else one chain into the
    float32 chain sum."""
    return mrf.ups is not None or C_in <= 64


def _replay_segment(plan, ln, j0, mrf, x0, seg, means):
    """One segment of one launch: its G blocks in lockstep, a barrier per
    conv (and, with the upsample, one for x0's scale)."""
    G, bm, P = ln.G, ln.block_m, plan.P
    C = x0.shape[1]
    ct = mrf.ups is None
    level = _level_form(mrf, C)
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
                if not level:
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
    if not level:
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


def _phase_level(seed, C_in, C, p_in, post, static=False, fused=True):
    rng = np.random.RandomState(seed)
    p = 2 * p_in
    tp = _bf16(to_torch(unit_level(rng, 1, C, C_in=C_in, post=post)))
    scales = None
    if static:
        scales = [torch.from_numpy(s[i]) for s1, s2 in act_scales(rng, C)
                  for i in range(s1.shape[0]) for s in (s1, s2)]
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p, scales,
        fused=fused)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    ups = mi.quantize_ups_phase_weights(
        wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
    pst = mi.pack_post_phase_weights(tp['conv_post']['w'],
                                     tp['conv_post']['b'], p) if post else None
    return rng, mi.prepare_mrf_phase_q8(qw, KS, DILS, p,
                                        tuple(ups) + (4, 2, 1, p_in), pst)


def _ptc_level(seed, C_in, C, p_in, post):
    """A narrow level's dyn phase-tc weights (``prepare_mrf_ptc`` on the
    phase-tc packers without act scales)."""
    rng = np.random.RandomState(seed)
    p = 2 * p_in
    tp = _bf16(to_torch(unit_level(rng, 1, C, C_in=C_in, post=post)))
    pst = vk.pack_post_ptc_weights(tp['conv_post']['w'], tp['conv_post']['b'],
                                   p, torch.bfloat16) if post else None
    return rng, vk.prepare_mrf_ptc(
        vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2,
                                      1, p_in)) + (4, 2, 1, p_in), pst)


@pytest.mark.parametrize('C,B,T,tile,slots,block_m', [
    (256, 1, 128, 64, 3, 128),     # V1 L0 width: 2 segments of 3 blocks
                                   # (the last 64 of 128), one a wave
    (128, 2, 256, 128, 9, 96),     # V1 L1 width: blocks of 96 (the last
                                   # 32), 4 segments, 2 a wave
    (128, 2, 256, 64, 7, None),    # the launches' own block sizes
    # V2's widths, one launch a level with the chain sum on chip
    (64, 2, 512, 256, 6, None),    # V2 L0: 4 segments of 4 blocks
    (64, 1, 384, 128, 9, 96),      # blocks of 96, 3 segments, 2 a wave
    (32, 2, 1024, 512, 7, None),   # the C = 32 ct fallback's width
    (32, 2, 768, 768, 5, None),    # V2 L1 at 12 frames: one segment an
                                   # utterance, its windows in the zero
                                   # padding at both ends
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


@pytest.mark.parametrize('C', [256, 128, 64, 32])
def test_ct_engine_groups_as_the_kernel_is_compiled(C):
    """The plan of a level without upsample takes one launch per chain
    through the float32 chain sum exactly where the kernel's ``LEVEL``
    (mrf_dyn_blk.cuh, a compile-time constant of the width) leaves the
    chain sum off chip, else one launch with every chain."""
    src = (CSRC / 'mrf_dyn_blk.cuh').read_text()
    top = int(re.search(r'bool LEVEL = UPS \|\| C <= (\d+);', src).group(1))
    _, mrf = _ct_level(11, C)
    x = torch.zeros((2, 256, C), dtype=torch.bfloat16)
    plan = mi._dyn_blk_plan(x, mrf, 128, None, _alloc, 8)
    if C <= top:
        (ln,) = plan.launches
        assert len(ln.chains) == 3 and ln.mode == vk.FINAL
        assert plan.sum is None
    else:
        assert [len(ln.chains) for ln in plan.launches] == [1, 1, 1]
        assert [ln.mode for ln in plan.launches] == [vk.WRITE, vk.ADD,
                                                     vk.FINAL]
        assert plan.sum is not None and plan.sum.dtype == torch.float32


@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_ct_engine_runs_a_chain_levels_weights(C_in, C, p_in, post):
    """A chain level's dynamic weights (``prepare_mrf_phase_q8``, with its
    upsample and, at L3, conv_post) serve its fallback to fused_mrf_ct:
    without them (``_without_ups``, as the wrapper takes them) the engine's
    ct plan equals ``mrf_ct_q8_plain`` on the weights as packed, and the
    staged chains are those of the width's ct form."""
    rng, mrf = _phase_level(18, C_in, C, p_in, post)
    w = mi._without_ups(mrf)
    assert w.ups is None and w.post is None and w.dynamic
    assert w.chains is mrf.chains
    x = torch.from_numpy((rng.randn(2, 512, C) * 0.5).astype(np.float32)
                         ).bfloat16()
    x[1, :256] *= 6.0
    out = _replay(x, w, 256, 9)
    assert torch.equal(out, mi.mrf_ct_q8_plain(x, mrf, 256))


@pytest.mark.parametrize('C,p,T,tile,slots,block_m', [
    (32, 4, 512, 64, 9, None),     # V2 L1's width and phases: 2 tiles an
                                   # utterance, halos of 128 columns
    (32, 4, 1024, 128, 6, 256),    # blocks of 256, one segment a wave
    (64, 2, 512, 128, 8, None),    # C = 64 at p = 2 (a chain level whose
                                   # upsample does not fuse)
])
def test_phase_noups_engine_replays_plain(C, p, T, tile, slots, block_m):
    """The dynamic phase kernel without prologue on the engine: x's windows
    of tile + 2*halo columns, every conv over the phase kernel's column
    window (whole columns of p samples), one launch a level; B = 2, one
    loud tile."""
    rng, mrf = _ct_level(16, C)
    x = torch.from_numpy((rng.randn(2, T, C) * 0.5).astype(np.float32)
                         ).bfloat16()
    x[1, :tile * p] *= 5.0
    plan = mi._dyn_blk_plan(x, mrf, tile, None, _alloc, slots, block_m, p=p)
    (ln,) = plan.launches
    assert ln.n_bar == 15 and plan.sum is None
    assert (plan.x_lo, plan.N) == (-mi.phase_chain_halo(KS, DILS, p) * p,
                                   tile * p)
    out = _replay(x, mrf, tile, slots, block_m, p=p)
    ref = mi.mrf_phase_q8_noups_plain(x, mrf, p, tile)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)
    # the phase windows are not the ct ones: another function of x
    assert not torch.equal(ref, mi.mrf_ct_q8_plain(x, mrf, tile * p))


def _engine_case(*args, kind='phase', id=None):
    return pytest.param(*args, kind, id=id or '-'.join(map(str, args)))


@pytest.mark.parametrize('C_in,C,p_in,post,cols,tile,slots,block_m,kind', [
    _engine_case(128, 64, 1, False, 512, 256, 8, 128),  # V1 L2: 4 segments
                                                        # of 8, one a wave
    _engine_case(64, 32, 2, True, 256, 64, 5, None),    # V1 L3, conv_post:
                                                        # 5 blocks
    _engine_case(64, 32, 2, True, 256, 128, 11, 192),   # blocks of 192 (the
                                                        # last 80)
    # fused_mrf_ptc dyn: the phase-tc tiles (rows) and halos (64 rows at
    # L3, 128 at L2), 4 and 6 segments
    _engine_case(128, 64, 1, False, 128, 64, 11, None, kind='ptc',
                 id='ptc-L2'),
    _engine_case(64, 32, 2, True, 128, 64, 5, None, kind='ptc',
                 id='ptc-L3-conv_post'),
])
def test_phase_engine_replays_plain(C_in, C, p_in, post, cols, tile, slots,
                                    block_m, kind):
    """The int8 upsample prologue with its per-tile scale, x0's scale
    reduced over the whole window, conv_post at L3; B = 2, one loud
    tile. ``kind`` 'ptc': the same engine on fused_mrf_ptc's phase-tc
    geometry (``cols`` and ``tile`` in rows), held to ``mrf_ptc_plain``."""
    ptc = kind == 'ptc'
    rng, mrf = (_ptc_level if ptc else _phase_level)(12, C_in, C, p_in, post)
    plain = mi.mrf_ptc_plain if ptc else mi.mrf_phase_q8_plain
    geometry = mi._ptc_geometry if ptc else mi._phase_geometry
    x = torch.from_numpy((rng.randn(2, cols * p_in, C_in) * 0.5)
                         .astype(np.float32)).bfloat16()
    x[1, :tile * p_in] *= 5.0
    out = _replay(x, mrf, tile, slots, block_m, geometry)
    ref = plain(x, mrf, tile)
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    if post:       # conv_post's float32 sum in another order
        _assert_within_bf16_ulp(out, ref)
        ref_mean = plain(x, replace(mrf, post=None), tile)
        mean = _replay(x, replace(mrf, post=None), tile, slots, block_m,
                       geometry)
        assert torch.equal(mean, ref_mean)
    else:
        assert torch.equal(out, ref)


def test_ptc_engine_replay_matches_jax():
    """fused_mrf_ptc's dyn mode on the engine's plan against JAX's Pallas
    kernel (``fused_mrf_ptc(dyn=True)``, interpret mode) at V1's L2
    geometry on JAX's packed weights, two utterances of three 64-row tiles,
    one loud: every sample equal."""
    C_in, C, p_in = 128, 64, 1
    params, x, tile = _ptc_case(C_in, C, p_in, False, 17)
    ref, jw, ups, _ = _jax_ptc(_jp(params), x, 2, p_in, tile, False,
                               'bfloat16', False)
    mrf = vk.prepare_mrf_ptc(_t(jw), KS, DILS, 2,
                             _t(ups[:3]) + [ups[3], 4, 2, 1, p_in])
    assert mrf.dynamic
    out = _replay(torch.from_numpy(x).bfloat16(), mrf, tile, 11,
                  geometry=mi._ptc_geometry)
    assert out.shape == ref.shape
    assert max_abs(out.float().numpy(), ref) == 0.0


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
    # fused_mrf_ptc dyn at the int8-partial path's shapes: 8192-row tiles,
    # segments of 16384 + 2*256 (L2) and 32768 + 2*256 samples (L3), at
    # least 125 (blocks of 136) and 87 (of 384) of the 132 slots; the plan
    # spreads each over all 132, one segment a wave. A card with fewer
    # resident blocks than an L2 segment needs makes the plan raise
    _, pt64 = _ptc_level(1, 128, 64, 1, False)
    _, pt32 = _ptc_level(1, 64, 32, 2, True)
    for mrf, shape, blocks in ((pt64, (8, 65536, 128), (128, 132, 64)),
                               (pt32, (8, 131072, 64), (254, 132, 64))):
        x = torch.empty(shape, dtype=torch.bfloat16, device='meta')
        plan = mi._dyn_blk_plan(x, mrf, 8192, None, lambda s, d: torch.empty(
            s, dtype=d, device='meta'), 132, geometry=mi._ptc_geometry)
        (ln,) = plan.launches
        assert (ln.block_m, ln.G, ln.n_waves) == blocks and ln.n_bar == 16
        assert plan.x_hi - plan.x_lo == 8192 * mrf.p + 512
    with pytest.raises(ValueError, match='resident blocks'):
        mi._dyn_blk_plan(torch.empty((8, 65536, 128), dtype=torch.bfloat16,
                                     device='meta'), pt64, 8192, None,
                         lambda s, d: torch.empty(s, dtype=d, device='meta'),
                         124, geometry=mi._ptc_geometry)


@pytest.mark.parametrize('C_in,C,p_in,post,block_m', [
    (128, 64, 1, False, 128),      # V1 L2, the kernel's block
    (64, 32, 2, True, 256),        # V1 L3 with conv_post
])
def test_phase_q8f_replays_on_ptc_fused_plan(C_in, C, p_in, post, block_m):
    """The q8f phase mode on ``ptc_fused_q8_kernel``'s plan with the phase
    tiles: the tile's upsample scale over the phase kernel's input window,
    the static chains per block from its own window."""
    _replay_static_phase(C_in, C, p_in, post, block_m, 'q8f')


@pytest.mark.parametrize('C_in,C,p_in,post,block_m', [
    (128, 64, 1, False, 128),      # V1 L2, the kernel's block
    (64, 32, 2, True, 256),        # V1 L3 with conv_post
    (128, 64, 1, True, 64),        # conv_post at L2's width, more blocks
])
def test_phase_q8s_replays_on_ptc_fused_plan(C_in, C, p_in, post, block_m):
    """The q8s phase mode (``int8_fused=False``) on the same plan: the
    kernel's q8s form quantises each step's input by quantize_static of its
    lrelu and takes conv1's output through the float32 dequant."""
    _replay_static_phase(C_in, C, p_in, post, block_m, 'q8s')


# the per-step arrays of each static form, in the packers' order
# (MrfQ8Weights)
_STEP_FIELDS = {'q8f': ('w1', 'inv1', 'b1i', 'm1', 'w2', 'sw2', 'b2'),
                'q8s': ('w1', 'sw1', 'inv1', 'b1', 'w2', 'sw2', 'inv2', 'b2')}


@pytest.mark.parametrize('mode', ['q8f', 'q8s'])
def test_ptc_fused_entry_reads_each_form_in_order(mode):
    """``mrf_int8._ptc_fused_args`` hands each chain step's arrays over in
    the packers' order, and ``ptc_fused_entry`` (mrf_ptc_fused.cuh) reads
    each Step field from the position of that array (parsed from the
    source): 7 pointers a step for q8f, 8 for q8s."""
    src = (CSRC / 'mrf_ptc_fused.cuh').read_text()
    body = src[src.index('Step& st = p.steps[j][i];'):]
    body = body[:body.index('cudaStream_t s')]
    branch = body[body.index('if (Q8S) {'):body.index('} else {')] \
        if mode == 'q8s' else body[body.index('} else {'):]
    pat = r'st\.(\w+) = (?:f\((\d)\)|reinterpret_cast<[^>]+>\(w\[(\d)\]\))'
    read = {m[0]: int(m[1] or m[2]) for m in re.findall(
        pat, body[:body.index('if (Q8S) {')] + branch)}
    fields = _STEP_FIELDS[mode]
    assert read == {f: i for i, f in enumerate(fields)}
    _, mrf = _phase_level(14, 128, 64, 1, False, static=True,
                          fused=mode == 'q8f')
    x = torch.zeros((1, 256, 128), dtype=torch.bfloat16)
    plan = mi._ptc_fused_plan(x, mrf, 128, _alloc, geometry=mi._phase_geometry)
    ptrs, ints = mi._ptc_fused_args(plan, mrf, mrf.chains, mrf.ups[:3])
    steps = [st for chain in mrf.chains for st in chain]
    assert len(ptrs) == 4 + len(fields) * len(steps)
    for s_, st in enumerate(steps):
        assert len(st) == len(fields)
        for i, t in enumerate(st):
            assert ptrs[4 + len(fields) * s_ + i] == t.data_ptr()


def _replay_static_phase(C_in, C, p_in, post, block_m, mode):
    rng, mrf = _phase_level(13, C_in, C, p_in, post, static=True,
                            fused=mode == 'q8f')
    assert mrf.mode == mode
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


def _static_level(seed, C, mode):
    """A level's static ct-packed weights (q8f or q8s), calibrated on
    random act scales."""
    rng = np.random.RandomState(seed)
    tp = _bf16(to_torch(unit_level(rng, 0, C)))
    w = mi.pack_mrf_weights(tp, 0, KS, DILS)
    sc = [torch.from_numpy(s) for s1, s2 in act_scales(rng, C)
          for s in (s1, s2)]
    if mode == 'q8s':
        return rng, mi.prepare_mrf_ct_q8s(
            mi.quantize_mrf_ct_q8s_weights(w, sc), KS, DILS)
    return rng, mi.prepare_mrf_ct_q8f(mi.quantize_mrf_ct_q8f_weights(w, sc),
                                      KS, DILS)


def _replay_static(x, mrf):
    """Every block of ``ptc_fused_q8_kernel`` without prologue on
    :func:`mi._static_plan`, each from its own x window."""
    plan = mi._static_plan(x, mrf, _alloc)
    assert plan.amax is None and plan.n_tiles == 1 and plan.P == 0
    assert plan.hx == max(vk.chain_halo(k, d) for k, d in zip(KS, DILS))
    for b in range(x.shape[0]):
        for i in range(plan.blocks_per_tile):
            _emulate_ptc_block(plan, mrf, b, i)
    return plan.out


@pytest.mark.parametrize('C,T', [
    (64, 300),                     # V2 L0's width: 3 blocks, a partial
                                   # last one
    (32, 900),                     # V2 L1's width (and the fallback's)
    (32, 200),                     # one block, longer than the utterance
])
@pytest.mark.parametrize('mode', ['q8f', 'q8s'])
def test_static_noups_replays_plain(mode, C, T):
    """fused_mrf_ct_q8f / _q8s and the static fused_mrf_phase_q8_noups:
    one launch of ptc_fused_q8_kernel without prologue, each block's
    chains on x over their own windows (zero outside the utterance), equal
    to the zero-padded valid chains (``mrf_tc_q8_plain``) at every
    sample; B = 2, one loud stretch."""
    rng, mrf = _static_level(17 + C, C, mode)
    assert mrf.mode == mode
    x = torch.from_numpy((rng.randn(2, T, C) * 0.5).astype(np.float32)
                         ).bfloat16()
    x[1, T // 3:T // 2] *= 5.0
    out = _replay_static(x, mrf)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, vk.mrf_tc_q8_plain(x, mrf))


@pytest.mark.parametrize('C_in,C', sorted(mi.DYN_BLK_CFG))
def test_dyn_blk_cfg_matches_kernel(C_in, C):
    """``DYN_BLK_CFG`` holds the kernel's ``DynCfg`` (mrf_dyn_blk.cuh): the
    rows a block holds, the rows of one MMA pass (``Conv::ROWS`` of its
    warps), the staged weights' shapes and where R lives, from which the
    launcher sizes the global scratch; its stages are ``Q8_STAGES``'. A
    width's chain convs are staged alike whatever the upsample, so the
    weights of a level serve its fallback's kernels."""
    src = (CSRC / 'mrf_dyn_blk.cuh').read_text()
    body = re.search(r'struct DynCfg<%d, %d> \{(.*?)\};' % (C_in, C), src,
                     re.S).group(1)
    k = {m[0]: m[1] for m in re.findall(r'(\w+) = (\w+)', body)}
    nw, wm = int(k['NW']), int(k['WM'])
    wn = min(C, 128)
    rows_pass = (nw // 4) // (C // wn) * 64 * (wm // 16)
    assert mi.DYN_BLK_CFG[C_in, C] == (int(k['WROWS']), rows_pass,
                                       k['R_SMEM'] == 'true')
    st = vk.Q8_STAGES[C_in, C]
    assert st == (int(k['TPS']), int(k['KCH']), int(k['UTPS']),
                  int(k['UKCH']))
    same = [s_ for (ci, co), s_ in vk.Q8_STAGES.items() if co == C]
    assert {(s_.tps, s_.kch) for s_ in same} == {(st.tps, st.kch)}


@pytest.mark.parametrize('C_in,C', sorted(
    set(vk.PTC_Q8_BM) | {(C, C) for C in vk.PTC_Q8_NOUPS_BM}))
def test_ptc_cfg_matches_kernel(C_in, C):
    """``PTC_Q8_BM`` (with upsample) and ``PTC_Q8_NOUPS_BM`` (without,
    C_in == C) hold the kernel's ``PtcCfg`` block (mrf_ptc_fused.cuh), and
    ``Q8_STAGES`` its chain convs' and upsample's stages (without upsample
    the chains' repeated), which the entry point checks; without upsample
    the k = 11 window of a block (BM + 120 rows) fits one MMA pass."""
    src = (CSRC / 'mrf_ptc_fused.cuh').read_text()
    body = re.search(r'struct PtcCfg<%d, %d> \{(.*?)\};' % (C_in, C), src,
                     re.S).group(1)
    k = {m[0]: int(m[1]) for m in re.findall(r'(\w+) = (\d+)', body)}
    bm = vk.PTC_Q8_NOUPS_BM[C] if C_in == C else vk.PTC_Q8_BM[C_in, C]
    assert bm == k['BM']
    assert vk.Q8_STAGES[C_in, C] == (k['TPS'], k['KCH'], k['UTPS'],
                                     k['UKCH'])
    if C_in == C:
        assert (k['UTPS'], k['UKCH']) == (k['TPS'], k['KCH'])
        rows_pass = (k['NW'] // 4) // (C // min(C, 128)) * 64 * (k['WM'] // 16)
        assert k['BM'] + 2 * vk.chain_halo(11, (1, 3, 5)) <= rows_pass

"""CPU replay of the int8-static CUDA routes' launch plans
(daft_exprt_torch/ops/vocoder_kernels.py ``_tc_q8_plan``, mrf_int8.py
``_ptc_fused_plan``): every block of ``tc_chain_q8_kernel`` and of
``ptc_fused_q8_kernel`` (and each ``amax_kernel`` segment) is emulated from
its own input window only, with the arithmetic and the window bookkeeping
its source states, on NaN-filled buffers, and the result must equal the
plain versions at every sample. Also the staged s8 weight packing against
the kernels' indexing, and the s8 tiles' swizzle. The emulators of
``ptc_fused_q8_kernel`` (with and without its upsample prologue) and
``amax_kernel`` live here too; the other int8 plan tests import them.
The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, act_scales, unit_level
from tests.torch_port_utils import max_abs, to_torch


def _nan_alloc(shape, dtype):
    return torch.full(shape, float('nan'), dtype=dtype)


def _read(buf, off, lo, hi, n0, n1):
    """Samples [n0, n1) of ``buf`` (sample n at n + off), zero outside
    [lo, hi), as float32 (B, n1 - n0, C)."""
    n = torch.arange(n0, n1)
    valid = ((n >= lo) & (n < hi))[None, :, None]
    idx = (n + off).clamp(0, buf.shape[1] - 1)
    return torch.where(valid, buf[:, idx, :].float(), torch.zeros(()))


def _chain_window(R, lo, hi, steps, k, dils, out_rows):
    """The kernels' chain on a float32 residual window R (1, rows, C)
    holding valid rows [lo, hi): per step quantise rows [lo, hi), conv1
    over M1 = hi - lo - 2*r1 rows, requantise (q8f: in s32; q8s, eight
    arrays a step: through the float32 dequant), conv2 over M1 - 2*r2 rows
    onto R rows lo + r1 + r2 ...; returns the last step's rows."""
    half = (k - 1) // 2
    for st, d in zip(steps, dils):
        r1 = d * half
        M1 = hi - lo - 2 * r1
        if len(st) == 8:
            wq1, sw1, inv1, b1, wq2, sw2, inv2, b2 = st
            acc = vk._int_conv(vk.quantize_static(vk._lrelu(R[:, lo:hi]),
                                                  inv1), wq1, d, M1)
            q2 = vk.quantize_static(vk._lrelu(vk._fma(acc, sw1, b1)), inv2)
        else:
            wq1, inv1, b1i, m1, wq2, sw2, b2 = st
            acc = vk._int_conv(vk.quantize_lrelu_static(R[:, lo:hi], inv1),
                               wq1, d, M1)
            q2 = vk.requant_lrelu_s32(acc, b1i, m1)
        M2 = M1 - 2 * half
        base = lo + r1 + half
        v = R[:, base:base + M2] + vk._fma(vk._int_conv(q2, wq2, 1, M2),
                                          sw2, b2)
        R = R.clone()
        R[:, base:base + M2] = v
        lo, hi = base, hi - r1 - half
    assert hi - lo == out_rows
    return R[:, lo:hi]


def _emulate_tc_block(st, b, i):
    """What block i of utterance b of one ``tc_chain_q8_kernel`` launch
    computes, from its x window alone."""
    T = st.x.shape[1]
    n0, h, bm = i * st.block_m, st.halo, st.block_m
    R = _read(st.x[b:b + 1], 0, 0, T, n0 - h, n0 + bm + h)
    v = _chain_window(R, 0, bm + 2 * h, st.weights, st.k, st.dils, bm)[0]
    n1 = min(n0 + bm, T)
    v = v[:n1 - n0]
    if st.mode == vk.WRITE:
        st.sum[b, n0:n1] = v
    elif st.mode == vk.ADD:
        st.sum[b, n0:n1] = st.sum[b, n0:n1] + v
    else:
        tot = st.sum[b, n0:n1] + v if st.has_acc else v
        st.out[b, n0:n1] = (tot * st.scale).to(st.out.dtype)


def _emulate_amax(plan):
    """What the ``amax_kernel`` launch computes, per segment."""
    xs = plan.x.float()
    T_in = xs.shape[1]
    for seg in range(plan.amax.shape[0]):
        b, t = divmod(seg, plan.n_tiles)
        s0 = t * plan.tile_in - plan.halo_in
        w = _read(xs[b:b + 1], 0, 0, T_in, s0, s0 + plan.win_len)
        plan.amax[seg] = vk._lrelu(w).abs().max()


def _emulate_ptc_block(plan, mrf, seg, i, means=None):
    """What block i of segment ``seg`` of ``ptc_fused_q8_kernel`` computes,
    from its own x rows and the segment's amax alone (without upsample,
    ``mrf.ups`` None: each chain's window of x, read straight from x); with
    conv_post, the chain mean at its samples also goes to ``means``."""
    b, t = divmod(seg, plan.n_tiles)
    bm, hx, P, s = plan.block_m, plan.hx, plan.P, plan.stride
    n0 = i * bm
    wrows = bm + 2 * hx
    x = plan.x.float()[b:b + 1]
    if mrf.ups is not None:
        wq_u, sw_u, b_u = mrf.ups[:3]
        amax = plan.amax[seg].clamp(min=1e-30)
        inv = torch.full((), 127.0) / amax
        sx = amax * (1.0 / 127.0)
        base_in = t * plan.tile_in + (n0 - hx) // s + plan.amin
        a = vk._lrelu(_read(x, 0, 0, x.shape[1], base_in,
                            base_in + wrows // s + plan.span))
        xq = torch.round(a * inv).to(torch.int8)
    O = None
    for steps, k, dils in zip(mrf.chains, mrf.kernel_sizes, mrf.dilations):
        h = vk.chain_halo(k, dils)
        lo, hi = hx - h - P, hx + bm + h + P
        R = torch.full((1, wrows, x.shape[2] if mrf.ups is None
                        else wq_u.shape[-1]), float('nan'))
        if mrf.ups is None:
            s0 = t * plan.tile_in + n0 - hx
            R[:, lo:hi] = _read(x, 0, 0, x.shape[1], s0 + lo, s0 + hi)
        else:
            mm0 = lo // s
            mu = -(-hi // s) - mm0
            for r in range(s):
                acc = vk._int_conv(xq[:, mm0 + plan.rows[r]:], wq_u[r], 1,
                                   mu)
                R[:, s * mm0 + r:s * (mm0 + mu):s] = vk._fma(
                    acc, sw_u[r] * sx, b_u)
        v = _chain_window(R, lo, hi, steps, k, dils, bm + 2 * P)
        O = v if O is None else O + v
    n1 = min(n0 + bm, plan.N) - n0
    g0 = t * plan.N + n0
    if not plan.kpost:
        plan.out[b, g0:g0 + n1] = (O[0, :n1] * plan.scale).to(plan.out.dtype)
        return
    means[b, g0:g0 + n1] = (O[0, P:P + n1] * plan.scale)
    w, bias, pdt = mrf.post
    q = vk._lrelu(O * plan.scale).to(pdt).float().transpose(1, 2)
    y = F.conv1d(q, w.t()[None]) + bias
    plan.out[b, 0, g0:g0 + n1] = torch.tanh(y[0, 0, :n1]).to(plan.out.dtype)


def _ptc_level(seed, C_in, C, p_in, post, dtype):
    rng = np.random.RandomState(seed)
    p = 2 * p_in
    tp = to_torch(unit_level(rng, 1, C, C_in=C_in, post=post))
    tp = {k: {kk: (vv.to(dtype) if torch.is_tensor(vv) else
                   {a: t.to(dtype) for a, t in vv.items()})
              for kk, vv in v.items()} for k, v in tp.items()}
    scales = [tuple(torch.from_numpy(s) for s in e)
              for e in act_scales(rng, C)]
    packed = vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p, scales)
    ups = vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2, 1,
                                  p_in)
    pst = None
    if post:
        pst = vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                       tp['conv_post']['b'], p, dtype)
    return rng, vk.prepare_mrf_ptc(packed, KS, DILS, p,
                                   tuple(ups) + (4, 2, 1, p_in), pst)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tc_q8_launch_plan_replays_plain(dtype):
    """Blocks of 64 samples over T = 200 (a partial last block), B = 2:
    block boundaries inside the level and both utterance edges."""
    rng = np.random.RandomState(3)
    C = 32
    tp = to_torch(unit_level(rng, 0, C))
    scales = [tuple(torch.from_numpy(s) for s in e)
              for e in act_scales(rng, C)]
    mrf = vk.prepare_mrf_tc_q8(
        vk.pack_mrf_tc_int8_weights(tp, 0, KS, DILS, scales), KS, DILS)
    x = torch.from_numpy((rng.randn(2, 200, C) * 0.5).astype(np.float32)
                         ).to(dtype)
    launches, out = vk._tc_q8_plan(x, mrf.chains, KS, DILS, _nan_alloc,
                                   block_m=64)
    assert [st.mode for st in launches] == [vk.WRITE, vk.ADD, vk.FINAL]
    assert [st.n_blocks for st in launches] == [4] * 3
    for st in launches:
        for b in range(2):
            for i in range(st.n_blocks):
                _emulate_tc_block(st, b, i)
    ref = vk.mrf_tc_q8_plain(x, mrf)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize('C_in,C,p_in,post,block_m', [
    (64, 32, 1, False, 32),       # V1 L2's geometry at half width
    (64, 32, 1, False, 48),       # a block that does not divide the tile
    (32, 16, 2, True, 64),        # V1 L3's geometry at half width
    (32, 16, 2, True, 256),       # one block per tile, the kernel's size
])
def test_ptc_launch_plan_replays_plain(C_in, C, p_in, post, block_m):
    """Three tiles of 64 rows per utterance, B = 2, one tile loud (its own
    upsample scale): JAX-tile and segment edges, block edges inside a
    tile, both utterance edges, with and without conv_post; float32, so
    every sample must be equal."""
    dtype = torch.float32
    rng, mrf = _ptc_level(5, C_in, C, p_in, post, dtype)
    rows, tile = 192, 64
    x = torch.from_numpy((rng.randn(2, rows * p_in, C_in) * 0.5)
                         .astype(np.float32)).to(dtype)
    x[1, :64 * p_in] *= 5.0
    plan = mi._ptc_fused_plan(x, mrf, tile, _nan_alloc, block_m=block_m)
    assert (plan.kpost > 0) == post and plan.P == (3 if post else 0)
    assert plan.hx == (64 if post else 60)
    _emulate_amax(plan)
    means = _nan_alloc((2, rows * 2 * p_in, C), dtype)
    for seg in range(plan.amax.shape[0]):
        for i in range(plan.blocks_per_tile):
            _emulate_ptc_block(plan, mrf, seg, i, means)
    ref = mi.mrf_ptc_plain(x, mrf, tile)
    out = plan.out
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    if post:
        # the chain mean exactly; conv_post's float32 sum (7 x C terms) in
        # another order than F.conv1d's: a few ulps of tanh's output
        ref_mean = mi.mrf_ptc_plain(x, replace(mrf, post=None), tile)
        assert float((means - ref_mean).abs().max()) == 0.0
        assert float((out - ref).abs().max()) <= 1e-6
    else:
        assert float((out - ref).abs().max()) == 0.0


@pytest.mark.parametrize('C,tps,kch', [
    (32, 8, 32), (64, 4, 64), (128, 1, 128), (256, 1, 128),
    ((64, 32), 2, 64), ((128, 64), 2, 128)])
def test_pack_stage_s8_matches_kernel_indexing(C, tps, kch):
    """Conv::run (mrf_chain_q8.cuh) reads stage s = g*KC + kc at byte
    s*STAGE and, for tap tp, k-step ks and n-tile pair np, lane l supplies
    the ldmatrix row address swz<kch>(n, 32*ks + 16*((l >> 3) & 1)) of
    n = 16*np + 8*(l >> 4) + (l & 7) in tap tp's [n][kch] tile; lane (g, t)
    of matrix j then holds bytes 4t..4t+3 of the row lane 8j + g gave:
    b0 = W[k0 + 4t + e][n], b1 = W[k0 + 16 + 4t + e][n] for the n-tile."""
    ci, co = C if isinstance(C, tuple) else (C, C)
    rng = np.random.RandomState(1)
    taps = 11 if tps > 2 else 3
    w = torch.from_numpy(rng.randint(-127, 128, (taps, ci, co))
                         .astype(np.int8))
    packed = vk.pack_stage_s8(w, tps, kch).numpy()
    KC, G = ci // kch, -(-taps // tps)
    stage = tps * co * kch
    assert packed.size == G * KC * stage
    key = vk.swizzle_key(co, kch).numpy()
    wn = w.numpy()

    def swz(n, byte):
        return n * kch + (((byte >> 4) ^ key[n]) << 4) + (byte & 15)

    for s_ in range(G * KC):
        g, kc = divmod(s_, KC)
        Ws = packed[s_ * stage:(s_ + 1) * stage]
        for tp in range(tps):
            tap = g * tps + tp
            Wt = Ws[tp * co * kch:(tp + 1) * co * kch]
            if tap >= taps:
                assert not Wt.any()
                continue
            for ks in range(kch // 32):
                for np_ in range(co // 16):
                    rows = [Wt[swz(16 * np_ + 8 * (l >> 4) + (l & 7),
                                   32 * ks + 16 * ((l >> 3) & 1)):][:16]
                            for l in range(32)]
                    for lane in range(32):
                        g_, t = lane // 4, lane % 4
                        frag = [rows[8 * j + g_][4 * t:4 * t + 4]
                                for j in range(4)]
                        for half_, nt in ((0, 2 * np_), (2, 2 * np_ + 1)):
                            n = 8 * nt + g_
                            k0 = kc * kch + 32 * ks + 4 * t
                            assert np.array_equal(frag[half_],
                                                  wn[tap, k0:k0 + 4, n])
                            assert np.array_equal(
                                frag[half_ + 1], wn[tap, k0 + 16:k0 + 20, n])


@pytest.mark.parametrize('row_bytes', [32, 64, 128, 256])
def test_swizzle_spreads_ldmatrix_rows_over_banks(row_bytes):
    """Any 8 consecutive rows of an s8 tile read at one logical 16-byte
    chunk (one ldmatrix matrix, whatever a tap's row offset) land on 8
    distinct 16-byte bank groups, and the swizzle permutes each row's
    chunks."""
    key = vk.swizzle_key(64, row_bytes).numpy()
    chunks = row_bytes // 16
    for c in range(chunks):
        for r0 in range(48):
            groups = {((r * row_bytes + 16 * (c ^ key[r])) // 16) % 8
                      for r in range(r0, r0 + 8)}
            assert len(groups) == 8
    for r in range(64):
        assert sorted(c ^ key[r] for c in range(chunks)) == list(
            range(chunks))


@pytest.mark.parametrize('row_bytes', [32, 64, 128])
def test_swizzle_is_the_wgmma_descriptor_layout(row_bytes):
    """A staged weight tile (rows of kch bytes, swz<kch>) is what a wgmma
    descriptor with the 32/64/128-byte swizzle reads: byte offset o of the
    unswizzled tile lives at o ^ (((o >> 7) & (row_bytes/16 - 1)) << 4)
    (bits 4.. of the offset XORed with bits 7..), for tiles that start on
    a swizzle atom (8 rows)."""
    key = vk.swizzle_key(64, row_bytes).numpy()
    mask = row_bytes // 16 - 1
    for r in range(64):
        for byte in range(row_bytes):
            o = r * row_bytes + byte
            ours = r * row_bytes + (((byte >> 4) ^ key[r]) << 4) + (byte & 15)
            assert ours == o ^ (((o >> 7) & mask) << 4)


def test_prepare_mrf_ptc_taps_are_every_phase():
    """The per-tap weights read from phase 0 of the shift matrices are
    the weights of every output phase (one int8 value per (tap, ci, co)
    and phase-independent scales), and the tc packer gives the same ones."""
    rng = np.random.RandomState(6)
    C, p = 16, 4
    tp = to_torch(unit_level(rng, 0, C))
    scales = [tuple(torch.from_numpy(s) for s in e)
              for e in act_scales(rng, C)]
    packed = vk.pack_mrf_ptc_weights(tp, 0, KS, DILS, p, scales)
    tc = vk.prepare_mrf_tc_q8(
        vk.pack_mrf_tc_int8_weights(tp, 0, KS, DILS, scales), KS, DILS)
    n = 0
    for j, (k, dils) in enumerate(zip(KS, DILS)):
        half = (k - 1) // 2
        for i, d in enumerate(dils):
            q1, inv1, b1i, m1, q2, sw2, b2 = packed[n:n + 7]
            n += 7
            spec = vk._ptc_spec(k, d, p)
            for r in range(p):
                for t in range(k):
                    s_, a = divmod(r + d * (t - half), p)
                    blk = q1[spec['shifts'].index(s_), a * C:(a + 1) * C,
                             r * C:(r + 1) * C]
                    assert torch.equal(blk, tc.chains[j][i][0][t])
            for vec, want in ((inv1, 1), (b1i, 2), (m1, 3), (sw2, 5),
                              (b2, 6)):
                assert torch.equal(vec[0], tc.chains[j][i][want].repeat(p))


def test_q8_wrappers_run_plain_versions_on_cpu():
    rng, mrf = _ptc_level(7, 32, 16, 2, True, torch.float32)
    assert mrf.chains_dev is None and mrf.ups_dev is None
    x = torch.from_numpy((rng.randn(1, 128, 32) * 0.5).astype(np.float32))
    n, calls = mi.fused_mrf_ptc.launches, sum(mi.fused_mrf_ptc.calls.values())
    assert torch.equal(mi.fused_mrf_ptc(x, mrf, 64),
                       mi.mrf_ptc_plain(x, mrf, 64))
    assert mi.fused_mrf_ptc.launches == n
    assert sum(mi.fused_mrf_ptc.calls.values()) == calls
    with pytest.raises(ValueError, match='multiple of tile'):
        mi.fused_mrf_ptc(x, mrf, 48)
    tp = to_torch(unit_level(rng, 0, 32))
    scales = [tuple(torch.from_numpy(s) for s in e)
              for e in act_scales(rng, 32)]
    tc = vk.prepare_mrf_tc_q8(
        vk.pack_mrf_tc_int8_weights(tp, 0, KS, DILS, scales), KS, DILS)
    xt = torch.from_numpy((rng.randn(1, 64, 32) * 0.5).astype(np.float32))
    n = vk.fused_mrf_tc_q8.launches
    assert torch.equal(vk.fused_mrf_tc_q8(xt, tc), vk.mrf_tc_q8_plain(xt, tc))
    assert vk.fused_mrf_tc_q8.launches == n
    assert max_abs(vk.mrf_tc_q8_plain(xt, tc).numpy(), xt.numpy()) > 0.05

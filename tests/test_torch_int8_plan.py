"""CPU replay of the int8-static CUDA routes' launch plans
(daft_exprt_torch/ops/vocoder_kernels.py ``_tc_plan`` with q8 steps and
mrf_int8.py ``_ptc_plan``): each launch of ``step_q8_kernel``, ``amax_kernel``,
``ups_q8_kernel`` and ``post_kernel`` is emulated with the arithmetic its
source states, on NaN-filled buffers, and the result must equal the plain
versions. Also the s8 B-fragment packing against the kernel's indexing.
The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, act_scales, unit_level
from tests.torch_port_utils import max_abs, rel_l2, to_torch


def _nan_alloc(shape, dtype):
    return torch.full(shape, float('nan'), dtype=dtype)


def _read(buf, off, lo, hi, n0, n1):
    """Samples [n0, n1) of ``buf`` (sample n at n + off), zero outside
    [lo, hi), as float32 (B, n1 - n0, C)."""
    n = torch.arange(n0, n1)
    valid = ((n >= lo) & (n < hi))[None, :, None]
    idx = (n + off).clamp(0, buf.shape[1] - 1)
    return torch.where(valid, buf[:, idx, :].float(), torch.zeros(()))


def _emulate_q8_step(st):
    """What one ``step_q8_kernel`` launch computes (q8f, or q8s when the
    step holds eight weight arrays)."""
    h = (st.k - 1) // 2
    r = st.d * h
    n = st.n_hi - st.n_lo
    win = _read(st.src, st.src_off, st.src_lo, st.src_hi, st.n_lo - h - r,
                st.n_hi + h + r)
    if len(st.weights) == 8:
        wq1, sw1, inv1, b1, wq2, sw2, inv2, b2 = st.weights
        acc = vk._int_conv(vk.quantize_static(vk._lrelu(win), inv1), wq1,
                           st.d, n + 2 * h)
        q2 = vk.quantize_static(vk._lrelu(vk._fma(acc, sw1, b1)), inv2)
    else:
        wq1, inv1, b1i, m1, wq2, sw2, b2 = st.weights
        acc = vk._int_conv(vk.quantize_lrelu_static(win, inv1), wq1, st.d,
                           n + 2 * h)
        q2 = vk.requant_lrelu_s32(acc, b1i, m1)
    acc2 = vk._int_conv(q2, wq2, 1, n)
    v = _read(st.src, st.src_off, st.src_lo, st.src_hi, st.n_lo, st.n_hi) \
        + vk._fma(acc2, sw2, b2)
    sl = slice(st.n_lo + st.dst_off, st.n_hi + st.dst_off)
    if st.mode == vk.WRITE:
        st.dst[:, sl] = v
    elif st.mode == vk.ADD:
        st.dst[:, sl] = st.dst[:, sl] + v
    else:
        tot = st.dst[:, sl] + v if st.has_acc else v
        st.fin[:, st.n_lo:st.n_hi] = (tot * st.scale).to(st.fin.dtype)


def _emulate_prologue(pro, mrf):
    """What the ``amax_kernel`` and ``ups_q8_kernel`` launches compute."""
    wq_u, sw_u, b_u = mrf.ups[:3]
    B, T_in, C_in = pro.x.shape
    xs = pro.x.float()
    for seg in range(pro.amax.shape[0]):
        b, t = divmod(seg, pro.n_tiles)
        s0 = t * pro.tile_in - pro.halo_in
        w = _read(xs[b:b + 1], 0, 0, T_in, s0, s0 + pro.win_len)
        pro.amax[seg] = vk._lrelu(w).abs().max()
        amax = pro.amax[seg].clamp(min=1e-30)
        g0 = t * pro.tile_in - pro.halo_m + pro.amin
        a = vk._lrelu(_read(xs[b:b + 1], 0, 0, T_in, g0,
                            g0 + pro.m_len + pro.span))
        q = torch.round(a * (torch.full((), 127.0) / amax)).to(torch.int8)
        sx = amax * (1.0 / 127.0)
        for r in range(pro.stride):
            acc = vk._int_conv(q[:, pro.rows[r]:], wq_u[r], 1, pro.m_len)
            pro.x0[seg, r::pro.stride] = vk._fma(acc, sw_u[r] * sx, b_u)[0]


def _emulate_post(tail, mrf, N):
    w, b, pdt = mrf.post
    h = (tail.k - 1) // 2
    src = tail.src[:, tail.src_off - h:tail.src_off + N + h].transpose(1, 2)
    t = vk._lrelu(src * tail.scale).to(pdt).float()
    y = F.conv1d(t, w.t()[None]) + b
    tail.out.view(-1, N)[:] = torch.tanh(y[:, 0]).to(tail.out.dtype)


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
    rng = np.random.RandomState(3)
    C = 32
    tp = to_torch(unit_level(rng, 0, C))
    scales = [tuple(torch.from_numpy(s) for s in e)
              for e in act_scales(rng, C)]
    mrf = vk.prepare_mrf_tc_q8(
        vk.pack_mrf_tc_int8_weights(tp, 0, KS, DILS, scales), KS, DILS)
    x = torch.from_numpy((rng.randn(2, 200, C) * 0.5).astype(np.float32)
                         ).to(dtype)
    steps, out = vk._tc_plan(x, mrf.chains, KS, DILS, _nan_alloc)
    assert len(steps) == 9
    for st in steps:
        _emulate_q8_step(st)
    ref = vk.mrf_tc_q8_plain(x, mrf)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize('C_in,C,p_in,post', [
    (64, 32, 1, False),           # V1 L2's geometry at half width
    (32, 16, 2, True),            # V1 L3's geometry at half width
])
def test_ptc_launch_plan_replays_plain(C_in, C, p_in, post):
    dtype = torch.bfloat16
    rng, mrf = _ptc_level(5, C_in, C, p_in, post, dtype)
    rows, tile = 192, 64
    x = torch.from_numpy((rng.randn(2, rows * p_in, C_in) * 0.5)
                         .astype(np.float32)).to(dtype)
    x[1, :64 * p_in] *= 5.0
    plan = mi._ptc_plan(x, mrf, tile, mrf.chains, _nan_alloc)
    assert len(plan.steps) == 9 and (plan.tail is None) == (not post)
    _emulate_prologue(plan.pro, mrf)
    for st in plan.steps:
        _emulate_q8_step(st)
    if post:
        _emulate_post(plan.tail, mrf, tile * mrf.p)
    ref = mi.mrf_ptc_plain(x, mrf, tile)
    out = plan.out
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    if post:       # conv_post sums in another order
        assert rel_l2(out.float().numpy(), ref.float().numpy()) < 1e-3
    else:
        assert torch.equal(out, ref)


def test_pack_mma_s8_matches_kernel_indexing():
    """conv_gemm_s8 reads uint2 word ((tap*NT8 + nt)*KT + kt)*32 + lane and
    feeds b0 = W[k0 + 4t + e][n], b1 = W[k0 + 16 + 4t + e][n] (e < 4) with
    n = 8*nt + lane//4, t = lane % 4, k0 = 32*kt."""
    rng = np.random.RandomState(0)
    taps, ci, co = 3, 64, 24
    w = torch.from_numpy(rng.randint(-127, 128, (taps, ci, co))
                         .astype(np.int8))
    packed = vk.pack_mma_s8(w).numpy().reshape(-1, 8)
    wn = w.numpy()
    NT8, KT = co // 8, ci // 32
    for tap in range(taps):
        for nt in range(NT8):
            for kt in range(KT):
                for lane in range(32):
                    word = packed[((tap * NT8 + nt) * KT + kt) * 32 + lane]
                    n, t = 8 * nt + lane // 4, lane % 4
                    k0 = 32 * kt + 4 * t
                    want = [wn[tap, k0 + e, n] for e in range(4)] + \
                        [wn[tap, k0 + 16 + e, n] for e in range(4)]
                    assert np.array_equal(word, want)


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

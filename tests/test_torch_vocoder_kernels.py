"""The port's MRF kernels (daft_exprt_torch/ops/vocoder_kernels.py) against
the JAX package's Pallas kernels (run in interpret mode on the CPU).

- The plain versions of ``fused_mrf_tc`` and ``fused_mrf_phase`` equal the
  JAX kernels at every sample, utterance edges included: the TPU kernels'
  valid-conv-over-padded-input function is tile independent, and the plain
  versions compute that function directly.
- The step route's launch plan (``fused_mrf_ct``'s: sample ranges, buffer
  offsets, modes) is replayed on the CPU by emulating each launch, and
  must equal the plain version (the engines' plans are replayed in
  ``tests/test_torch_bf16_engine.py`` and ``test_torch_f32_engine.py``);
  the fragment packing is checked against the kernel's indexing.
- On the card the kernels are held to the plain versions by
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models.hifigan import _pallas_mrf_phase
from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.torch_port_utils import (
    max_abs, mrf_params, rel_l2, to_torch,
)

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _phase_case(rng, C_in, C, post):
    params = mrf_params(rng, 1, C, KS, DILS)
    params['ups_1'] = {'w': (rng.randn(C_in, C, 4) * 0.05).astype(np.float32),
                       'b': (rng.randn(C) * 0.05).astype(np.float32)}
    if post:
        params['conv_post'] = {
            'w': (rng.randn(1, C, 7) * 0.1).astype(np.float32),
            'b': (rng.randn(1) * 0.05).astype(np.float32)}
    return params


def _port_phase_args(tp, post):
    ups = (tp['ups_1']['w'], tp['ups_1']['b'], 2, 1)
    pst = (tp['conv_post']['w'], tp['conv_post']['b']) if post else None
    return vk.pack_mrf_tc_weights(tp, 1, KS, DILS), ups, pst


@pytest.mark.parametrize('C', [128, 256])
def test_mrf_tc_plain_matches_jax_all_samples(C):
    rng = np.random.RandomState(C)
    params = mrf_params(rng, 0, C, KS, DILS, w_scale=0.03)
    x = (rng.randn(2, 256, C) * 0.5).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(jvk.fused_mrf_tc(
        jnp.asarray(x), jvk.pack_mrf_tc_weights(jp, 0, KS, DILS), KS, DILS,
        tile=128, interpret=True))
    out = vk.mrf_tc_plain(torch.from_numpy(x), vk.pack_mrf_tc_weights(
        to_torch(params), 0, KS, DILS), KS, DILS)
    assert out.shape == ref.shape
    # every sample, edges included (f32 band 1e-5)
    assert max_abs(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize('p_in,p,C_in,C,post', [
    (1, 2, 128, 64, False),       # V1 L2: prologue, no epilogue
    (2, 4, 64, 32, True),         # V1 L3: prologue + conv_post epilogue
    (2, 4, 64, 32, False),
])
def test_mrf_phase_plain_matches_jax_all_samples(p_in, p, C_in, C, post):
    rng = np.random.RandomState(10 * p + C)
    params = _phase_case(rng, C_in, C, post)
    x = (rng.randn(2, C_in, 128) * 0.5).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y, applied = _pallas_mrf_phase(
        jp, jvk.to_phase(jnp.asarray(x), p_in), 1,
        {'resblock_kernel_sizes': KS, 'resblock_dilation_sizes': DILS}, p,
        post=jp['conv_post'] if post else None,
        ups=dict(jp['ups_1'], stride=2, padding=1, p_in=p_in),
        interpret=True)
    assert applied == post
    ref = np.asarray(jvk.from_phase(y, p))
    w, ups, pst = _port_phase_args(to_torch(params), post)
    out = vk.mrf_phase_plain(torch.from_numpy(x), w, KS, DILS, ups, pst)
    assert out.shape == ref.shape
    assert max_abs(out.numpy(), ref) < 1e-5


# ----------------------------------------------------------------------
# CPU replay of the CUDA launch plans
# ----------------------------------------------------------------------

def _nan_alloc(shape, dtype):
    """Buffers start as NaN, so a launch that reads a sample no earlier
    launch wrote poisons the result."""
    return torch.full(shape, float('nan'), dtype=dtype)


def _read(buf, off, lo, hi, n0, n1):
    n = torch.arange(n0, n1)
    valid = ((n >= lo) & (n < hi))[None, :, None]
    idx = (n + off).clamp(0, buf.shape[1] - 1)
    return torch.where(valid, buf[:, idx, :].float(), torch.zeros(()))


def _emulate_step(st, cdt):
    """What one ``step_kernel`` launch computes."""
    w1, b1, w2, b2 = st.weights
    h = (st.k - 1) // 2
    r = st.d * h
    win = _read(st.src, st.src_off, st.src_lo, st.src_hi,
                st.n_lo - h - r, st.n_hi + h + r).transpose(1, 2)
    t = vk._lrelu(win).to(cdt).float()
    a = F.conv1d(t, w1.permute(2, 1, 0).float(), dilation=st.d) \
        + b1.float()[:, None]
    t2 = vk._lrelu(a).to(cdt).float()
    a2 = F.conv1d(t2, w2.permute(2, 1, 0).float()) + b2.float()[:, None]
    res = _read(st.src, st.src_off, st.src_lo, st.src_hi, st.n_lo, st.n_hi)
    v = res + a2.transpose(1, 2)
    sl = slice(st.n_lo + st.dst_off, st.n_hi + st.dst_off)
    if st.mode == vk.WRITE:
        st.dst[:, sl] = v
    elif st.mode == vk.ADD:
        st.dst[:, sl] = st.dst[:, sl] + v
    else:
        tot = st.dst[:, sl] + v if st.has_acc else v
        st.fin[:, st.n_lo:st.n_hi] = (tot * st.scale).to(st.fin.dtype)


def _assert_replay_close(out, ref, dtype):
    # float32: the same arithmetic up to summation order. bf16: a different
    # summation order can flip the rounding of an intermediate to bf16.
    if dtype == torch.float32:
        assert max_abs(out, ref) < 1e-5
    else:
        assert rel_l2(out.float(), ref.float()) < 1e-3


def _plain_prep(weights, dilations):
    return [[tuple(t[i] for t in weights[4 * j:4 * j + 4])
             for i in range(len(d))] for j, d in enumerate(dilations)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tc_launch_plan_replays_plain(dtype):
    rng = np.random.RandomState(3)
    C = 16
    tp = to_torch(mrf_params(rng, 0, C, KS, DILS))
    w = [t.to(dtype) for t in vk.pack_mrf_tc_weights(tp, 0, KS, DILS)]
    x = torch.from_numpy((rng.randn(2, 200, C) * 0.5).astype(np.float32)
                         ).to(dtype)
    steps, out = vk._tc_plan(x, _plain_prep(w, DILS), KS, DILS, _nan_alloc)
    assert len(steps) == 9
    for st in steps:
        _emulate_step(st, dtype)
    ref = vk.mrf_tc_plain(x, w, KS, DILS)
    assert torch.isfinite(out.float()).all()
    _assert_replay_close(out, ref, dtype)


def test_pack_mma_matches_kernel_indexing():
    """conv_gemm reads uint2 word ((tap*NT8 + nt)*KT + kt)*32 + lane and
    feeds b0,b1 = W[k0 + 2t + {0,1}][n], b2,b3 = W[k0 + 8 + 2t + {0,1}][n]
    with n = 8*nt + lane//4, t = lane % 4, k0 = 16*kt."""
    rng = np.random.RandomState(0)
    taps, ci, co = 3, 32, 24
    w = torch.from_numpy(rng.randn(taps, ci, co).astype(np.float32))
    packed = vk.pack_mma(w).float().numpy().reshape(-1, 4)
    wb = w.to(torch.bfloat16).float().numpy()
    NT8, KT = co // 8, ci // 16
    for tap in range(taps):
        for nt in range(NT8):
            for kt in range(KT):
                for lane in range(32):
                    word = packed[((tap * NT8 + nt) * KT + kt) * 32 + lane]
                    n, t = 8 * nt + lane // 4, lane % 4
                    k0 = 16 * kt + 2 * t
                    want = [wb[tap, k0, n], wb[tap, k0 + 1, n],
                            wb[tap, k0 + 8, n], wb[tap, k0 + 9, n]]
                    assert np.array_equal(word, want)


def test_ups_geometry_is_the_transposed_conv():
    """Phase r of output sample s*m + r sums taps at input
    m + amin + rows[r] + t with kernel index taps[r][t]: the same sum as
    ConvTranspose1d(k, s, p)."""
    for k, s in ((4, 2), (16, 8), (6, 2)):
        p = (k - s) // 2
        nt, amin, rows, span, taps = vk.ups_geometry(k, s, p)
        for r in range(s):
            for m in range(-3, 4):
                got = {(m + amin + rows[r] + t, taps[r][t]) for t in range(nt)}
                want = {(i, s * m + r + p - s * i) for i in range(m - 9, m + 9)
                        if 0 <= s * m + r + p - s * i < k}
                assert got == want
                assert all(0 <= rows[r] + t <= span for t in range(nt))


def test_wrappers_run_plain_versions_on_cpu():
    rng = np.random.RandomState(5)
    tp = to_torch(_phase_case(rng, 64, 32, True))
    w, ups, pst = _port_phase_args(tp, True)
    mrf = vk.prepare_mrf(w, KS, DILS, ups, pst)
    # CPU weights carry no kernel format
    assert mrf.chains is None and mrf.blk is None and mrf.blk_ups is None \
        and mrf.post_dev is None
    x = torch.from_numpy((rng.randn(1, 64, 64) * 0.5).astype(np.float32))
    n_phase = vk.fused_mrf_phase.launches
    calls_phase = sum(vk.fused_mrf_phase.calls.values())
    assert torch.equal(vk.fused_mrf_phase(x, mrf),
                       vk.mrf_phase_plain(x, w, KS, DILS, ups, pst))
    xt = torch.from_numpy((rng.randn(1, 64, 32) * 0.5).astype(np.float32))
    n_tc = vk.fused_mrf_tc.launches
    calls_tc = sum(vk.fused_mrf_tc.calls.values())
    assert torch.equal(vk.fused_mrf_tc(xt, vk.prepare_mrf(w, KS, DILS)),
                       vk.mrf_tc_plain(xt, w, KS, DILS))
    # the CPU route launches no kernel and counts no call
    assert vk.fused_mrf_phase.launches == n_phase
    assert vk.fused_mrf_tc.launches == n_tc
    assert sum(vk.fused_mrf_phase.calls.values()) == calls_phase
    assert sum(vk.fused_mrf_tc.calls.values()) == calls_tc
    with pytest.raises(ValueError, match='no upsample'):
        vk.fused_mrf_phase(x, vk.prepare_mrf(w, KS, DILS))


def test_pack_levels_routes_v1():
    """V1: the wide levels (C = 256, 128) take the tc kernel with no fused
    upsample; the narrow ones (C = 64, 32) the phase kernel with their
    upsample, and conv_post only at the last level."""
    from daft_exprt_torch.models import hifigan as th
    params = th.init_generator_params(0, th.DEFAULT_CONFIG, device='cpu')
    levels = th.pack_levels(params)
    assert sorted(levels) == [0, 1, 2, 3]
    for i, C in enumerate((256, 128, 64, 32)):
        mrf = levels[i]
        assert mrf.packed[0].shape == (3, 3, C, C)
        assert (mrf.ups is None) == (i < 2)
        assert (mrf.post is None) == (i < 3)
    assert levels[2].ups[2:] == (2, 1) and levels[3].ups[2:] == (2, 1)
    assert levels[3].post[0] is params['conv_post']['w']

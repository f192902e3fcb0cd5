"""The port's MRF kernels (daft_exprt_torch/ops/vocoder_kernels.py) against
the JAX package's Pallas kernels (run in interpret mode on the CPU).

- The plain versions of ``fused_mrf_tc`` and ``fused_mrf_phase`` equal the
  JAX kernels at every sample, utterance edges included: the TPU kernels'
  valid-conv-over-padded-input function is tile independent, and the plain
  versions compute that function directly.
- The engines' launch plans are replayed in
  ``tests/test_torch_bf16_engine.py``, ``test_torch_f32_engine.py`` and
  ``test_torch_v2_engine.py``.
- On the card the kernels are held to the plain versions by
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models.hifigan import _pallas_mrf_phase
from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.torch_port_utils import max_abs, mrf_params, to_torch

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
    assert mrf.blk is None and mrf.blk_ups is None and mrf.post_dev is None
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

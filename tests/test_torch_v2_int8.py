"""The int8 MRF kernels of HiFi-GAN V2's levels (daft_exprt_torch/ops/
mrf_int8.py) against the JAX package's Pallas kernels in interpret mode.

- ``fused_mrf_ct``'s q8f packing (act scales folded into the per-tap
  weights, fused s32 boundary; its wrapper packs under ``jax.jit``) against
  the port's ``quantize_mrf_ct_q8f_weights``, bit for bit.
- Plain versions against the Pallas kernels: ``mrf_ct_q8f_plain`` vs
  ``fused_mrf_ct(int8_chain=True, act_scales=...)`` and ``mrf_ct_q8_plain``
  vs ``fused_mrf_ct(int8_chain=True)`` at V2's C = 64 and 32;
  ``mrf_phase_q8_noups_plain`` vs ``fused_mrf_phase(int8_chain=True,
  in_phase=False)`` (no upsample prologue) at V2's L1 (C = 32, p = 4), in
  its q8 and q8f modes. Three tiles, one loud (in the dynamic mode each
  tile quantises with its own scales). The port runs on the per-tap
  weights of its own ct packer, which equal the JAX wrappers' jitted
  weights (the phase kernel's banded ones read back by tap). Band rel-L2
  <= 1e-4 (tests/test_torch_int8_dynamic.py's): the s32 sums are exact and
  every float32 step keeps JAX's order.
- The engine's launch plan held to the Pallas kernel itself: the dynamic
  ``fused_mrf_ct`` at V2's L0 width replayed block by block on JAX's
  jitted weights (tests/test_torch_dyn_engine.py replays every V2 int8
  route against the plain versions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_int8 as mi

from tests.test_torch_int8 import KS, DILS, _t, act_scales, unit_level
from tests.test_torch_int8_dynamic import (
    _jax_ct_q8_weights, _jax_phase_q8_weights, _jp, _tp,
)
from tests.test_torch_dyn_engine import _replay
from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


@jax.jit
def _jax_ct_q8f_weights(weights, scales):
    """``fused_mrf_ct``'s q8f weight preparation (:403-420), under jit."""
    qw = []
    for j in range(0, len(weights), 4):
        w1, b1, w2, b2 = weights[j:j + 4]
        n_dil, _, c_out, _ = w1.shape
        w1f, inv1 = jvk.fold_act_scales_taps(w1, scales[j // 2])
        wq1, sw1 = jvk.quantize_rows(w1f, row_axes=(0, 2))
        sw1 = sw1.reshape(n_dil, c_out, 1)
        w2f, inv2 = jvk.fold_act_scales_taps(w2, scales[j // 2 + 1])
        wq2, sw2 = jvk.quantize_rows(w2f, row_axes=(0, 2))
        b1i, m1 = jvk._fuse_boundary_consts(sw1, b1, inv2)
        qw += [wq1, inv1, b1i, m1, wq2, sw2.reshape(n_dil, c_out, 1),
               b2.astype(jnp.float32)]
    return qw


def _level(C, seed, static):
    """bf16 params of one level, its ct scales (per conv: conv1 stack,
    conv2 stack), the port's ct-packed weights and the JAX packer's."""
    rng = np.random.RandomState(seed)
    jp = _jp(unit_level(rng, 0, C))
    tp = _tp(jp)
    cal = act_scales(rng, C) if static else None
    jw = jvk.pack_mrf_weights(jp, 0, KS, DILS)
    tw = mi.pack_mrf_weights(tp, 0, KS, DILS)
    if static:
        ct_scales = [s for s1, s2 in cal for s in (s1, s2)]
        mrf = mi.prepare_mrf_ct_q8f(mi.quantize_mrf_ct_q8f_weights(
            tw, [torch.from_numpy(s) for s in ct_scales]), KS, DILS)
        return rng, jp, jw, [jnp.asarray(s) for s in ct_scales], cal, mrf
    mrf = mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(tw), KS, DILS)
    return rng, jp, jw, None, cal, mrf


def _x(rng, C, T, tile):
    x = (rng.randn(2, T, C) * 0.5).astype(np.float32)
    x[1, tile:2 * tile] *= 6.0
    return x


def _jax_out(y):
    return np.asarray(y.astype(jnp.float32)).transpose(0, 2, 1)


def test_ct_q8f_packer_matches_jax_jit():
    rng, jp, jw, sc, _, _ = _level(64, 0, True)
    tw = mi.pack_mrf_weights(_tp(jp), 0, KS, DILS)
    got = mi.quantize_mrf_ct_q8f_weights(
        tw, [torch.from_numpy(np.array(s)) for s in sc])
    want = _jax_ct_q8f_weights(jw, sc)
    assert len(got) == len(want) == 21
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    s_in = sc[0]
    pairs = zip(mi.fold_act_scales_taps(tw[0], torch.from_numpy(
        np.asarray(s_in))), jax.jit(jvk.fold_act_scales_taps)(jw[0], s_in))
    for a, b in pairs:
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('C', [64, 32])
@pytest.mark.parametrize('mode', ['q8f', 'dynamic'])
def test_mrf_ct_int8_plain_matches_jax(C, mode):
    static = mode == 'q8f'
    rng, jp, jw, sc, _, mrf = _level(C, C + static, static)
    tile = 256
    x = _x(rng, C, 3 * tile, tile)
    xj = jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1)
    ref = _jax_out(jvk.fused_mrf_ct(xj, jw, KS, DILS, tile=tile,
                                    int8_chain=True, act_scales=sc,
                                    interpret=True))
    want = mi.prepare_mrf_ct_q8f(_t(_jax_ct_q8f_weights(jw, sc)), KS, DILS) \
        if static else mi.prepare_mrf_ct_q8(_t(_jax_ct_q8_weights(jw)), KS,
                                            DILS)
    for a, b in zip(sum(mrf.chains, []), sum(want.chains, [])):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    xt = torch.from_numpy(x).bfloat16()
    out = mi.mrf_ct_q8f_plain(xt, mrf) if static else \
        mi.mrf_ct_q8_plain(xt, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4, max_abs(
        out.float().numpy(), ref)


@pytest.mark.parametrize('mode', ['q8f', 'dynamic'])
def test_mrf_phase_q8_noups_plain_matches_jax(mode):
    """V2's L1: C = 32, p = 4, three tiles of 128 columns."""
    static = mode == 'q8f'
    C, p, tile = 32, 4, 128
    rng, jp, _, _, cal, mrf = _level(C, 7 + static, static)
    ph = [jnp.asarray(s[i]) for s1, s2 in cal for i in range(s1.shape[0])
          for s in (s1, s2)] if static else None
    jw = jvk.pack_mrf_phase_weights(jp, 0, KS, DILS, p)
    x = _x(rng, C, 3 * tile * p, tile * p)
    xj = jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1)
    ref = _jax_out(jvk.fused_mrf_phase(xj, jw, KS, DILS, p, tile=tile,
                                       int8_chain=True, act_scales=ph,
                                       interpret=True))
    # the jitted banded weights, read back by tap, are the ct packer's
    qw = _t(_jax_phase_q8_weights(jw, p, C, ph))
    per = 7 if static else 6
    steps = sum(mrf.chains, [])
    kd = [(k, d) for k, ds in zip(KS, DILS) for d in ds]
    for n, ((k, d), st) in enumerate(zip(kd, steps)):
        band = qw[per * n:per * n + per]
        assert torch.equal(mi._band_taps(band[0], k, d, p, C), st[0])
        assert torch.equal(mi._band_taps(band[per - 3], k, 1, p, C),
                           st[per - 3])
        for v, w in zip(band[1:per - 3] + band[per - 2:], st[1:per - 3]
                        + st[per - 2:]):
            assert torch.equal(v[:C, 0].to(w.dtype), w)
    out = mi.mrf_phase_q8_noups_plain(torch.from_numpy(x).bfloat16(), mrf, p,
                                      tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4, max_abs(
        out.float().numpy(), ref)


def test_ct_engine_replay_matches_jax():
    """The dynamic fused_mrf_ct at V2's L0 width (C = 64) on the
    segment-synchronised engine's plan, one launch a level, replayed block
    by block on JAX's jitted weights, against JAX's Pallas kernel in
    interpret mode: two utterances of three 256-sample tiles, one loud,
    every sample equal."""
    C, tile = 64, 256
    rng, jp, jw, _, _, _ = _level(C, 21, False)
    x = _x(rng, C, 3 * tile, tile)
    ref = _jax_out(jvk.fused_mrf_ct(
        jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1), jw, KS, DILS,
        tile=tile, int8_chain=True, interpret=True))
    mrf = mi.prepare_mrf_ct_q8(_t(_jax_ct_q8_weights(jw)), KS, DILS)
    out = _replay(torch.from_numpy(x).bfloat16(), mrf, tile, 10)
    assert out.shape == ref.shape
    assert max_abs(out.float().numpy(), ref) == 0.0


def test_int8_wrappers_run_plain_versions_on_cpu():
    rng, _, _, _, _, q8f = _level(32, 13, True)
    _, _, _, _, _, dyn = _level(32, 14, False)
    x = torch.from_numpy(_x(rng, 32, 512, 256)).bfloat16()
    cases = ((mi.fused_mrf_ct_q8f, (x, q8f), mi.mrf_ct_q8f_plain(x, q8f)),
             (mi.fused_mrf_phase_q8_noups, (x, dyn, 4, 128),
              mi.mrf_phase_q8_noups_plain(x, dyn, 4, 128)),
             (mi.fused_mrf_ct_q8, (x, dyn, 256),
              mi.mrf_ct_q8_plain(x, dyn, 256)))
    for fn, args, ref in cases:
        n, calls = fn.launches, sum(fn.calls.values())
        assert torch.equal(fn(*args), ref)
        assert fn.launches == n and sum(fn.calls.values()) == calls

"""The q8s form of the int8-static MRF kernels (daft_exprt_torch/ops/
mrf_int8.py, vocoder_kernels.py ``_chain_q8``) against the JAX package's
Pallas kernels in interpret mode: JAX's round-3 conv1 -> conv2 boundary,
taken under ``DAFT_INT8_FUSED_EPI=0`` (``int8_fused=False``):
``q = clip(rint(lrelu(x) * inv1))``, ``a1 = acc1*sw1 + b1`` in float32,
``clip(rint(lrelu(a1) * inv2))``, ``acc2*sw2 + b2``.

- The packers (``fused_mrf_ct``'s per-conv [wq, sw, inv, b] and the phase
  kernel's banded, gathered form, both made under ``jax.jit`` as the JAX
  wrappers make them) bit for bit.
- Plain versions against the Pallas kernels: ``mrf_ct_q8s_plain`` vs
  ``fused_mrf_ct``; ``mrf_phase_q8_noups_plain`` vs ``fused_mrf_phase``
  without prologue (V2's L1: C = 32, p = 4); ``mrf_phase_q8_plain`` vs
  ``fused_mrf_phase`` with the int8 upsample prologue at V1's L2 and L3
  geometry (conv_post at L3). Band rel-L2 <= 2e-3 (NUMERICS_r05.json
  ``ptc_vs_banded_int8``); the s32 sums are exact and every float32 step
  keeps JAX's order, so the outputs agree bit for bit in practice (the
  max-abs is asserted 0 where no conv_post sums in another order).
- The ct route's launch plan replayed on NaN buffers (the phase kernel's
  q8s form on ``ptc_fused_q8_kernel``'s plan is replayed in
  ``tests/test_torch_dyn_engine.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_int8 as mi

from tests.test_torch_int8 import KS, DILS, _t, act_scales, unit_level
from tests.test_torch_int8_dynamic import _jp, _jax_ups_q8_weights, _tp
from tests.test_torch_dyn_engine import _replay_static
from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


@jax.jit
def _jax_ct_q8s_weights(weights, scales):
    """``fused_mrf_ct``'s q8s weight preparation (:421-436), under jit."""
    qw = []
    for i in range(0, len(weights), 2):
        w, b = weights[i], weights[i + 1]
        n_dil, _, c_out, _ = w.shape
        w, inv_s = jvk.fold_act_scales_taps(w, scales[i // 2])
        wq, sw = jvk.quantize_rows(w, row_axes=(0, 2))
        qw += [wq, sw.reshape(n_dil, c_out, 1), inv_s, b.astype(jnp.float32)]
    return qw


def _jax_phase_q8s_weights(weights, p, C, scales):
    """``_fused_mrf_phase_jit``'s q8s chain preparation (:1334-1346),
    compact form, under jit."""
    kd = [(k, d) for k, ds in zip(KS, DILS) for d in ds]

    def prep(weights, scales):
        qw = []
        for i in range(0, len(weights), 2):
            k, d = kd[i // 4]
            sp = jvk._phase_conv_spec(k, d if i % 4 == 0 else 1, p)
            wd, inv_s = jvk.fold_act_scales_band(weights[i], scales[i // 2],
                                                 C, p)
            wq, sw = jvk.quantize_rows(wd)
            qw += [jnp.concatenate([wq[:, jj * C:(jj + 1) * C]
                                    for jj in sp['used']], axis=1),
                   sw, inv_s, weights[i + 1].astype(jnp.float32)]
        return qw

    return jax.jit(prep)(weights, scales)


def _level(C, seed):
    """bf16 params of one level, its calibration entry, the port's q8s
    ct weights and the JAX ct-packed arrays."""
    rng = np.random.RandomState(seed)
    jp = _jp(unit_level(rng, 0, C))
    cal = act_scales(rng, C)
    ct_scales = [s for s1, s2 in cal for s in (s1, s2)]
    tw = mi.pack_mrf_weights(_tp(jp), 0, KS, DILS)
    mrf = mi.prepare_mrf_ct_q8s(mi.quantize_mrf_ct_q8s_weights(
        tw, [torch.from_numpy(s) for s in ct_scales]), KS, DILS)
    return rng, jp, cal, [jnp.asarray(s) for s in ct_scales], mrf


def _ph_scales(cal):
    """Per conv in the phase pack order: (C,) per (chain, dilation)."""
    return [s[i] for s1, s2 in cal for i in range(s1.shape[0])
            for s in (s1, s2)]


def _x(rng, C, T, loud):
    x = (rng.randn(2, T, C) * 0.5).astype(np.float32)
    x[1, loud:2 * loud] *= 6.0
    return x


def test_q8s_packers_match_jax_jit():
    rng, jp, cal, sc, mrf = _level(32, 0)
    jw = jvk.pack_mrf_weights(jp, 0, KS, DILS)
    got = mi.quantize_mrf_ct_q8s_weights(
        mi.pack_mrf_weights(_tp(jp), 0, KS, DILS),
        [torch.from_numpy(np.asarray(s)) for s in sc])
    pairs = list(zip(got, _jax_ct_q8s_weights(jw, sc)))
    p, C = 4, 32
    ph = _ph_scales(cal)
    jb = jvk.pack_mrf_phase_weights(jp, 0, KS, DILS, p)
    tb = mi.pack_mrf_phase_weights(_tp(jp), 0, KS, DILS, p)
    qb = mi.quantize_mrf_phase_weights(
        tb, KS, DILS, p, [torch.from_numpy(s) for s in ph], fused=False)
    jq = _jax_phase_q8s_weights(jb, p, C, [jnp.asarray(s) for s in ph])
    pairs += zip(qb, jq)
    assert len(pairs) == 24 + 72
    for a, b in pairs:
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, str(b.dtype))
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    # the ct weights' steps, and the banded ones read back by tap, are one
    # set of per-tap weights (the phase kernel without prologue reads them)
    kd = [(k, d) for k, ds in zip(KS, DILS) for d in ds]
    band = mi.prepare_mrf_phase_q8(
        qb, KS, DILS, p, mi.quantize_ups_phase_weights(
            *mi.pack_ups_phase_weights(torch.zeros(64, C, 4), torch.zeros(C),
                                       2, 1, 2)[:2],
            mi.ups_used_blocks(4, 2, 1, 2), 64) + (4, 2, 1, 2))
    assert band.mode == mrf.mode == 'q8s'
    for (k, d), a, b in zip(kd, sum(band.chains, []), sum(mrf.chains, [])):
        assert len(a) == len(b) == 8
        assert all(torch.equal(u, v) for u, v in zip(a, b)), (k, d)


def test_mrf_ct_q8s_plain_matches_jax():
    C, tile = 32, 256
    rng, jp, _, sc, mrf = _level(C, 1)
    x = _x(rng, C, 3 * tile, tile)
    ref = np.asarray(jvk.fused_mrf_ct(
        jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1),
        jvk.pack_mrf_weights(jp, 0, KS, DILS), KS, DILS, tile=tile,
        int8_chain=True, act_scales=sc, int8_fused=False,
        interpret=True).astype(jnp.float32)).transpose(0, 2, 1)
    out = mi.mrf_ct_q8s_plain(torch.from_numpy(x).bfloat16(), mrf)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 2e-3
    assert max_abs(out.float().numpy(), ref) == 0.0


def test_mrf_phase_q8s_noups_plain_matches_jax():
    """V2's L1: C = 32, p = 4, three tiles of 128 columns."""
    C, p, tile = 32, 4, 128
    rng, jp, cal, _, mrf = _level(C, 2)
    x = _x(rng, C, 3 * tile * p, tile * p)
    ref = np.asarray(jvk.fused_mrf_phase(
        jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1),
        jvk.pack_mrf_phase_weights(jp, 0, KS, DILS, p), KS, DILS, p,
        tile=tile, int8_chain=True,
        act_scales=[jnp.asarray(s) for s in _ph_scales(cal)],
        int8_fused=False, interpret=True).astype(jnp.float32)
    ).transpose(0, 2, 1)
    out = mi.mrf_phase_q8_noups_plain(torch.from_numpy(x).bfloat16(), mrf, p,
                                      tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 2e-3
    assert max_abs(out.float().numpy(), ref) == 0.0


def _jax_phase_q8s(params, x, p, p_in, tile, post, scales):
    """fused_mrf_phase (q8s, int8 ups prologue [+ conv_post]) on
    sample-major x (B, cols*p_in, C_in); returns the output sample-major
    and the port's weights made from the JAX arrays the call used."""
    jp = _jp(params)
    B, T_in, C_in = x.shape
    cols = T_in // p_in
    C = params['ups_1']['w'].shape[1]
    w = jvk.pack_mrf_phase_weights(jp, 1, KS, DILS, p)
    wb, bu, ups_w, ups_dmin = jvk.pack_ups_phase_weights(
        jp['ups_1']['w'], jp['ups_1']['b'], 2, 1, p_in)
    used = jvk.ups_used_blocks(4, 2, 1, p_in)
    kw = dict(ups_weights=(wb, bu), ups_w=ups_w, ups_dmin=ups_dmin,
              ups_p_in=p_in, ups_used=used)
    if post:
        pw = jvk.pack_post_phase_weights(jp['conv_post']['w'],
                                         jp['conv_post']['b'], p)
        kw.update(post_weights=pw, post_k=7)
    xj = jnp.asarray(x, jnp.bfloat16).reshape(B, cols, p_in, C_in) \
        .transpose(0, 2, 3, 1).reshape(B, p_in * C_in, cols)
    y = np.asarray(jvk.fused_mrf_phase(
        xj, w, KS, DILS, p, tile=tile, in_phase=True, out_phase=True,
        int8_chain=True, act_scales=scales, int8_fused=False, interpret=True,
        **kw).astype(jnp.float32))
    y = y.reshape(B, p, cols).transpose(0, 2, 1).reshape(B, 1, -1) if post \
        else y.reshape(B, p, C, cols).transpose(0, 3, 1, 2).reshape(
            B, cols * p, C)
    cols_used = np.concatenate([np.arange(jj * C_in, (jj + 1) * C_in)
                                for jj in used])
    uq = _jax_ups_q8_weights(wb, jnp.asarray(cols_used))
    mrf = mi.prepare_mrf_phase_q8(
        _t(_jax_phase_q8s_weights(w, p, C, scales)), KS, DILS, p,
        tuple(_t(uq)) + (torch.from_numpy(np.asarray(bu)), 4, 2, 1, p_in),
        _t(pw) if post else None)
    return y, mrf


@pytest.mark.parametrize('C_in,C,p_in,post', [
    (128, 64, 1, False),          # V1's L2
    (64, 32, 2, True),            # V1's L3, conv_post fused
])
def test_mrf_phase_q8s_plain_matches_jax(C_in, C, p_in, post):
    """Three tiles of 64 columns, one loud: the upsample's input scale is
    dynamic per tile in q8s too; the chains are static."""
    rng = np.random.RandomState(3 * C + post)
    p = 2 * p_in
    params = unit_level(rng, 1, C, C_in=C_in, post=post)
    scales = [jnp.asarray(s) for s in _ph_scales(act_scales(rng, C))]
    cols, tile = 192, 64
    x = (rng.randn(2, cols * p_in, C_in) * 0.5).astype(np.float32)
    x[:, 64 * p_in:128 * p_in] *= 4.0
    ref, mrf = _jax_phase_q8s(params, x, p, p_in, tile, post, scales)
    assert mrf.mode == 'q8s'
    out = mi.mrf_phase_q8_plain(torch.from_numpy(x).bfloat16(), mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 2e-3, max_abs(
        out.float().numpy(), ref)


@pytest.mark.parametrize('C', [64, 32])
def test_ct_q8s_static_plan_replay_matches_jax(C):
    """fused_mrf_ct_q8s's launch, ptc_fused_q8_kernel without prologue
    (one launch a level, the q8s boundary), replayed block by block on
    the port's q8s weights (equal to JAX's jitted ones,
    test_q8s_packers_match_jax_jit) against JAX's ``fused_mrf_ct`` with
    ``int8_fused=False`` in interpret mode: three 256-sample tiles (the
    static function does not depend on them), one loud; every sample
    equal."""
    tile = 256
    rng, jp, _, sc, mrf = _level(C, 5 + C)
    x = _x(rng, C, 3 * tile, tile)
    ref = np.asarray(jvk.fused_mrf_ct(
        jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1),
        jvk.pack_mrf_weights(jp, 0, KS, DILS), KS, DILS, tile=tile,
        int8_chain=True, act_scales=sc, int8_fused=False,
        interpret=True).astype(jnp.float32)).transpose(0, 2, 1)
    out = _replay_static(torch.from_numpy(x).bfloat16(), mrf)
    assert out.shape == ref.shape
    assert max_abs(out.float().numpy(), ref) == 0.0


def test_q8s_wrappers_run_plain_versions_on_cpu():
    rng, _, _, _, mrf = _level(32, 6)
    x = torch.from_numpy(_x(rng, 32, 256, 64)).bfloat16()
    cases = ((mi.fused_mrf_ct_q8s, (x, mrf), mi.mrf_ct_q8s_plain(x, mrf)),
             (mi.fused_mrf_phase_q8_noups, (x, mrf, 4, 64),
              mi.mrf_phase_q8_noups_plain(x, mrf, 4, 64)))
    for fn, args, ref in cases:
        n, calls = fn.launches, sum(fn.calls.values())
        assert torch.equal(fn(*args), ref)
        assert fn.launches == n and sum(fn.calls.values()) == calls

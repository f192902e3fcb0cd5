"""The port's int8 kernels of the dynamic tier and of the static tier below
the phase-tc batch (daft_exprt_torch/ops/mrf_int8.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

- Plain versions against the Pallas kernels on the SAME int8 weights (JAX's
  own quantisation, run under jit as the kernels' wrappers run it, handed
  to the port as numpy): ``mrf_ct_q8_plain`` vs ``fused_mrf_ct(int8_chain=
  True)`` and ``mrf_phase_q8_plain`` vs ``fused_mrf_phase(int8_chain=True)``
  in the dynamic and q8f modes with the upsample prologue at p_in = 1 and
  2, with and without the conv_post epilogue. Band rel-L2 <= 1e-4
  (tests/test_torch_int8.py's); the s32 sums are exact and every f32 step
  keeps JAX's order, so the result is bit-identical but for conv_post's
  summation order.
- The port's packers, geometry helpers and tile rules against JAX's, bit
  for bit.
Weights are unit-gain (std 1/sqrt(fan-in)), as chip_smoke.py uses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, _t, act_scales, unit_level
from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """torch on one thread: the file replays many small ops (no check
    depends on the thread count)."""
    with one_torch_thread():
        yield


def _jp(params, dtype='bfloat16'):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                  params)


def _tp(jp):
    def conv(a):
        t = torch.from_numpy(np.array(a.astype(jnp.float32)))
        return t.bfloat16() if a.dtype == jnp.bfloat16 else t
    return jax.tree_util.tree_map(conv, jp)


@jax.jit
def _jax_ct_q8_weights(weights):
    """``fused_mrf_ct``'s int8-dynamic weight preparation (:421-436)."""
    qw = []
    for i in range(0, len(weights), 2):
        w, b = weights[i], weights[i + 1]
        n_dil, _, c_out, _ = w.shape
        wq, sw = jvk.quantize_rows(w, row_axes=(0, 2))
        qw += [wq, sw.reshape(n_dil, c_out, 1), b.astype(jnp.float32)]
    return qw


def _jax_phase_q8_weights(weights, p, C, scales):
    """``_fused_mrf_phase_jit``'s int8 chain preparation (:1316-1349),
    compact form, under jit."""
    kd = [(k, d) for k, ds in zip(KS, DILS) for d in ds]

    def spec(pair):
        k, d = kd[pair // 2]
        return jvk._phase_conv_spec(k, d if pair % 2 == 0 else 1, p)

    def gather(wd, sp):
        return jnp.concatenate([wd[:, jj * C:(jj + 1) * C]
                                for jj in sp['used']], axis=1)

    def prep(weights, scales):
        qw = []
        for j in range(0, len(weights), 4):
            wd1, b1, wd2, b2 = weights[j:j + 4]
            if scales is None:
                wq1, sw1 = jvk.quantize_rows(wd1)
                wq2, sw2 = jvk.quantize_rows(wd2)
                qw += [gather(wq1, spec(j // 2)), sw1, b1.astype(jnp.float32),
                       gather(wq2, spec(j // 2 + 1)), sw2,
                       b2.astype(jnp.float32)]
                continue
            wd1f, inv1 = jvk.fold_act_scales_band(wd1, scales[j // 2], C, p)
            wq1, sw1 = jvk.quantize_rows(wd1f)
            wd2f, inv2 = jvk.fold_act_scales_band(wd2, scales[j // 2 + 1],
                                                  C, p)
            wq2, sw2 = jvk.quantize_rows(wd2f)
            b1i, m1 = jvk._fuse_boundary_consts(sw1, b1, inv2)
            qw += [gather(wq1, spec(j // 2)), inv1, b1i, m1,
                   gather(wq2, spec(j // 2 + 1)), sw2, b2.astype(jnp.float32)]
        return qw

    return jax.jit(prep)(weights, scales)


@jax.jit
def _jax_ups_q8_weights(wb, used_cols):
    """The int8 upsample prologue's gather and quantisation (:1374-1389)."""
    return jvk.quantize_rows(wb[:, used_cols])


@pytest.mark.parametrize('C,case', [(128, 'loud_tile'), (256, 'loud_tile'),
                                    (128, 'edge_amax')])
def test_mrf_ct_q8_plain_matches_jax(C, case):
    """Two utterances of two tiles. ``edge_amax``: small negative x and
    large biases, so after the first step the bias leakage in the window's
    zero padding beyond the utterance holds the amax (checked below)."""
    rng = np.random.RandomState(C)
    params = unit_level(rng, 0, C)
    B, T, tile = 2, 512, 256
    x = (rng.randn(B, T, C) * 0.5).astype(np.float32)
    if case == 'edge_amax':
        x = -np.abs(x) * 0.02
        for rb in params.values():
            for conv in rb.values():
                conv['b'] = conv['b'] * 40.0
    else:
        x[1, tile:tile + 5] *= 8.0         # in the halo of the tile before
    jp = _jp(params)
    jw = jvk.pack_mrf_weights(jp, 0, KS, DILS)
    ref = np.asarray(jvk.fused_mrf_ct(
        jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1), jw, KS, DILS,
        tile=tile, int8_chain=True, interpret=True).astype(jnp.float32)
    ).transpose(0, 2, 1)
    mrf = mi.prepare_mrf_ct_q8(_t(_jax_ct_q8_weights(jw)), KS, DILS)
    xt = torch.from_numpy(x).bfloat16()
    out = mi.mrf_ct_q8_plain(xt, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4, max_abs(
        out.float().numpy(), ref)
    if case == 'edge_amax':
        # step 0 of chain 0 on tile 0: the amax of its output's lrelu
        # lies beyond the utterance's first sample
        halo = mi.ct_halo(KS, DILS)
        cur = mi._windows(xt, tile, halo, tile + 2 * halo)[:1]
        wq1, sw1, b1, wq2, sw2, b2 = mrf.chains[0][0]
        a1 = mi._conv_dyn(cur, wq1, sw1, b1, 1, 0, cur.shape[1] - 2)
        a2 = mi._conv_dyn(a1, wq2, sw2, b2, 1, 0, a1.shape[1] - 2)
        nxt = vk._lrelu(cur[:, 2:-2] + a2).abs().amax(dim=2)[0]
        assert int(nxt.argmax()) < halo - 2


def _jax_phase(params, x, p, p_in, tile, post, scales):
    """fused_mrf_phase (int8, ups prologue [+ conv_post]) on sample-major x
    (B, cols*p_in, C_in); returns the output sample-major and the port's
    weights made from the JAX arrays the call used."""
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
        int8_chain=True, act_scales=scales, int8_fused=True, interpret=True,
        **kw).astype(jnp.float32))
    y = y.reshape(B, p, cols).transpose(0, 2, 1).reshape(B, 1, -1) if post \
        else y.reshape(B, p, C, cols).transpose(0, 3, 1, 2).reshape(
            B, cols * p, C)
    cols_used = np.concatenate([np.arange(jj * C_in, (jj + 1) * C_in)
                                for jj in used])
    uq = _jax_ups_q8_weights(wb, jnp.asarray(cols_used))
    mrf = mi.prepare_mrf_phase_q8(
        _t(_jax_phase_q8_weights(w, p, C, scales)), KS, DILS, p,
        tuple(_t(uq)) + (torch.from_numpy(np.asarray(bu)), 4, 2, 1, p_in),
        _t(pw) if post else None)
    return y, mrf


def _ph_scales(rng, C):
    return [jnp.asarray(s[i]) for s1, s2 in act_scales(rng, C)
            for i in range(s1.shape[0]) for s in (s1, s2)]


@pytest.mark.parametrize('mode', ['dynamic', 'q8f'])
@pytest.mark.parametrize('C_in,C,p_in,post', [
    (128, 64, 1, False),          # V1's L2
    (64, 32, 2, True),            # V1's L3, conv_post fused
    (64, 32, 2, False),
])
def test_mrf_phase_q8_plain_matches_jax(C_in, C, p_in, post, mode):
    """Four tiles of 64 columns, one of them loud: every tile quantises its
    upsample input (and, dynamic, every conv input) with its own scale."""
    rng = np.random.RandomState(C + post)
    p = 2 * p_in
    params = unit_level(rng, 1, C, C_in=C_in, post=post)
    scales = _ph_scales(rng, C) if mode == 'q8f' else None
    cols, tile = 256, 64
    x = (rng.randn(2, cols * p_in, C_in) * 0.5).astype(np.float32)
    x[:, 64 * p_in:128 * p_in] *= 4.0
    ref, mrf = _jax_phase(params, x, p, p_in, tile, post, scales)
    assert mrf.dynamic == (mode == 'dynamic')
    out = mi.mrf_phase_q8_plain(torch.from_numpy(x).bfloat16(), mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4, max_abs(
        out.float().numpy(), ref)


def test_ct_and_phase_packers_match_jax():
    rng = np.random.RandomState(8)
    C_in, C, p, p_in = 64, 32, 4, 2
    jp = _jp(unit_level(rng, 1, C, C_in=C_in, post=True))
    tp = _tp(jp)
    pairs = list(zip(mi.pack_mrf_weights(tp, 1, KS, DILS),
                     jvk.pack_mrf_weights(jp, 1, KS, DILS)))
    pairs += zip(mi.quantize_mrf_ct_weights(mi.pack_mrf_weights(
        tp, 1, KS, DILS)), _jax_ct_q8_weights(
            jvk.pack_mrf_weights(jp, 1, KS, DILS)))
    jw = jvk.pack_mrf_phase_weights(jp, 1, KS, DILS, p)
    tw = mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p)
    pairs += zip(tw, jw)
    scales = _ph_scales(rng, C)
    for sc in (None, scales):
        pairs += zip(mi.quantize_mrf_phase_weights(
            tw, KS, DILS, p, None if sc is None else
            [torch.from_numpy(np.asarray(s)) for s in sc]),
            _jax_phase_q8_weights(jw, p, C, sc))
    jb = jvk.pack_ups_phase_weights(jp['ups_1']['w'], jp['ups_1']['b'], 2, 1,
                                    p_in)
    tb = mi.pack_ups_phase_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2, 1,
                                   p_in)
    assert tb[2:] == jb[2:]
    pairs += zip(tb[:2], jb[:2])
    used = jvk.ups_used_blocks(4, 2, 1, p_in)
    assert mi.ups_used_blocks(4, 2, 1, p_in) == used
    cols = np.concatenate([np.arange(jj * C_in, (jj + 1) * C_in)
                           for jj in used])
    pairs += zip(mi.quantize_ups_phase_weights(tb[0], tb[1], used, C_in)[:2],
                 _jax_ups_q8_weights(jb[0], jnp.asarray(cols)))
    pairs += zip(mi.pack_post_phase_weights(tp['conv_post']['w'],
                                            tp['conv_post']['b'], p),
                 jvk.pack_post_phase_weights(jp['conv_post']['w'],
                                             jp['conv_post']['b'], p))
    s_in = torch.from_numpy(np.asarray(scales[0]))
    pairs += zip(mi.fold_act_scales_band(tw[0], s_in, C, p),
                 jax.jit(lambda w, s: jvk.fold_act_scales_band(w, s, C, p))(
                     jw[0], scales[0]))
    assert len(pairs) == 12 + 18 + 36 + 54 + 63 + 2 + 2 + 2 + 2
    for a, b in pairs:
        assert tuple(a.shape) == b.shape
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    v = rng.randn(3, 300, 16).astype(np.float32)
    v[1] *= 5.0
    q, s = mi._quantize_segments(torch.from_numpy(v))
    for seg in range(3):
        jq, js = jax.jit(lambda a: jvk._quantize_dynamic(jvk._lrelu(a)))(
            jnp.asarray(v[seg]))
        assert np.array_equal(q[seg].numpy(), np.asarray(jq))
        assert float(s[seg]) == float(js)


def test_phase_geometry_matches_jax():
    for pp in (2, 4):
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                assert mi._phase_conv_spec(k, d, pp) == \
                    jvk._phase_conv_spec(k, d, pp)
        assert mi.phase_chain_halo(KS, DILS, pp) == \
            jvk.phase_chain_halo(KS, DILS, pp) == 128
        for tile in (64, 512, 8192):
            assert mi._phase_chain_geometry(KS, DILS, pp, tile, 128) == \
                jvk._phase_chain_geometry(KS, DILS, pp, tile, 128)
            assert mi.phase_post_feasible(KS, DILS, pp, 7, tile) == \
                jvk.phase_post_feasible(KS, DILS, pp, 7, tile)
    for k, dils in zip(KS, DILS):
        assert mi.resblock1_halo(k, dils) == jvk.resblock1_halo(k, dils)
    assert mi.ct_halo(KS, DILS) == 128
    assert mi._stage_runs_of((0, 1, 2, 5, 6), 1, 4) == \
        jvk._stage_runs_of((0, 1, 2, 5, 6), 1, 4)
    # V1's upsample input halo: 256 columns at L2 (p_in 1) and L3 (p_in 2)
    for p_in in (1, 2):
        _, dmin, dmax = jvk._ups_phase_entries(4, 2, 1, p_in)
        assert mi.phase_halo_in(128, dmin, dmax) == 256


def test_tile_rules_match_jax(monkeypatch):
    """The tiles the JAX generator hands ``fused_mrf_ct`` (``_pallas_mrf``)
    and the int8 ``fused_mrf_phase`` (``_pallas_mrf_phase``), recorded by
    stubs, against :func:`ct_tile` and ``ptc_tile`` (the same halving
    rule)."""
    seen = []

    def stub(x, *a, tile, **kw):
        seen.append(tile)
        return x
    monkeypatch.setattr(jvk, 'fused_mrf_ct', stub)
    monkeypatch.setattr(jvk, 'fused_mrf_phase', stub)
    params = {f'resblock_0_{j}': {f'{pre}_{i}': {'w': jnp.zeros((1, 1, k)),
                                                'b': jnp.zeros((1,))}
                                  for pre in ('convs1', 'convs2')
                                  for i in range(3)}
              for j, k in enumerate(KS)}
    cfg = dict(jh.DEFAULT_CONFIG)
    for C, T in ((256, 8192), (128, 65536), (256, 1024), (256, 5120),
                 (128, 16384), (128, 1536), (256, 192)):
        seen.clear()
        jh._pallas_mrf(params, jnp.zeros((1, C, T)), 0, cfg, 3, 8192,
                       int8=True)
        assert seen == [mi.ct_tile(T, C)], (C, T)
    for Q in (65536, 40960, 16384, 1536, 192):
        seen.clear()
        jh._pallas_mrf_phase(params, jnp.zeros((1, 2, Q)), 0, cfg, 2,
                             int8=True)
        assert seen == [vk.ptc_tile(Q)], Q
    assert [mi.ct_tile(T, C) for C, T in ((256, 8192), (128, 65536),
                                          (256, 1024), (256, 5120))] == \
        [2048, 4096, 1024, 1024]

"""``fused_mrf_ptc``'s dyn and fdot modes in the port against the JAX
package's Pallas kernel in interpret mode.

- dyn (``mrf_int8.fused_mrf_ptc`` on ``pack_mrf_ptc_weights(...,
  act_scales=None)``): every conv quantises all p phases of the phase-tc
  rows it reads with one scale per (utterance, tile). The windows shrink by
  each conv's row span (``_ptc_spec``), p samples a row, not by the
  sample-major reach; one sample too wide moves a scale. Plain version vs
  ``fused_mrf_ptc(dyn=True)`` at V1's L2 and L3 geometry (conv_post at
  L3), tiles of 64 rows, one tile loud: band rel-L2 <= 2e-3
  (NUMERICS_r05.json ``ptc_vs_banded_int8``), bit for bit in practice.
- fdot (``vocoder_kernels.fused_mrf_ptc_f``): unquantised bf16 dots, the
  upsample output kept in float32. Plain version vs ``fused_mrf_ptc(fdot=
  True)``, band rel-L2 <= 3e-2 (NUMERICS_r05.json ``ptc_bf16_vs_banded_
  bf16``), in bf16 and with float32 activations (the dots stay bf16).
- The packers bit for bit, and the fdot launch plan replayed on NaN
  buffers (the dyn mode's, on the int8-dynamic engine, is replayed in
  ``tests/test_torch_dyn_engine.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, _t, act_scales, unit_level
from tests.test_torch_int8_dynamic import _jp, _tp
from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


CASES = [                     # (C_in, C, p_in, post): V1's L2 and L3
    (128, 64, 1, False),
    (64, 32, 2, True),
]


def _case(C_in, C, p_in, post, seed):
    rng = np.random.RandomState(seed)
    params = unit_level(rng, 1, C, C_in=C_in, post=post)
    rows, tile = 192, 64
    x = (rng.randn(2, rows * p_in, C_in) * 0.5).astype(np.float32)
    x[:, 64 * p_in:128 * p_in] *= 4.0          # one loud tile
    return params, x, tile


def _jax_ptc(jp, x, p, p_in, tile, post, dtype, fdot):
    """fused_mrf_ptc (dyn or fdot, ups prologue [+ conv_post]) on
    sample-major x (B, rows*p_in, C_in); returns the output sample-major
    (B, rows*p, C) or (B, 1, rows*p) and the packed arrays it used."""
    B, T_in, C_in = x.shape
    rows = T_in // p_in
    if fdot:
        w = jvk.pack_mrf_ptc_f_weights(jp, 1, KS, DILS, p)
        U, b_u, shifts = jvk.pack_ups_ptc_f_weights(
            jp['ups_1']['w'], jp['ups_1']['b'], 2, 1, p_in)
        ups = (U, b_u)
    else:
        w = jvk.pack_mrf_ptc_weights(jp, 1, KS, DILS, p)
        *ups, shifts = jvk.pack_ups_ptc_weights(jp['ups_1']['w'],
                                               jp['ups_1']['b'], 2, 1, p_in)
    post_w, post_k = None, 0
    if post:
        P, b_p, post_k = jvk.pack_post_ptc_weights(
            jp['conv_post']['w'], jp['conv_post']['b'], p,
            dtype=jnp.dtype(dtype))
        post_w = (P, b_p)
    y = jvk.fused_mrf_ptc(
        jnp.asarray(x, dtype).reshape(B, rows, p_in * C_in), w, KS, DILS, p,
        tile=tile, post_weights=post_w, post_k=post_k, ups_weights=tuple(ups),
        ups_shifts=shifts, dyn=not fdot, fdot=fdot, interpret=True)
    y = np.asarray(y.astype(jnp.float32))
    y = y.reshape(B, 1, -1) if post else y.reshape(B, rows * p, -1)
    return y, w, tuple(ups) + (shifts,), (post_w + (post_k,) if post else None)


@pytest.mark.parametrize('C_in,C,p_in,post', CASES)
def test_mrf_ptc_dyn_plain_matches_jax(C_in, C, p_in, post):
    p = 2 * p_in
    params, x, tile = _case(C_in, C, p_in, post, C + post)
    jp = _jp(params)
    ref, jw, ups, pst = _jax_ptc(jp, x, p, p_in, tile, post, 'bfloat16',
                                 False)
    mrf = vk.prepare_mrf_ptc(
        _t(jw), KS, DILS, p, _t(ups[:3]) + [ups[3], 4, 2, 1, p_in],
        None if pst is None else _t(pst[:2]) + [pst[2]])
    assert mrf.dynamic and len(mrf.chains[0][0]) == 6
    out = mi.mrf_ptc_plain(torch.from_numpy(x).bfloat16(), mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 2e-3, max_abs(
        out.float().numpy(), ref)
    if not post:
        assert max_abs(out.float().numpy(), ref) == 0.0


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('C_in,C,p_in,post', CASES)
def test_mrf_ptc_fdot_plain_matches_jax(C_in, C, p_in, post, dtype):
    p = 2 * p_in
    params, x, tile = _case(C_in, C, p_in, post, 2 * C + post)
    jp = _jp(params, dtype)
    ref, jw, ups, pst = _jax_ptc(jp, x, p, p_in, tile, post, dtype, True)
    mrf = vk.prepare_mrf_ptc_f(
        _t(jw), KS, DILS, p, _t(ups[:2]) + [ups[2], 4, 2, 1, p_in],
        None if pst is None else _t(pst[:2]) + [pst[2]])
    assert mrf.dtype == torch.bfloat16 and mrf.p == p
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = vk.mrf_ptc_f_plain(xt.transpose(1, 2), mrf, tile)
    assert out.dtype == xt.dtype
    out = out.float().numpy()
    if not post:                           # (B, C, N) -> sample-major
        out = out.transpose(0, 2, 1)
    assert out.shape == ref.shape
    assert rel_l2(out, ref) <= 3e-2, rel_l2(out, ref)
    # the upsample output stays float32: fdot is not the banded bf16 phase
    # function (which rounds it), though it comes close
    if dtype == 'bfloat16':
        banded = vk.mrf_phase_plain(xt.transpose(1, 2), mrf.packed, KS, DILS,
                                    mrf.ups, mrf.post).float().numpy()
        if not post:
            banded = banded.transpose(0, 2, 1)
        assert 0 < max_abs(banded, out) and rel_l2(banded, ref) <= 3e-2


def test_ptc_dyn_and_fdot_packers_match_jax():
    rng = np.random.RandomState(8)
    C_in, C, p, p_in = 64, 32, 4, 2
    jp = _jp(unit_level(rng, 1, C, C_in=C_in, post=True))
    tp = _tp(jp)
    pairs = list(zip(vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p),
                     jvk.pack_mrf_ptc_weights(jp, 1, KS, DILS, p)))
    pairs += zip(vk.pack_mrf_ptc_f_weights(tp, 1, KS, DILS, p),
                 jvk.pack_mrf_ptc_f_weights(jp, 1, KS, DILS, p))
    tu = vk.pack_ups_ptc_f_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2, 1,
                                   p_in)
    ju = jvk.pack_ups_ptc_f_weights(jp['ups_1']['w'], jp['ups_1']['b'], 2, 1,
                                    p_in)
    assert tu[2] == ju[2]
    pairs += zip(tu[:2], ju[:2])
    pairs += zip(vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                          tp['conv_post']['b'], p,
                                          torch.bfloat16)[:2],
                 jvk.pack_post_ptc_weights(jp['conv_post']['w'],
                                           jp['conv_post']['b'], p,
                                           jnp.bfloat16)[:2])
    assert len(pairs) == 54 + 36 + 2 + 2
    for a, b in pairs:
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, str(b.dtype))
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    # the fdot shift matrices read back by tap are the params' bf16 taps
    mrf = vk.prepare_mrf_ptc_f(
        vk.pack_mrf_ptc_f_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(tu) + (4, 2, 1, p_in), vk.pack_post_ptc_weights(
            tp['conv_post']['w'], tp['conv_post']['b'], p, torch.bfloat16))
    for a, b in zip(mrf.packed, vk.pack_mrf_tc_weights(tp, 1, KS, DILS)):
        assert torch.equal(a.float(), b.float())
    assert torch.equal(mrf.ups[0], tp['ups_1']['w'])
    assert torch.equal(mrf.post[0], tp['conv_post']['w'])


def _on(tree, device):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(t, device) for t in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize('C_in,C,p_in', [(128, 64, 1), (32, 16, 2)])
def test_fdot_and_q8s_weights_take_the_fused_kernels(C_in, C, p_in):
    """Off the CPU (here the meta device, where nothing runs) fdot's
    weights are staged for ``phase_bf_kernel`` (``blk`` / ``blk_ups`` by
    ``pack_stage_bf16``) and the q8s phase weights for
    ``ptc_fused_q8_kernel`` (``blk_dev`` / ``blk_ups_dev``: the eight q8s
    arrays a step, taps by ``pack_stage_s8``, no mma form), at V1's L2
    widths; at a width no phase kernel is built for, no upsample and no
    int8 form is staged (fdot's chains carry the level kernels' form of
    their width, as every bf16 level of ``CT_CHANNELS`` does) and both
    wrappers refuse the call, naming the built widths. A float32 fdot call
    is refused too."""
    rng = np.random.RandomState(9)
    p = 2 * p_in
    tp = _tp(_jp(unit_level(rng, 1, C, C_in=C_in)))
    ups = (4, 2, 1, p_in)
    f = vk.prepare_mrf_ptc_f(
        _on(vk.pack_mrf_ptc_f_weights(tp, 1, KS, DILS, p), 'meta'), KS, DILS,
        p, _on(tuple(vk.pack_ups_ptc_f_weights(
            tp['ups_1']['w'], tp['ups_1']['b'], 2, 1, p_in)), 'meta') + ups)
    scales = [torch.from_numpy(s[i]) for s1, s2 in act_scales(rng, C)
              for i in range(s1.shape[0]) for s in (s1, s2)]
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p, scales,
        fused=False)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    q = mi.prepare_mrf_phase_q8(
        _on(qw, 'meta'), KS, DILS, p, _on(mi.quantize_ups_phase_weights(
            wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in), 'meta') + ups)
    assert f.device.type == 'meta' and q.mode == 'q8s'
    assert q.chains_dev is None and q.ups_dev is None
    x = torch.empty((2, 128 * p_in, C_in), dtype=torch.bfloat16,
                    device='meta')
    if (C_in, C) not in vk.PTC_Q8_BM:
        assert f.blk_ups is None and q.blk_dev is None
        for call in (lambda: vk.fused_mrf_ptc_f(x.transpose(1, 2), f, 64),
                     lambda: mi.fused_mrf_phase_q8(x, q, 64)):
            with pytest.raises(ValueError, match='no CUDA instantiation'):
                call()
        with pytest.raises(ValueError, match=r'\(128, 64\), \(64, 32\)'):
            mi.fused_mrf_phase_q8(x, q, 64)
        return
    # staged taps of chain 0 (k = 3): whole tap groups of C x C; the
    # upsample: per phase 2 taps of C_in x C (bytes apart: wu_phase)
    tps = vk.PHASE_BF_CFG[C_in, C].tps
    assert [len(st) for st in f.blk[0]] == [4] * 3
    assert f.blk[0][0][0].dtype == torch.bfloat16
    assert f.blk[0][0][0].numel() == -(-3 // tps) * tps * C * C
    assert f.blk_ups[0].numel() == 2 * 2 * C_in * C
    assert f.blk_ups[2] == 2 * 2 * C_in * C
    tps = vk.Q8_STAGES[C_in, C].tps
    assert [len(st) for st in q.blk_dev[0]] == [8] * 3
    assert q.blk_dev[0][0][0].dtype == torch.int8
    assert q.blk_dev[0][0][0].numel() == -(-3 // tps) * tps * C * C
    with pytest.raises(ValueError, match='bfloat16'):
        vk.fused_mrf_ptc_f(x.float().transpose(1, 2), f, 64)


def test_ptc_wrappers_run_plain_versions_on_cpu():
    rng = np.random.RandomState(7)
    C_in, C, p_in = 32, 16, 2
    p = 2 * p_in
    tp = _tp(_jp(unit_level(rng, 1, C, C_in=C_in)))
    ups = (4, 2, 1, p_in)
    dyn = vk.prepare_mrf_ptc(
        vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2,
                                      1, p_in)) + ups)
    f = vk.prepare_mrf_ptc_f(
        vk.pack_mrf_ptc_f_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_f_weights(tp['ups_1']['w'], tp['ups_1']['b'],
                                        2, 1, p_in)) + ups)
    x = torch.from_numpy((rng.randn(1, 128, C_in) * 0.5).astype(np.float32)
                         ).bfloat16()
    cases = ((mi.fused_mrf_ptc, (x, dyn, 64), mi.mrf_ptc_plain(x, dyn, 64)),
             (vk.fused_mrf_ptc_f, (x.transpose(1, 2), f, 64),
              vk.mrf_ptc_f_plain(x.transpose(1, 2), f, 64)))
    for fn, args, ref in cases:
        n, calls = fn.launches, sum(fn.calls.values())
        assert torch.equal(fn(*args), ref)
        assert fn.launches == n and sum(fn.calls.values()) == calls
    with pytest.raises(ValueError, match='multiple of tile'):
        vk.fused_mrf_ptc_f(x.transpose(1, 2), f, 48)

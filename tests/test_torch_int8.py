"""The port's int8-static vocoder tier (daft_exprt_torch/ops/vocoder_kernels.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

- Plain versions against the Pallas kernels on the SAME packed int8 weights
  (the JAX packers' arrays handed to the port as numpy): ``mrf_tc_q8_plain``
  vs ``fused_mrf_tc(q8=True)`` and ``mrf_int8.mrf_ptc_plain`` vs ``fused_mrf_ptc``
  (static mode, upsample prologue, conv_post epilogue) at the same tile.
  Band rel-L2 <= 1e-4 (tests/test_vocoder_kernels.py's ptc band): the s32
  sums are exact integers on both sides and the f32 epilogues keep JAX's
  order, so what remains is conv_post's f32 summation order.
- The per-tile upsample scales against a numpy amax over JAX's windows.
- The port's packers against JAX's (the same arithmetic on one backend).
Weights are unit-gain (std 1/sqrt(fan-in)), as chip_smoke.py uses, so
the residual stream does not hide the quantised branches.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.torch_port_utils import one_torch_thread, rel_l2, to_torch


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """torch on one thread: the file replays many small ops (no check
    depends on the thread count)."""
    with one_torch_thread():
        yield


KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def unit_level(rng, level, C, kernel_sizes=KS, dilations=DILS, C_in=None,
               post=False):
    """One level's params with unit-gain convs (numpy, JAX layout)."""
    p = {}
    for j, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        p[f'resblock_{level}_{j}'] = {
            f'{pre}_{i}': {
                'w': (rng.randn(C, C, k) * (C * k) ** -0.5).astype(np.float32),
                'b': (rng.randn(C) * 0.05).astype(np.float32)}
            for pre in ('convs1', 'convs2') for i in range(len(dils))}
    if C_in is not None:
        p[f'ups_{level}'] = {
            'w': (rng.randn(C_in, C, 4) * (C_in * 2) ** -0.5
                  ).astype(np.float32),
            'b': (rng.randn(C) * 0.05).astype(np.float32)}
    if post:
        p['conv_post'] = {
            'w': (rng.randn(1, C, 7) * (C * 7) ** -0.5).astype(np.float32),
            'b': (rng.randn(1) * 0.05).astype(np.float32)}
    return p


def act_scales(rng, C, kernel_sizes=KS, dilations=DILS):
    """A level's [(s1, s2) per block] calibration entry, (n_dil, C) each."""
    return [tuple((0.5 + rng.rand(len(d), C)).astype(np.float32)
                  for _ in range(2))
            for _, d in zip(kernel_sizes, dilations)]


def _t(arrays):
    """JAX arrays -> torch tensors of the same dtype (bf16 via float32)."""
    return [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))
            for a in arrays]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C', [128, 256])
def test_mrf_tc_q8_plain_matches_jax(C, dtype):
    rng = np.random.RandomState(C)
    params = unit_level(rng, 0, C)
    scales = act_scales(rng, C)
    x = (rng.randn(2, 256, C) * 0.5).astype(np.float32)
    jw = jvk.pack_mrf_tc_int8_weights(
        jax.tree_util.tree_map(jnp.asarray, params), 0, KS, DILS, scales)
    ref = np.asarray(jvk.fused_mrf_tc(
        jnp.asarray(x, dtype), jw, KS, DILS, tile=128, interpret=True,
        q8=True).astype(jnp.float32))
    mrf = vk.prepare_mrf_tc_q8(_t(jw), KS, DILS)
    out = vk.mrf_tc_q8_plain(
        torch.from_numpy(x).to(getattr(torch, dtype)), mrf)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4


def _jax_ptc(params, scales, x, p, p_in, tile, post, dtype):
    """fused_mrf_ptc (static, ups prologue [+ conv_post]) on sample-major
    x (B, rows*p_in, C_in); returns the output sample-major and the packed
    weights the call used."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    B, T_in, C_in = x.shape
    rows = T_in // p_in
    jw = jvk.pack_mrf_ptc_weights(jp, 1, KS, DILS, p, scales)
    ups = jvk.pack_ups_ptc_weights(jp['ups_1']['w'], jp['ups_1']['b'], 2, 1,
                                   p_in)
    post_w, post_k = None, 0
    if post:
        P, b_p, post_k = jvk.pack_post_ptc_weights(
            jp['conv_post']['w'], jp['conv_post']['b'], p,
            dtype=jnp.dtype(dtype))
        post_w = (P, b_p)
    y = jvk.fused_mrf_ptc(
        jnp.asarray(x, dtype).reshape(B, rows, p_in * C_in), jw, KS, DILS, p,
        tile=tile, post_weights=post_w, post_k=post_k,
        ups_weights=ups[:3], ups_shifts=ups[3], interpret=True)
    y = np.asarray(y.astype(jnp.float32))
    y = y.reshape(B, 1, -1) if post else y.reshape(B, rows * p, -1)
    return y, jw, ups, (post_w + (post_k,) if post else None)


def _port_ptc_weights(jw, ups, post, p, p_in):
    u = _t(ups[:3]) + [ups[3], 4, 2, 1, p_in]
    pst = None if post is None else (_t(post[:2]) + [post[2]])
    return vk.prepare_mrf_ptc(_t(jw), KS, DILS, p, u, pst)


PTC_CASES = [                 # (C_in, C, p_in, post): V1's L2 and L3
    (128, 64, 1, False),
    (64, 32, 2, True),
    (64, 32, 2, False),
]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C_in,C,p_in,post', PTC_CASES)
def test_mrf_ptc_plain_matches_jax(C_in, C, p_in, post, dtype):
    """Four tiles of 64 rows: every tile quantises its upsample input with
    its own scale, and the tiles' halos overlap."""
    rng = np.random.RandomState(C + post)
    p = 2 * p_in
    params = unit_level(rng, 1, C, C_in=C_in, post=post)
    scales = act_scales(rng, C)
    rows, tile = 256, 64
    x = (rng.randn(2, rows * p_in, C_in) * 0.5).astype(np.float32)
    # one loud tile, so the tiles' scales differ
    x[:, 64 * p_in:128 * p_in] *= 4.0
    ref, jw, ups, pst = _jax_ptc(params, scales, x, p, p_in, tile, post,
                                 dtype)
    mrf = _port_ptc_weights(jw, ups, pst, p, p_in)
    out = mi.mrf_ptc_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                           mrf, tile)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    assert rel_l2(out.float().numpy(), ref) <= 1e-4


@pytest.mark.parametrize('p_in,halo_in', [(1, 192), (2, 128)])
def test_ptc_upsample_scales_are_per_tile(p_in, halo_in):
    """amax of lrelu(x) over rows [t*tile - halo_in, (t+1)*tile + halo_in)
    of the zero-padded input, as _fused_mrf_ptc_kernel's x_scratch holds
    them; halo_in is V1's (L2: 192 rows, L3: 128)."""
    p = 2 * p_in
    halo = jvk.ptc_chain_halo(KS, DILS, p)
    shifts = jvk.pack_ups_ptc_weights(jnp.zeros((8, 4, 4)), jnp.zeros(4), 2,
                                      1, p_in)[3]
    assert vk.ptc_halo_in(halo, shifts) == halo_in
    rng = np.random.RandomState(p_in)
    B, rows, tile, C_in = 2, 512, 128, 8
    x = rng.randn(B, rows * p_in, C_in).astype(np.float32)
    x[0, :tile * p_in] *= 3.0
    x[1, -5:] = 40.0              # reaches the halo of the tile before
    amax, _ = vk.ptc_amax(torch.from_numpy(x), p_in, tile, halo_in)
    rows_x = np.pad(x.reshape(B, rows, p_in * C_in),
                    ((0, 0), (halo_in, halo_in), (0, 0)))
    want = []
    for b in range(B):
        for t in range(rows // tile):
            w = rows_x[b, t * tile:t * tile + tile + 2 * halo_in]
            want.append(max(np.abs(np.where(w >= 0, w, np.float32(0.1) * w)
                                   ).max(), 1e-30))
    assert np.array_equal(amax.numpy(), np.asarray(want, np.float32))
    assert len(set(want)) > 2


def test_tc_int8_packer_matches_jax():
    rng = np.random.RandomState(7)
    C = 64
    params = unit_level(rng, 0, C)
    scales = act_scales(rng, C)
    jw = jvk.pack_mrf_tc_int8_weights(
        jax.tree_util.tree_map(jnp.asarray, params), 0, KS, DILS, scales)
    tw = vk.pack_mrf_tc_int8_weights(
        to_torch(params), 0, KS, DILS,
        [tuple(torch.from_numpy(s) for s in e) for e in scales])
    assert len(tw) == len(jw) == 21
    for a, b in zip(tw, jw):
        assert a.dtype == getattr(torch, str(b.dtype))
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_ptc_packers_match_jax():
    rng = np.random.RandomState(8)
    C_in, C, p, p_in = 64, 32, 4, 2
    params = unit_level(rng, 1, C, C_in=C_in, post=True)
    scales = act_scales(rng, C)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_torch(params)
    jw = jvk.pack_mrf_ptc_weights(jp, 1, KS, DILS, p, scales)
    tw = vk.pack_mrf_ptc_weights(
        tp, 1, KS, DILS, p,
        [tuple(torch.from_numpy(s) for s in e) for e in scales])
    ju = jvk.pack_ups_ptc_weights(jp['ups_1']['w'], jp['ups_1']['b'], 2, 1,
                                  p_in)
    tu = vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2, 1,
                                 p_in)
    jq = jvk.pack_post_ptc_weights(jp['conv_post']['w'],
                                   jp['conv_post']['b'], p, jnp.bfloat16)
    tq = vk.pack_post_ptc_weights(tp['conv_post']['w'], tp['conv_post']['b'],
                                  p, torch.bfloat16)
    assert tu[3] == ju[3] and tq[2] == jq[2]
    pairs = list(zip(tw, jw)) + list(zip(tu[:3], ju[:3])) + \
        list(zip(tq[:2], jq[:2]))
    assert len(pairs) == 63 + 3 + 2
    for a, b in pairs:
        assert a.shape == b.shape
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    for args in (((3, 1, 2), (7, 5, 4), (11, 3, 2)),):
        for k, d, pp in args:
            assert vk._ptc_spec(k, d, pp) == jvk._ptc_spec(k, d, pp)
    for pp in (2, 4):
        assert vk.ptc_chain_halo(KS, DILS, pp) == \
            jvk.ptc_chain_halo(KS, DILS, pp)
        for tile in (64, 512, 8192):
            assert vk._ptc_chain_geometry(KS, DILS, pp, tile, 64) == \
                jvk._ptc_chain_geometry(KS, DILS, pp, tile, 64)
            assert vk.ptc_post_feasible(KS, DILS, pp, 7, tile) == \
                jvk.ptc_post_feasible(KS, DILS, pp, 7, tile)
    for k, s, pad, pi in ((4, 2, 1, 1), (4, 2, 1, 2), (16, 8, 4, 1)):
        assert vk._ups_phase_entries(k, s, pad, pi) == \
            jvk._ups_phase_entries(k, s, pad, pi)


def test_quantisers_match_jax():
    """Ties round to even, saturation at +-127 (never -128), the lrelu
    slope folded into the multiplier, the s32 boundary's clip."""
    rng = np.random.RandomState(9)
    x = np.concatenate([rng.randn(4000).astype(np.float32) * 60,
                        np.array([0.5, 1.5, 2.5, -0.5, -2.5, -1e4, 1e4],
                                 np.float32)])
    inv = np.float32(1.0)
    assert np.array_equal(
        vk.quantize_lrelu_static(torch.from_numpy(x), torch.tensor(inv))
        .numpy(), np.asarray(jvk._quantize_lrelu_static(jnp.asarray(x), inv)))
    acc = rng.randint(-2 ** 20, 2 ** 20, 4000).astype(np.int32)
    b = rng.randint(-2 ** 10, 2 ** 10, 4000).astype(np.int32)
    m = (rng.rand(4000) * 1e-3).astype(np.float32)
    assert np.array_equal(
        vk.requant_lrelu_s32(torch.from_numpy(acc), torch.from_numpy(b),
                             torch.from_numpy(m)).numpy(),
        np.asarray(jvk._requant_lrelu_s32(jnp.asarray(acc), jnp.asarray(b),
                                          jnp.asarray(m))))
    sw = np.array([1e-32, 1e-3, 0.02], np.float32)
    b1 = np.array([0.3, -0.3, 0.1], np.float32)
    inv2 = np.array([50.0, 60.0, 70.0], np.float32)
    for t, j in zip(vk.fuse_boundary_consts(*map(torch.from_numpy,
                                                 (sw, b1, inv2))),
                    jvk._fuse_boundary_consts(*map(jnp.asarray,
                                                   (sw, b1, inv2)))):
        assert np.array_equal(t.numpy(), np.asarray(j))

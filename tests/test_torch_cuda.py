"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card. The file
imports no JAX and nothing else of tests/, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bands: float32 calls rel-L2 <= 1e-5 (summation order only); bf16 calls
rel-L2 <= 1e-2 (summation order can flip a bf16 rounding of an
intermediate).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from daft_exprt_torch.ops import vocoder_kernels as vk
from daft_exprt_torch.ops.attention_kernels import (
    attention_bwd_plain, attention_plain, fused_attention, fused_attention_bwd,
)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))


def mrf_params(rng, level, C, kernel_sizes, dilations, w_scale=0.05):
    return {f'resblock_{level}_{j}': {
        f'{pre}_{i}': {'w': (rng.randn(C, C, k) * w_scale).astype(np.float32),
                       'b': (rng.randn(C) * 0.02).astype(np.float32)}
        for pre in ('convs1', 'convs2') for i in range(len(dils))}
        for j, (k, dils) in enumerate(zip(kernel_sizes, dilations))}

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
DTYPES = [torch.float32, torch.bfloat16]


def _band(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


def _cuda_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cuda_tree(v, dtype) for k, v in tree.items()}
    return tree.cuda().to(dtype)


# T: one tile, a ragged last tile (1000), whole tiles, and past the old
# float32 limit of 2048 (the kernels stream any T); lengths at the 64-key
# tile edges
ATTN_T = [(T, dt) for T in (128, 1000, 1024, 2048, 2500) for dt in DTYPES]


def _call_key(q, p):
    """The attention wrappers' ``.calls`` key of a call."""
    key = tuple(q.shape) + (p,)
    return key + ('float32',) if q.dtype == torch.float32 else key


def _edge_lengths(T, B):
    """B key lengths: T, T // 3 and the tile edges 1, 63, 64, 65."""
    lens = [T, T // 3, 1, 63, 64, 65][:B]
    return torch.tensor([min(max(n, 1), T) for n in lens],
                        dtype=torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize('T,dtype', ATTN_T)
def test_attention_kernel_matches_plain(T, dtype):
    need_cuda()
    rng = np.random.RandomState(T)
    B, H, D = 6, 2, 64
    q, k, v = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
               .cuda().to(dtype) for _ in range(3))
    q = q * D ** -0.5
    lengths = _edge_lengths(T, B)
    n, c = fused_attention.launches, fused_attention.calls[_call_key(q, 0.0)]
    out = fused_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fused_attention.launches == n + 1
    assert fused_attention.calls[_call_key(q, 0.0)] == c + 1
    ref = attention_plain(q, k, v, lengths)
    assert rel_l2(out.float().cpu(), ref.float().cpu()) < _band(dtype)


def _attention_inputs(T, dtype, seed, B=3, H=2, D=64):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
                   .cuda().to(dtype) for _ in range(4))
    return q * D ** -0.5, k, v, do, _edge_lengths(T, B)


@pytest.mark.cuda
@pytest.mark.parametrize('T,dtype', ATTN_T)
def test_attention_dropout_kernel_matches_plain(T, dtype):
    """The forward at p = 0.1: the kernel and the plain version draw the
    same Philox mask, so they agree as at p = 0."""
    need_cuda()
    q, k, v, _, lengths = _attention_inputs(T, dtype, T + 1, B=6)
    seed = torch.tensor([987654321], dtype=torch.int64, device='cuda')
    n = fused_attention.launches
    out = fused_attention(q, k, v, lengths, seed, 0.1)
    torch.cuda.synchronize()
    assert fused_attention.launches == n + 1
    ref = attention_plain(q, k, v, lengths, seed, 0.1)
    assert rel_l2(out.float().cpu(), ref.float().cpu()) < _band(dtype)
    # dropout changes the output: the mask is applied
    assert rel_l2(attention_plain(q, k, v, lengths).float().cpu(),
                  ref.float().cpu()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize('p', [0.0, 0.1])
@pytest.mark.parametrize('T,dtype', ATTN_T)
def test_attention_bwd_kernel_matches_plain(p, T, dtype):
    """dq, dk, dv of the backward kernel against attention_bwd_plain, and
    two calls bit-identical (dk and dv are summed in a fixed order)."""
    need_cuda()
    q, k, v, do, lengths = _attention_inputs(T, dtype, T + int(p * 10), B=6)
    seed = torch.tensor([2 ** 32 - 5], dtype=torch.int64, device='cuda')
    n = fused_attention_bwd.launches
    c = fused_attention_bwd.calls[_call_key(q, p)]
    got = fused_attention_bwd(q, k, v, do, lengths, seed, p)
    again = fused_attention_bwd(q, k, v, do, lengths, seed, p)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == n + 4          # two per call
    assert fused_attention_bwd.calls[_call_key(q, p)] == c + 2
    ref = attention_bwd_plain(q, k, v, do, lengths, seed, p)
    for a, b, r in zip(got, again, ref):
        assert a.dtype == dtype and a.shape == q.shape
        assert torch.equal(a, b)
        assert rel_l2(a.float().cpu(), r.float().cpu()) < _band(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_attention_kernel_gradient_through_autograd(dtype):
    """fused_attention's autograd gradient is the backward kernel's."""
    need_cuda()
    q, k, v, do, lengths = _attention_inputs(256, dtype, 5)
    seed = torch.tensor([11], dtype=torch.int64, device='cuda')
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    n = fused_attention_bwd.launches
    fused_attention(qq, kk, vv, lengths, seed, 0.1).backward(do)
    assert fused_attention_bwd.launches == n + 2
    ref = attention_bwd_plain(q, k, v, do, lengths, seed, 0.1)
    for t, r in zip((qq, kk, vv), ref):
        assert t.grad.dtype == dtype
        assert rel_l2(t.grad.float().cpu(), r.float().cpu()) < _band(dtype)


@pytest.mark.cuda
def test_attention_float32_length_limit():
    """float32 calls have no length limit (the FMA kernels' T <= 2048 is
    gone): at T = 2049 and 2500, with dropout, the forward and the
    backward match their plain versions within the float32 band."""
    need_cuda()
    seed = torch.tensor([31337], dtype=torch.int64, device='cuda')
    for T in (2049, 2500):
        q, k, v, do, lengths = _attention_inputs(T, torch.float32, T, B=2)
        out = fused_attention(q, k, v, lengths, seed, 0.1)
        got = fused_attention_bwd(q, k, v, do, lengths, seed, 0.1)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, lengths, seed, 0.1)
        assert out.shape == q.shape and rel_l2(out, ref) < 1e-5
        for a, r in zip(got, attention_bwd_plain(q, k, v, do, lengths, seed,
                                                 0.1)):
            assert a.shape == q.shape and rel_l2(a, r) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('C', [128, 256])
@pytest.mark.parametrize('dtype', DTYPES)
def test_mrf_tc_kernel_matches_plain(C, dtype):
    need_cuda()
    rng = np.random.RandomState(C)
    tp = to_torch(mrf_params(rng, 0, C, KS, DILS, w_scale=0.03))
    w = [t.cuda().to(dtype) for t in vk.pack_mrf_tc_weights(tp, 0, KS, DILS)]
    x = torch.from_numpy((rng.randn(2, 1000, C) * 0.5).astype(np.float32)
                         ).cuda().to(dtype)
    n = vk.fused_mrf_tc.launches
    out = vk.fused_mrf_tc(x, vk.prepare_mrf(w, KS, DILS))
    torch.cuda.synchronize()
    # one chain-kernel launch per chain (bf16 engine, float32 3xTF32)
    assert vk.fused_mrf_tc.launches == n + 3
    ref = vk.mrf_tc_plain(x, w, KS, DILS)
    assert rel_l2(out.float().cpu(), ref.float().cpu()) < _band(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,post', [(128, 64, False), (64, 32, True)])
@pytest.mark.parametrize('dtype', DTYPES)
def test_mrf_phase_kernel_matches_plain(C_in, C, post, dtype):
    need_cuda()
    rng = np.random.RandomState(C)
    tp = mrf_params(rng, 1, C, KS, DILS)
    tp['ups_1'] = {'w': (rng.randn(C_in, C, 4) * 0.05).astype(np.float32),
                   'b': (rng.randn(C) * 0.05).astype(np.float32)}
    tp['conv_post'] = {'w': (rng.randn(1, C, 7) * 0.1).astype(np.float32),
                       'b': (rng.randn(1) * 0.05).astype(np.float32)}
    tp = _cuda_tree(to_torch(tp), dtype)
    w = vk.pack_mrf_tc_weights(tp, 1, KS, DILS)
    ups = (tp['ups_1']['w'], tp['ups_1']['b'], 2, 1)
    pst = (tp['conv_post']['w'], tp['conv_post']['b']) if post else None
    # channel-major input and a transposed channel-last one
    x = torch.from_numpy((rng.randn(2, C_in, 500) * 0.5).astype(np.float32)
                         ).cuda().to(dtype)
    mrf = vk.prepare_mrf(w, KS, DILS, ups, pst)
    for xin in (x, x.transpose(1, 2).contiguous().transpose(1, 2)):
        n = vk.fused_mrf_phase.launches
        out = vk.fused_mrf_phase(xin, mrf)
        torch.cuda.synchronize()
        # one launch: phase_bf_kernel in bf16, phase_f32_kernel (3xTF32)
        # in float32
        assert vk.fused_mrf_phase.launches == n + 1
        ref = vk.mrf_phase_plain(xin, w, KS, DILS, ups, pst)
        assert out.shape == ref.shape
        assert rel_l2(out.float().cpu(), ref.float().cpu()) < _band(dtype)


def _tc_bf_case(C, B, T, seed):
    rng = np.random.RandomState(seed)
    tp = to_torch(mrf_params(rng, 0, C, KS, DILS, w_scale=(C * 7) ** -0.5))
    w = [t.cuda().to(torch.bfloat16)
         for t in vk.pack_mrf_tc_weights(tp, 0, KS, DILS)]
    x = torch.randn((B, T, C), generator=torch.Generator().manual_seed(seed)
                    ).cuda().to(torch.bfloat16)
    return w, x


# the bf16 path's shapes (B = 8 x 1024 frames) at B = 1 and 3, and an odd T
TC_BF_SHAPES = [(C, B, T) for C, T0 in ((256, 8192), (128, 65536))
                for B, T in ((1, T0), (3, T0), (1, T0 - 1))]


@pytest.mark.cuda
@pytest.mark.parametrize('C,B,T', TC_BF_SHAPES)
def test_mrf_tc_bf16_engine_at_path_shapes(C, B, T):
    """tc_bf_kernel (3 launches, never the step kernel) against the plain
    version; the same call twice is bit-identical."""
    need_cuda()
    w, x = _tc_bf_case(C, B, T, C + B + T)
    mrf = vk.prepare_mrf(w, KS, DILS)
    assert mrf.blk is not None
    n = vk.fused_mrf_tc.launches
    out = vk.fused_mrf_tc(x, mrf)
    again = vk.fused_mrf_tc(x, mrf)
    torch.cuda.synchronize()
    assert vk.fused_mrf_tc.launches == n + 6
    assert torch.equal(out, again)
    ref = vk.mrf_tc_plain(x, w, KS, DILS)
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert rel_l2(out.float(), ref.float()) < 1e-2


def _phase_bf_case(C_in, C, B, T_in, post, seed):
    rng = np.random.RandomState(seed)
    tp = mrf_params(rng, 0, C, KS, DILS, w_scale=(C * 7) ** -0.5)
    tp['ups_0'] = {'w': (rng.randn(C_in, C, 4) * (2 * C_in) ** -0.5
                         ).astype(np.float32),
                   'b': (rng.randn(C) * 0.05).astype(np.float32)}
    tp['conv_post'] = {'w': (rng.randn(1, C, 7) * (7 * C) ** -0.5
                             ).astype(np.float32),
                       'b': (rng.randn(1) * 0.05).astype(np.float32)}
    tp = _cuda_tree(to_torch(tp), torch.bfloat16)
    w = vk.pack_mrf_tc_weights(tp, 0, KS, DILS)
    ups = (tp['ups_0']['w'], tp['ups_0']['b'], 2, 1)
    pst = (tp['conv_post']['w'], tp['conv_post']['b']) if post else None
    # a transposed (B, T, C) input, as the generator hands over
    x = torch.randn((B, T_in, C_in), generator=torch.Generator().manual_seed(
        seed)).cuda().to(torch.bfloat16).transpose(1, 2)
    return w, ups, pst, x


PHASE_BF_SHAPES = [(C_in, C, B, T_in) for C_in, C, T0 in (
    (128, 64, 65536), (64, 32, 131072))
    for B, T_in in ((1, T0), (3, T0), (1, T0 - 1))]


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,B,T_in', PHASE_BF_SHAPES)
def test_mrf_phase_bf16_engine_at_path_shapes(C_in, C, B, T_in):
    """phase_bf_kernel (1 launch, with conv_post at C = 32 as on the path)
    against the plain version, from a channel-last and a channel-major
    input; the same call twice is bit-identical."""
    need_cuda()
    post = C == 32
    w, ups, pst, x = _phase_bf_case(C_in, C, B, T_in, post, C + B + T_in)
    mrf = vk.prepare_mrf(w, KS, DILS, ups, pst)
    assert mrf.blk is not None and mrf.blk_ups is not None
    ref = vk.mrf_phase_plain(x, w, KS, DILS, ups, pst)
    for xin in (x, x.contiguous()):
        n = vk.fused_mrf_phase.launches
        out = vk.fused_mrf_phase(xin, mrf)
        again = vk.fused_mrf_phase(xin, mrf)
        torch.cuda.synchronize()
        assert vk.fused_mrf_phase.launches == n + 2
        assert torch.equal(out, again)
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        assert out.is_contiguous()
        assert rel_l2(out.float(), ref.float()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,B,T_in', PHASE_BF_SHAPES)
def test_mrf_phase_f32_engine_at_path_shapes(C_in, C, B, T_in):
    """phase_f32_kernel (1 launch a call, with conv_post at C = 32 as on
    the fast-f32 path) against the plain version (TF32 off) at the
    float32 band, from a channel-last and a channel-major input; the same
    call twice is bit-identical."""
    need_cuda()
    post = C == 32
    w, ups, pst, x = _phase_bf_case(C_in, C, B, T_in, post, C + B + T_in)
    w = [t.float() for t in w]
    ups = (ups[0].float(), ups[1].float()) + ups[2:]
    pst = None if pst is None else tuple(t.float() for t in pst)
    x = torch.randn(x.transpose(1, 2).shape, generator=torch.Generator(
        ).manual_seed(T_in)).cuda().transpose(1, 2)
    mrf = vk.prepare_mrf(w, KS, DILS, ups, pst)
    assert mrf.blk is not None and mrf.blk_ups is not None
    ref = vk.mrf_phase_plain(x, w, KS, DILS, ups, pst)
    for xin in (x, x.contiguous()):
        n = vk.fused_mrf_phase.launches
        key = tuple(xin.shape) + ('float32',)
        c = vk.fused_mrf_phase.calls[key]
        out = vk.fused_mrf_phase(xin, mrf)
        again = vk.fused_mrf_phase(xin, mrf)
        torch.cuda.synchronize()
        assert vk.fused_mrf_phase.launches == n + 2
        assert vk.fused_mrf_phase.calls[key] == c + 2
        assert torch.equal(out, again)
        assert out.dtype == torch.float32 and out.is_contiguous()
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert rel_l2(out, ref) < 1e-5


@pytest.mark.cuda
def test_mrf_phase_f32_engine_refuses_what_it_does_not_take():
    """No float32 fused_mrf_phase call falls back to another route: a
    width the kernel has no instantiation for, and weights without the
    float32 chain kernel's form, raise."""
    need_cuda()
    n = vk.fused_mrf_phase.launches
    for C_in, C, engine, match in ((128, 64, False, 'no float32 engine form'),
                                   (32, 16, True, 'no CUDA instantiation')):
        w, ups, pst, x = _phase_bf_case(C_in, C, 1, 256, False, C)
        w = [t.float() for t in w]
        ups = (ups[0].float(), ups[1].float()) + ups[2:]
        mrf = vk.prepare_mrf(w, KS, DILS, ups, None)
        if not engine:
            mrf = replace(mrf, blk=None, blk_ups=None)
        with pytest.raises(ValueError, match=match):
            vk.fused_mrf_phase(x.float(), mrf)
    assert vk.fused_mrf_phase.launches == n


@pytest.mark.cuda
def test_mrf_bf16_engine_refuses_what_it_does_not_take():
    """No bf16 or float32 tc call falls back to the step kernel: a width
    the engine has no instantiation for, and weights without the engine's
    form, raise."""
    need_cuda()
    w, x = _tc_bf_case(64, 1, 256, 1)
    with pytest.raises(ValueError, match='no CUDA instantiation'):
        vk.fused_mrf_tc(x, vk.prepare_mrf(w, KS, DILS))
    w, x = _tc_bf_case(128, 1, 256, 2)
    n = vk.fused_mrf_tc.launches
    with pytest.raises(ValueError, match='no bf16 engine form'):
        vk.fused_mrf_tc(x, replace(vk.prepare_mrf(w, KS, DILS), blk=None))
    w, ups, pst, x = _phase_bf_case(128, 64, 1, 256, False, 3)
    with pytest.raises(ValueError, match='no bf16 engine form'):
        vk.fused_mrf_phase(x, replace(vk.prepare_mrf(w, KS, DILS, ups, pst),
                                      blk=None, blk_ups=None))
    w, ups, pst, x = _phase_bf_case(32, 16, 1, 256, False, 4)
    with pytest.raises(ValueError, match='no CUDA instantiation'):
        vk.fused_mrf_phase(x, vk.prepare_mrf(w, KS, DILS, ups, pst))
    # float32 weights without the float32 chain kernel's form
    w, x = _tc_bf_case(128, 1, 256, 5)
    w, x = [t.float() for t in w], x.float()
    with pytest.raises(ValueError, match='no float32 engine form'):
        vk.fused_mrf_tc(x, replace(vk.prepare_mrf(w, KS, DILS), blk=None))
    assert vk.fused_mrf_tc.launches == n


@pytest.mark.cuda
def test_attention_kernel_raises_for_other_head_dims():
    need_cuda()
    q = torch.zeros((1, 2, 16, 32), device='cuda')
    with pytest.raises(ValueError, match='head dim'):
        fused_attention(q, q, q, torch.full((1,), 16, device='cuda'))


# ----------------------------------------------------------------------
# int8-static tier. Band rel-L2 <= 2e-3 (NUMERICS_r05.json
# ptc_vs_banded_int8): the s32 sums are exact and the f32 epilogues round
# as the plain versions do, but conv_post sums in another order and an
# ulp there, or in a library op of the plain version, can flip an int8
# value downstream.
# ----------------------------------------------------------------------

def unit_params(rng, C, C_in=None, post=False):
    """One level's params with unit-gain convs (std 1/sqrt(fan-in))."""
    p = {f'resblock_1_{j}': {
        f'{pre}_{i}': {'w': (rng.randn(C, C, k) * (C * k) ** -0.5
                             ).astype(np.float32),
                       'b': (rng.randn(C) * 0.05).astype(np.float32)}
        for pre in ('convs1', 'convs2') for i in range(len(dils))}
        for j, (k, dils) in enumerate(zip(KS, DILS))}
    if C_in is not None:
        p['ups_1'] = {'w': (rng.randn(C_in, C, 4) * (C_in * 2) ** -0.5
                            ).astype(np.float32),
                      'b': (rng.randn(C) * 0.05).astype(np.float32)}
    if post:
        p['conv_post'] = {'w': (rng.randn(1, C, 7) * (C * 7) ** -0.5
                                ).astype(np.float32),
                          'b': (rng.randn(1) * 0.05).astype(np.float32)}
    return _cuda_tree(to_torch(p), torch.bfloat16)


def q8_scales(rng, C):
    return [tuple(torch.from_numpy((0.5 + rng.rand(len(d), C))
                                   .astype(np.float32)).cuda()
                  for _ in range(2)) for d in DILS]


def _report(name, out, ref):
    """rel-L2 and max-abs of a kernel against its plain version (printed:
    the block-resident int8 kernels are expected to be exact)."""
    o, r = out.float().cpu(), ref.float().cpu()
    err = float((o - r).abs().max())
    print(f'{name}: max_abs={err:.3e} rel_l2={rel_l2(o, r):.3e}')
    return rel_l2(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize('C', [128, 256])
@pytest.mark.parametrize('B,T', [(2, 1000), (1, 777), (3, 4100)])
def test_mrf_tc_q8_kernel_matches_plain(C, B, T):
    """tc_chain_q8_kernel: one launch per chain; ragged T (blocks of 128
    samples, a partial last one), utterance edges, B in {1, 2, 3}."""
    need_cuda()
    rng = np.random.RandomState(C + T)
    tp = unit_params(rng, C)
    mrf = vk.prepare_mrf_tc_q8(vk.pack_mrf_tc_int8_weights(
        tp, 1, KS, DILS, q8_scales(rng, C)), KS, DILS)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    n, c = vk.fused_mrf_tc_q8.launches, vk.fused_mrf_tc_q8.calls[(B, T, C)]
    out = vk.fused_mrf_tc_q8(x, mrf)
    torch.cuda.synchronize()
    assert vk.fused_mrf_tc_q8.launches == n + 3       # one per chain
    assert vk.fused_mrf_tc_q8.calls[(B, T, C)] == c + 1
    ref = vk.mrf_tc_q8_plain(x, mrf)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert _report(f'tc q8 ({B},{T},{C})', out, ref) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
@pytest.mark.parametrize('B,rows,tile', [(2, 1024, 256), (1, 1024, 256),
                                         (3, 640, 128)])
def test_mrf_ptc_kernel_matches_plain(C_in, C, p_in, post, B, rows, tile):
    """V1's L2 and L3 (with conv_post) in the static mode: the tile amax
    and ptc_fused_q8_kernel; tiles of 256 or 128 rows, one of them loud,
    so the tiles' upsample scales differ."""
    need_cuda()
    rng = np.random.RandomState(C + rows)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    ups = vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2, 1,
                                  p_in)
    pst = vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                   tp['conv_post']['b'], p,
                                   torch.bfloat16) if post else None
    mrf = vk.prepare_mrf_ptc(
        vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p, q8_scales(rng, C)), KS,
        DILS, p, tuple(ups) + (4, 2, 1, p_in), pst)
    x = torch.from_numpy((rng.randn(B, rows * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[0, tile * p_in:2 * tile * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    from daft_exprt_torch.ops import mrf_int8 as mi
    n = mi.fused_mrf_ptc.launches
    out = mi.fused_mrf_ptc(x, mrf, tile)
    torch.cuda.synchronize()
    assert mi.fused_mrf_ptc.launches == n + 2         # amax, fused kernel
    ref = mi.mrf_ptc_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert out.shape == ((B, 1, rows * p) if post else (B, rows * p, C))
    assert _report(f'ptc static ({B},{rows * p_in},{C_in})->{C}', out,
                   ref) <= 2e-3


# ----------------------------------------------------------------------
# int8-dynamic tier and the int8 phase kernel (ops/mrf_int8.py). Same
# band: the s32 sums are exact and the f32 epilogues round as the plain
# versions do; a flip of one int8 value near a tile's amax can requantise
# the tile.
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('C,T,tile', [(128, 2048, 512), (256, 1536, 512)])
def test_mrf_ct_q8_kernel_matches_plain(C, T, tile):
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C)
    tp = unit_params(rng, C)
    mrf = mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
        mi.pack_mrf_weights(tp, 1, KS, DILS)), KS, DILS)
    x = torch.from_numpy((rng.randn(2, T, C) * 0.5).astype(np.float32))
    x[0, :tile] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n, c = mi.fused_mrf_ct_q8.launches, mi.fused_mrf_ct_q8.calls[(2, T, C)]
    out = mi.fused_mrf_ct_q8(x, mrf, tile)
    torch.cuda.synchronize()
    assert mi.fused_mrf_ct_q8.launches == n + 4      # amax, one per chain
    assert mi.fused_mrf_ct_q8.calls[(2, T, C)] == c + 1
    ref = mi.mrf_ct_q8_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
    assert torch.equal(out.cpu(), ref.cpu())         # the engine: exact


@pytest.mark.cuda
@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_mrf_phase_q8_kernel_matches_plain(C_in, C, p_in, post, static):
    """V1's L2 and L3 (with conv_post), four tiles of 256 columns, one of
    them loud; dynamic and q8f."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + static)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    scales = None
    if static:
        scales = [s[i] for s1, s2 in q8_scales(rng, C)
                  for i in range(s1.shape[0]) for s in (s1, s2)]
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p, scales)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    ups = mi.quantize_ups_phase_weights(
        wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
    pst = mi.pack_post_phase_weights(tp['conv_post']['w'],
                                     tp['conv_post']['b'], p) if post else None
    mrf = mi.prepare_mrf_phase_q8(qw, KS, DILS, p,
                                  tuple(ups) + (4, 2, 1, p_in), pst)
    cols, tile = 1024, 256
    x = torch.from_numpy((rng.randn(2, cols * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[0, 256 * p_in:512 * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n = mi.fused_mrf_phase_q8.launches
    out = mi.fused_mrf_phase_q8(x, mrf, tile)
    torch.cuda.synchronize()
    # amax, then the dynamic engine or (q8f) ptc_fused_q8_kernel
    assert mi.fused_mrf_phase_q8.launches == n + 2
    ref = mi.mrf_phase_q8_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert out.shape == ((2, 1, cols * p) if post else (2, cols * p, C))
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
    assert_exact(out, ref, post)


def assert_exact(out, ref, post=False):
    """Every sample equal; a conv_post waveform within one bf16 ulp at its
    full scale, 2^-8 (conv_post sums 7 x C float32 terms in another order
    than the plain version's library conv, as the one-launch-per-conv
    kernels did)."""
    o, r = out.float().cpu(), ref.float().cpu()
    err = float((o - r).abs().max())
    assert (err <= 2.0 ** -8) if post else torch.equal(o, r), err


# The segment-synchronised dynamic engine (csrc/mrf_dyn_blk.cuh) at V1's
# widths: exact against the plain versions; B in {1, 2, 3}; segments of
# 18 (C = 256, tile 2048), 34 (C = 128, tile 4096) and 132 blocks (phase,
# tile 8192) so that a call takes more than one wave of segments, the last
# one ragged; smaller tiles; each level called twice in a row on one
# stream (a stale barrier counter or scale word would show).

@pytest.mark.cuda
@pytest.mark.parametrize('C,B,T,tile', [
    (256, 1, 4096, 2048), (256, 3, 6144, 2048), (256, 2, 1536, 512),
    (128, 1, 4096, 4096), (128, 2, 8192, 4096), (128, 3, 3072, 1024)])
def test_dyn_engine_ct_matches_plain(C, B, T, tile):
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + T + B)
    tp = unit_params(rng, C)
    mrf = mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
        mi.pack_mrf_weights(tp, 1, KS, DILS)), KS, DILS)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32))
    x[-1, :tile] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n = mi.fused_mrf_ct_q8.launches
    outs = [mi.fused_mrf_ct_q8(x, mrf, tile) for _ in range(2)]
    torch.cuda.synchronize()
    assert mi.fused_mrf_ct_q8.launches == n + 8
    ref = mi.mrf_ct_q8_plain(x, mrf, tile)
    for out in outs:
        _report(f'dyn engine ct ({B},{T},{C}) tile {tile}', out, ref)
        assert_exact(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
@pytest.mark.parametrize('B,cols,tile', [(1, 8192, 8192), (2, 16384, 8192),
                                         (3, 1024, 256)])
def test_dyn_engine_phase_matches_plain(C_in, C, p_in, post, B, cols, tile):
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + cols + B)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    ups = mi.quantize_ups_phase_weights(
        wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
    pst = mi.pack_post_phase_weights(tp['conv_post']['w'],
                                     tp['conv_post']['b'], p) if post else None
    mrf = mi.prepare_mrf_phase_q8(qw, KS, DILS, p,
                                  tuple(ups) + (4, 2, 1, p_in), pst)
    x = torch.from_numpy((rng.randn(B, cols * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[-1, :tile * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n = mi.fused_mrf_phase_q8.launches
    outs = [mi.fused_mrf_phase_q8(x, mrf, tile) for _ in range(2)]
    torch.cuda.synchronize()
    assert mi.fused_mrf_phase_q8.launches == n + 4
    ref = mi.mrf_phase_q8_plain(x, mrf, tile)
    for out in outs:
        assert out.shape == ref.shape
        _report(f'dyn engine phase ({B},{cols * p_in},{C_in}) tile {tile}',
                out, ref)
        assert_exact(out, ref, post)
    if post:       # the chain mean before conv_post: exact
        from dataclasses import replace
        bare = replace(mrf, post=None, post_dev=None)
        assert_exact(mi.fused_mrf_phase_q8(x, bare, tile),
                     mi.mrf_phase_q8_plain(x, bare, tile))


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_dyn_engine_ptc_matches_plain(C_in, C, p_in, post):
    """fused_mrf_ptc's dyn mode at the int8-partial path's shapes (B = 8,
    8192-row tiles, one loud): amax and one engine launch a call, every
    sample equal to mrf_ptc_plain (a conv_post waveform within one bf16
    ulp; the chain mean before it exact)."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + 5)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    pst = vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                   tp['conv_post']['b'], p,
                                   torch.bfloat16) if post else None
    mrf = vk.prepare_mrf_ptc(
        vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2,
                                      1, p_in)) + (4, 2, 1, p_in), pst)
    assert mrf.dynamic and mrf.blk_dev is not None and mrf.chains_dev is None
    rows, tile = 65536, 8192
    x = torch.from_numpy((rng.randn(8, rows * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[-1, :tile * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n = mi.fused_mrf_ptc.launches
    out = mi.fused_mrf_ptc(x, mrf, tile)
    torch.cuda.synchronize()
    assert mi.fused_mrf_ptc.launches == n + 2
    ref = mi.mrf_ptc_plain(x, mrf, tile)
    assert out.shape == ref.shape
    _report(f'dyn engine ptc ({8},{rows * p_in},{C_in}) tile {tile}', out, ref)
    assert_exact(out, ref, post)
    if post:       # the chain mean before conv_post: exact
        from dataclasses import replace
        bare = replace(mrf, post=None, post_dev=None)
        assert_exact(mi.fused_mrf_ptc(x, bare, tile),
                     mi.mrf_ptc_plain(x, bare, tile))


@pytest.mark.cuda
def test_dyn_engine_refuses_short_scratch(monkeypatch):
    """At C = 256 each block's R and conv1's first pass live in a global
    scratch slice; a table that says R fits in shared memory gives the
    kernel a scratch too small for its DynCfg, and the launch raises
    instead of writing past it."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(5)
    mrf = mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
        mi.pack_mrf_weights(unit_params(rng, 256), 1, KS, DILS)), KS, DILS)
    x = torch.from_numpy((rng.randn(1, 2048, 256) * 0.5).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    monkeypatch.setitem(mi.DYN_BLK_CFG, (256, 256),
                        mi.DYN_BLK_CFG[256, 256]._replace(r_smem=True))
    with pytest.raises(RuntimeError, match='dynamic engine'):
        mi.fused_mrf_ct_q8(x, mrf, 2048)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# HiFi-GAN V2's levels: the float level kernels without upsample
# (ops/mrf_ct.py: ct_kernel over CtBf and CtF32 behind two wrappers, one
# launch a level) at C = 64..8, the int8 ct kernel in its q8f and dynamic
# modes at C = 64 and 32, and the int8 phase kernel without prologue at C =
# 32, p = 4 (ops/mrf_int8.py). Shapes: V2's levels at batch 1 ((1, 8192,
# 64), (1, 65536, 32), (1, 131072, 16), (1, 262144, 8): 32 frames), the ct
# fallback at 12 frames, and tail blocks (lengths no planned block divides).
# ----------------------------------------------------------------------

V2_SHAPES = [(1, 8192, 64), (1, 65536, 32), (1, 131072, 16),
             (1, 262144, 8), (2, 768, 32), (2, 1536, 16), (2, 1000, 64),
             (3, 4099, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', V2_SHAPES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_mrf_ct_kernel_matches_plain(shape, dtype):
    """Both wrappers of mrf_ct.cu, one launch a call; C = 8 runs the bf16
    engine's tap pairs."""
    from daft_exprt_torch.ops import mrf_ct as mc
    need_cuda()
    B, T, C = shape
    rng = np.random.RandomState(C + T)
    tp = _cuda_tree(to_torch(mrf_params(rng, 0, C, KS, DILS,
                                        w_scale=(C * 7) ** -0.5)), dtype)
    mrf = vk.prepare_mrf(vk.pack_mrf_tc_weights(tp, 0, KS, DILS), KS, DILS)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32)
                         ).cuda().to(dtype)
    bm = vk.ct_block(C, dtype == torch.float32, KS, DILS, B, T,
                     vk.sm_count(x.device))
    key = shape + (('float32',) if dtype == torch.float32 else ())
    with vk.full_f32():
        ref = mc.mrf_ct_plain(x, mrf)
    for fn in (mc.fused_mrf_ct, mc.fused_mrf_phase_noups):
        n, c = fn.launches, fn.calls[key]
        out = fn(x, mrf)
        torch.cuda.synchronize()
        assert fn.launches == n + 1 and fn.calls[key] == c + 1
        assert out.dtype == dtype and out.shape == ref.shape
        assert torch.isfinite(out.float()).all(), bm
        assert rel_l2(out.float().cpu(), ref.float().cpu()) <= _band(dtype), \
            bm


def _v2_int8_level(rng, C, static):
    from daft_exprt_torch.ops import mrf_int8 as mi
    tp = unit_params(rng, C)
    w = mi.pack_mrf_weights(tp, 1, KS, DILS)
    if static:
        return mi.prepare_mrf_ct_q8f(mi.quantize_mrf_ct_q8f_weights(
            w, [s for s1, s2 in q8_scales(rng, C) for s in (s1, s2)]), KS,
            DILS)
    return mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(w), KS, DILS)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 8192, 64), (2, 768, 32),
                                   (2, 2048, 64), (1, 65536, 32)])
@pytest.mark.parametrize('static', [False, True])
def test_mrf_ct_int8_kernel_matches_plain(shape, static):
    """fused_mrf_ct_q8f (one launch of ptc_fused_q8_kernel without
    prologue) and fused_mrf_ct_q8 at the narrow widths (the window amax and
    one launch of the segment-synchronised engine), tiles by ct_tile; one
    loud tile; every sample equal to the plain version."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    B, T, C = shape
    rng = np.random.RandomState(T + static)
    mrf = _v2_int8_level(rng, C, static)
    tile = mi.ct_tile(T, C)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32))
    x[0, :min(T, 512)] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    fn = mi.fused_mrf_ct_q8f if static else mi.fused_mrf_ct_q8
    n = fn.launches
    out = fn(x, mrf) if static else fn(x, mrf, tile)
    torch.cuda.synchronize()
    assert fn.launches == n + (1 if static else 2)
    ref = mi.mrf_ct_q8f_plain(x, mrf) if static else \
        mi.mrf_ct_q8_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
    _report(f'{fn.__name__} {shape}', out, ref)
    assert_exact(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('T,tile', [(65536, 4096), (3 * 512, 128)])
@pytest.mark.parametrize('static', [False, True])
def test_mrf_phase_q8_noups_kernel_matches_plain(T, tile, static):
    """V2's L1 (C = 32, p = 4) at 32 frames and three tiles of 128
    columns; one loud tile: the window amax and one engine launch
    (dynamic), one launch of ptc_fused_q8_kernel without prologue (q8f);
    every sample equal to the plain version."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(T + static)
    mrf = _v2_int8_level(rng, 32, static)
    x = torch.from_numpy((rng.randn(2, T, 32) * 0.5).astype(np.float32))
    x[1, 512:1024] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    fn = mi.fused_mrf_phase_q8_noups
    n, key = fn.launches, (2, T, 32, 'q8f' if static else 'dynamic')
    c = fn.calls[key]
    out = fn(x, mrf, 4, tile)
    torch.cuda.synchronize()
    assert fn.launches == n + (1 if static else 2)
    assert fn.calls[key] == c + 1
    ref = mi.mrf_phase_q8_noups_plain(x, mrf, 4, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
    _report(f'{fn.__name__} ({2},{T},32) tile {tile}', out, ref)
    assert_exact(out, ref)


# ----------------------------------------------------------------------
# The last TPU kernel modes: the q8s boundary of the int8-static ct and
# phase kernels, fused_mrf_ptc's dyn and fdot modes, fused_resblock1.
# ----------------------------------------------------------------------

def _ph_scales(rng, C):
    return [s[i] for s1, s2 in q8_scales(rng, C) for i in range(s1.shape[0])
            for s in (s1, s2)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 8192, 64), (2, 768, 32)])
def test_mrf_ct_q8s_kernel_matches_plain(shape):
    """fused_mrf_ct_q8s and the q8s phase kernel without prologue at C =
    32, p = 4: one launch of ptc_fused_q8_kernel<C, C, true> each, every
    sample equal to the plain version."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    B, T, C = shape
    rng = np.random.RandomState(T)
    tp = unit_params(rng, C)
    mrf = mi.prepare_mrf_ct_q8s(mi.quantize_mrf_ct_q8s_weights(
        mi.pack_mrf_weights(tp, 1, KS, DILS),
        [s for s1, s2 in q8_scales(rng, C) for s in (s1, s2)]), KS, DILS)
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32))
    x[0, :min(T, 512)] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    ref = mi.mrf_ct_q8s_plain(x, mrf)
    runs = [(mi.fused_mrf_ct_q8s, (x, mrf))]
    if C == 32:
        runs.append((mi.fused_mrf_phase_q8_noups, (x, mrf, 4, 64)))
    for fn, args in runs:
        n = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
        assert_exact(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('B,cols,tile', [(2, 1024, 256), (1, 65536, 4096)])
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_mrf_phase_q8s_kernel_matches_plain(C_in, C, p_in, post, B, cols,
                                            tile):
    """The int8 phase kernel with its upsample prologue in q8s mode: the
    amax and ptc_fused_q8_kernel's q8s form (2 launches a call), exact
    against the plain version (a conv_post waveform within one bf16 ulp);
    small tiles, and V1's L2 / L3 at one 1024-frame utterance (the batch-1
    entry point's shapes)."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + 2)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        _ph_scales(rng, C), fused=False)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    ups = mi.quantize_ups_phase_weights(
        wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
    pst = mi.pack_post_phase_weights(tp['conv_post']['w'],
                                     tp['conv_post']['b'], p) if post else None
    mrf = mi.prepare_mrf_phase_q8(qw, KS, DILS, p,
                                  tuple(ups) + (4, 2, 1, p_in), pst)
    assert mrf.mode == 'q8s' and mrf.chains_dev is None
    x = torch.from_numpy((rng.randn(B, cols * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[0, tile * p_in:2 * tile * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    fn = mi.fused_mrf_phase_q8
    n, key = fn.launches, tuple(x.shape) + ('q8s',)
    c = fn.calls[key]
    out = fn(x, mrf, tile)
    torch.cuda.synchronize()
    assert fn.launches == n + 2 and fn.calls[key] == c + 1
    ref = mi.mrf_phase_q8_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3
    assert_exact(out, ref, post)


@pytest.mark.cuda
def test_mrf_phase_q8s_refuses_unbuilt_widths():
    """No q8s phase call falls back to another route: a width without a
    kernel raises, naming the built ones, and launches nothing."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(5)
    C_in, C, p_in = 32, 16, 2
    tp = unit_params(rng, C, C_in)
    qw = mi.quantize_mrf_phase_weights(
        mi.pack_mrf_phase_weights(tp, 1, KS, DILS, 4), KS, DILS, 4,
        _ph_scales(rng, C), fused=False)
    wb, bu, _, _ = mi.pack_ups_phase_weights(tp['ups_1']['w'],
                                             tp['ups_1']['b'], 2, 1, p_in)
    mrf = mi.prepare_mrf_phase_q8(qw, KS, DILS, 4, tuple(
        mi.quantize_ups_phase_weights(wb, bu, mi.ups_used_blocks(
            4, 2, 1, p_in), C_in)) + (4, 2, 1, p_in))
    x = torch.zeros((1, 512 * p_in, C_in), dtype=torch.bfloat16,
                    device='cuda')
    n = mi.fused_mrf_phase_q8.launches
    with pytest.raises(ValueError, match=r'built for \(\(128, 64\)'):
        mi.fused_mrf_phase_q8(x, mrf, 256)
    assert mi.fused_mrf_phase_q8.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_mrf_ptc_dyn_kernel_matches_plain(C_in, C, p_in, post):
    """fused_mrf_ptc's dyn mode at V1's L2 and L3: four tiles of 256 rows,
    one loud; amax and one launch of the segment-synchronised engine on
    the phase-tc tiles."""
    from daft_exprt_torch.ops import mrf_int8 as mi
    need_cuda()
    rng = np.random.RandomState(C + 3)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    pst = vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                   tp['conv_post']['b'], p,
                                   torch.bfloat16) if post else None
    mrf = vk.prepare_mrf_ptc(
        vk.pack_mrf_ptc_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_weights(tp['ups_1']['w'], tp['ups_1']['b'], 2,
                                      1, p_in)) + (4, 2, 1, p_in), pst)
    assert mrf.dynamic
    rows, tile = 1024, 256
    x = torch.from_numpy((rng.randn(2, rows * p_in, C_in) * 0.5)
                         .astype(np.float32))
    x[0, 256 * p_in:512 * p_in] *= 4.0
    x = x.cuda().to(torch.bfloat16)
    n, key = mi.fused_mrf_ptc.launches, tuple(x.shape) + ('dynamic',) + (
        ('post',) if post else ())
    c = mi.fused_mrf_ptc.calls[key]
    out = mi.fused_mrf_ptc(x, mrf, tile)
    torch.cuda.synchronize()
    assert mi.fused_mrf_ptc.launches == n + 2
    assert mi.fused_mrf_ptc.calls[key] == c + 1
    ref = mi.mrf_ptc_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize('B,rows,tile', [(2, 1024, 256), (8, 65536, 4096)])
@pytest.mark.parametrize('C_in,C,p_in,post', [(128, 64, 1, False),
                                              (64, 32, 2, True)])
def test_mrf_ptc_fdot_kernel_matches_plain(C_in, C, p_in, post, B, rows,
                                           tile):
    """fused_mrf_ptc_f (phase_bf_kernel with a float32 upsample output, one
    launch a call) on a transposed (B, T, C) input, as the generator hands
    it over; small tiles, and V1's L2 / L3 at the bf16-ptc path's shapes
    (B = 8 x 1024 frames). The same call twice is bit-identical."""
    need_cuda()
    rng = np.random.RandomState(C + 4)
    p = 2 * p_in
    tp = unit_params(rng, C, C_in, post)
    pst = vk.pack_post_ptc_weights(tp['conv_post']['w'],
                                   tp['conv_post']['b'], p,
                                   torch.bfloat16) if post else None
    mrf = vk.prepare_mrf_ptc_f(
        vk.pack_mrf_ptc_f_weights(tp, 1, KS, DILS, p), KS, DILS, p,
        tuple(vk.pack_ups_ptc_f_weights(tp['ups_1']['w'], tp['ups_1']['b'],
                                        2, 1, p_in)) + (4, 2, 1, p_in), pst)
    assert mrf.blk is not None
    x = torch.from_numpy((rng.randn(B, rows * p_in, C_in) * 0.5)
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    x = x.transpose(1, 2)
    n = vk.fused_mrf_ptc_f.launches
    out = vk.fused_mrf_ptc_f(x, mrf, tile)
    again = vk.fused_mrf_ptc_f(x, mrf, tile)
    torch.cuda.synchronize()
    assert vk.fused_mrf_ptc_f.launches == n + 2
    assert torch.equal(out, again)
    ref = vk.mrf_ptc_f_plain(x, mrf, tile)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) <= 1e-2


# (k, C, B, T): both widths at both ends of k, and the longest reduction
# (k = 11, K = 11*128 per conv) at the path's length
RESBLOCK1_CASES = [(k, C, 2, 1024) for k in (3, 11) for C in (128, 256)] + [
    (11, 128, 1, 65536)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,C,B,T', RESBLOCK1_CASES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_resblock1_kernel_matches_plain(k, C, B, T, dtype):
    """One launch of the chain kernel per call (tc_f32_kernel in float32,
    tc_bf_kernel in bf16), bit-identical across two calls."""
    need_cuda()
    rng = np.random.RandomState(C + k)
    rb = {f'{pre}_{i}': {'w': (rng.randn(C, C, k) * (C * k) ** -0.5
                               ).astype(np.float32),
                         'b': (rng.randn(C) * 0.05).astype(np.float32)}
          for pre in ('convs1', 'convs2') for i in range(3)}
    w = [t.cuda().to(dtype) for t in vk.pack_resblock_weights(
        to_torch(rb), 3)]
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32)
                         ).cuda().to(dtype)
    n = vk.fused_resblock1.launches
    out = vk.fused_resblock1(x, *w, k, (1, 3, 5), tile=512)
    again = vk.fused_resblock1(x, *w, k, (1, 3, 5), tile=512)
    torch.cuda.synchronize()
    assert vk.fused_resblock1.launches == n + 2
    assert torch.equal(out, again)
    ref = vk.resblock1_plain(x, *w, k, (1, 3, 5), 512)
    assert out.dtype == dtype and out.shape == ref.shape
    assert rel_l2(out.float().cpu(), ref.float().cpu()) < _band(dtype)

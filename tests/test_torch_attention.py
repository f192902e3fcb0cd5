"""The port's attention (daft_exprt_torch/ops/attention_kernels.py)
against the JAX package: its Pallas kernel in interpret mode (forward and
custom-VJP backward) and the XLA branch of MultiHeadSelfAttention, on the
same numpy inputs; and the port's dropout mask, which JAX's cannot match,
against itself: the plain backward against autograd of the plain forward.

Bands: forward float32 max-abs 1e-5; bf16 max-abs 1e-3 (the attention band
of NUMERICS_r05.json), or one bf16 ulp of the reference value where that
is larger: both sides round an f32 sum to bf16, and the sums run in
another order, so a value near a rounding boundary can land one ulp apart.
Backward float32 max-abs 1e-5 of each gradient's largest value; bf16
rel-L2 5e-3 (NUMERICS_r05.json attention backward). The CUDA kernels are
held to the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops.attention_kernels import (
    fused_attention as jax_fused_attention,
)
from daft_exprt_torch.ops.attention_kernels import (
    attention_bwd_plain, attention_plain, dropout_bits, dropout_threshold,
    fused_attention, fused_attention_bwd,
)

from tests.torch_port_utils import max_abs, rel_l2


def _jax_xla(q, k, v, lengths):
    """The XLA branch of modules.MultiHeadSelfAttention."""
    T = q.shape[2]
    s = jnp.einsum('bhqd,bhkd->bhqk', q, k,
                   preferred_element_type=jnp.float32)
    mask = jnp.arange(T)[None, :] < lengths[:, None]
    s = jnp.where(mask[:, None, None, :], s, -1e9)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum('bhqk,bhkd->bhqd', p.astype(v.dtype), v)


def _inputs(T, seed=0, B=3, H=2, D=64):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, T, D) * D ** -0.5).astype(np.float32)
    k = rng.randn(B, H, T, D).astype(np.float32)
    v = rng.randn(B, H, T, D).astype(np.float32)
    lengths = np.array([T, max(1, T // 3), 1][:B], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize('T', [128, 256])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_plain_matches_jax(T, dtype):
    q, k, v, lengths = _inputs(T, seed=T)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jl = jnp.asarray(lengths)
    pallas = np.asarray(jax_fused_attention(jq, jk, jv, jl, 0, 0.0, True)
                        .astype(jnp.float32))
    xla = np.asarray(_jax_xla(jq, jk, jv, jl).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = attention_plain(tq, tk, tv, torch.from_numpy(lengths))
    assert out.dtype == tdt and out.shape == q.shape
    for ref in (pallas, xla):
        if dtype == 'float32':
            assert max_abs(out.float(), ref) < 1e-5
        else:
            err = np.abs(out.float().numpy() - ref)
            assert (err <= np.maximum(1e-3, _bf16_ulp(ref))).all()


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def test_wrapper_uses_plain_version_on_cpu():
    q, k, v, lengths = (torch.from_numpy(a) for a in _inputs(128))
    n = fused_attention.launches
    assert torch.equal(fused_attention(q, k, v, lengths),
                       attention_plain(q, k, v, lengths))
    assert fused_attention.launches == n


def test_dropout_not_ported():
    """Dropout is ported: on the CPU the wrapper runs the plain version
    with the same Philox mask, and p = 0 is the plain version of PR 1."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _inputs(128))
    seed = torch.tensor([77], dtype=torch.int64)
    out = fused_attention(q, k, v, lengths, seed, 0.1)
    assert torch.equal(out, attention_plain(q, k, v, lengths, 77, 0.1))
    assert max_abs(out, attention_plain(q, k, v, lengths)) > 1e-2
    assert torch.equal(fused_attention(q, k, v, lengths, seed, 0.0),
                       attention_plain(q, k, v, lengths))
    with pytest.raises(ValueError, match='dropout_p'):
        fused_attention(q, k, v, lengths, seed, 1.0)


def _grads_jax(q, k, v, do, lengths, dtype):
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jl = jnp.asarray(lengths)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_fused_attention(a, b, c, jl, 0, 0.0, True),
        jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


@pytest.mark.parametrize('T', [128, 768])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_bwd_matches_jax(T, dtype):
    """At p = 0: the plain backward and autograd through fused_attention
    against jax.vjp of the Pallas kernel (T = 768 runs two q-blocks in
    JAX, whose dk and dv add across them)."""
    q, k, v, lengths = _inputs(T, seed=T + 1)
    do = np.random.RandomState(T + 2).randn(*q.shape).astype(np.float32)
    ref = _grads_jax(q, k, v, do, lengths, dtype)
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tl = torch.from_numpy(lengths)
    plain = attention_bwd_plain(tq, tk, tv, tdo, tl)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fused_attention(*leaves, tl).backward(tdo)
    for got in (plain, [t.grad for t in leaves]):
        for g, r in zip(got, ref):
            assert g.dtype == tdt and g.shape == r.shape
            if dtype == 'float32':
                assert max_abs(g, r) <= 1e-5 * np.abs(r).max()
            else:
                assert rel_l2(g.float(), r) <= 5e-3


def test_attention_bwd_plain_matches_autograd_with_dropout():
    """p = 0.1, float32: the plain backward (the TPU kernel's formulas with
    the Philox mask regenerated) against autograd of the plain forward."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _inputs(192, seed=5))
    do = torch.from_numpy(np.random.RandomState(6).randn(*q.shape)
                          .astype(np.float32))
    seed = torch.tensor([2 ** 32 - 3], dtype=torch.int64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_plain(*leaves, lengths, seed, 0.1).backward(do)
    for got in (attention_bwd_plain(q, k, v, do, lengths, seed, 0.1),
                fused_attention_bwd(q, k, v, do, lengths, seed, 0.1)):
        for g, t in zip(got, leaves):
            assert max_abs(g, t.grad) <= 1e-5 * float(t.grad.abs().max())
    # the mask matters: without it the gradients differ
    for g, t in zip(attention_bwd_plain(q, k, v, do, lengths), leaves):
        assert max_abs(g, t.grad) > 1e-2 * float(t.grad.abs().max())


def test_dropout_mask_bits():
    """The mask is a pure function of (seed, b, h, i, j): rows computed in
    two halves give the same bits; the words are Philox-4x32-10 (Random123's
    known answer for counter 0 and key 0); the kept share at p = 0.1 lies
    within 4 sigma of 0.9."""
    B, H, T = 2, 2, 300
    full = dropout_bits(1234, B, H, T)
    halves = torch.cat([dropout_bits(1234, B, H, T, rows=range(0, 137)),
                        dropout_bits(1234, B, H, T, rows=range(137, T))], 2)
    assert torch.equal(full, halves)
    assert full.min() >= 0 and full.max() < 2 ** 32
    assert torch.equal(dropout_bits(torch.tensor([1234]), B, H, T), full)
    kat = dropout_bits(0, 1, 1, 4, rows=[0])[0, 0, 0].tolist()
    assert kat == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    thr, scale = dropout_threshold(0.1)
    assert thr == round(0.1 * 2 ** 32)
    assert scale == np.float32(1.0 / (1.0 - thr / 2 ** 32))
    n = full.numel()
    kept = float((full >= thr).double().mean())
    assert abs(kept - 0.9) <= 4 * (0.9 * 0.1 / n) ** 0.5
    assert not torch.equal(dropout_bits(1235, B, H, T), full)

"""The float32 attention kernels' arithmetic (3xTF32 on the tensor cores,
``daft_exprt_torch/ops/csrc/attention_common.cuh``), modelled in torch on
the CPU, against the port's plain versions and the JAX package's XLA
attention.

The model: x_hi = tf32(x), x_lo = tf32(x - x_hi), tf32 being cvt.rna (round
to nearest, ties away from zero, to 10 mantissa bits) done by bit masking;
each 8-wide step of a product is a_hi.b_lo, then a_lo.b_hi, then
a_hi.b_hi added into a float32 accumulator; a sum over keys or query rows
takes each 64-row tile in its own accumulator and adds it to the running
sum; the softmax, dropout and ds are the formulas of
``attention_bwd_plain`` in the kernels' exp2 form. Band: rel-L2 1e-5, the
float32 band of the kernels on the card. One TF32 product per step
(a_hi.b_hi alone) leaves that band, which is why the kernels take three.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_exprt_torch.ops.attention_kernels import (
    _check_inputs, attention_bwd_plain, attention_plain, dropout_bits,
    dropout_threshold,
)

from tests.test_torch_attention import _inputs, _jax_xla
from tests.torch_port_utils import mm_tf32, rel_l2, tf32

BAND = 1e-5
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
TILE = 64                 # rows per staged tile


def _probs(q, k, lengths, terms):
    """s and the kernels' softmax: exp2(s log2(e) - max log2(e)) / sum."""
    T = q.shape[2]
    s = mm_tf32(q, k.transpose(-1, -2), terms)
    valid = torch.arange(T)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(-1e9))
    e = torch.exp2(s * LOG2E - s.amax(-1, keepdim=True) * LOG2E)
    return e, e.sum(-1, keepdim=True)


def _keep(q, seed, p):
    B, H, T, _ = q.shape
    thr, scale = dropout_threshold(p)
    if not thr:
        return None, 1.0
    return dropout_bits(seed, B, H, T) >= thr, scale


def fwd_model(q, k, v, lengths, seed=0, p=0.0, terms=3):
    e, l = _probs(q, k, lengths, terms)
    pr = e * (1.0 / l)
    keep, scale = _keep(q, seed, p)
    if keep is not None:
        pr = torch.where(keep, pr * scale, torch.zeros_like(pr))
    return mm_tf32(pr, v, terms, TILE)


def bwd_model(q, k, v, do, lengths, seed=0, p=0.0, terms=3):
    e, l = _probs(q, k, lengths, terms)
    pr = e * (1.0 / l)
    dpd = mm_tf32(do, v.transpose(-1, -2), terms)
    keep, scale = _keep(q, seed, p)
    if keep is not None:
        zero = torch.zeros_like(pr)
        pd = torch.where(keep, pr * scale, zero)
        dp = torch.where(keep, dpd * scale, zero)
    else:
        pd, dp = pr, dpd
    dot = (dp * e).sum(-1, keepdim=True) / l
    ds = pr * (dp - dot)
    return (mm_tf32(ds, k, terms, TILE),
            mm_tf32(ds.transpose(-1, -2), q, terms, TILE),
            mm_tf32(pd.transpose(-1, -2), do, terms, TILE))


def _case(T, p):
    q, k, v, lengths = _inputs(T, seed=T + int(10 * p), B=2)
    do = np.random.RandomState(T + 3).randn(*q.shape).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, do, lengths)]
    return (q, k, v, do, lengths), t, torch.tensor([2 ** 31 + 7])


CASES = [(T, p) for T in (128, 200) for p in (0.0, 0.1)]


@pytest.mark.parametrize('T,p', CASES)
def test_tf32x3_forward_in_float32_band(T, p):
    """The forward model against attention_plain and, at p = 0, against
    JAX's XLA attention; one TF32 product leaves the band."""
    arrays, (q, k, v, _, lengths), seed = _case(T, p)
    refs = [attention_plain(q, k, v, lengths, seed, p)]
    if not p:
        jq, jk, jv, _, jl = (jnp.asarray(a) for a in arrays)
        refs.append(torch.from_numpy(np.array(_jax_xla(jq, jk, jv, jl))))
    out = fwd_model(q, k, v, lengths, seed, p)
    for ref in refs:
        assert rel_l2(out, ref) <= BAND
    assert rel_l2(fwd_model(q, k, v, lengths, seed, p, terms=1),
                  refs[0]) > BAND


@pytest.mark.parametrize('T,p', CASES)
def test_tf32x3_backward_in_float32_band(T, p):
    """dq, dk, dv of the backward model against attention_bwd_plain and, at
    p = 0, against jax.vjp of JAX's XLA attention; with one TF32 product
    every gradient leaves the band."""
    arrays, (q, k, v, do, lengths), seed = _case(T, p)
    refs = [attention_bwd_plain(q, k, v, do, lengths, seed, p)]
    if not p:
        jq, jk, jv, jdo, jl = (jnp.asarray(a) for a in arrays)
        _, vjp = jax.vjp(lambda a, b, c: _jax_xla(a, b, c, jl), jq, jk, jv)
        refs.append([torch.from_numpy(np.array(g)) for g in vjp(jdo)])
    got = bwd_model(q, k, v, do, lengths, seed, p)
    for ref in refs:
        for g, r in zip(got, ref):
            assert rel_l2(g, r) <= BAND
    one = bwd_model(q, k, v, do, lengths, seed, p, terms=1)
    for g, r in zip(one, refs[0]):
        assert rel_l2(g, r) > BAND


def test_tf32_rounding():
    """tf32() is cvt.rna: nearest with 10 mantissa bits, ties away from
    zero, and x_hi + x_lo recovers x to within 2^-22 of it."""
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      1.0 + 3 * 2 ** -11, math.pi], dtype=torch.float32)
    hi = tf32(x)
    assert hi[:4].tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                               1.0 + 2 ** -9]
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() <= r.abs() * 2 ** -11).all()
    lo = tf32(r - hi)
    assert ((r - hi - lo).abs() <= r.abs() * 2 ** -22).all()


def test_check_inputs_takes_float32_past_2048():
    """No length limit in float32 (the FMA kernels' T <= 2048 is gone):
    the wrapper's checks accept T = 2500 and still refuse D != 64."""
    q = torch.zeros((1, 2, 2500, 64))
    _check_inputs('fused_attention', q, q, q)
    _check_inputs('fused_attention_bwd', q, q, q, q)
    with pytest.raises(ValueError, match='head dim'):
        _check_inputs('fused_attention', *(torch.zeros((1, 2, 16, 32)),) * 3)

"""The port's attention forward (daft_exprt_torch/ops/attention_kernels.py)
against the JAX package: its Pallas kernel in interpret mode and the XLA
branch of MultiHeadSelfAttention, on the same numpy inputs.

Bands: float32 max-abs 1e-5; bf16 max-abs 1e-3 (the attention band of
NUMERICS_r05.json), or one bf16 ulp of the reference value where that is
larger: both sides round an f32 sum to bf16, and the sums run in another
order, so a value near a rounding boundary can land one ulp apart. The CUDA kernel is held to the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
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
    attention_plain, fused_attention,
)

from tests.torch_port_utils import max_abs


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
    q, k, v, lengths = (torch.from_numpy(a) for a in _inputs(128))
    with pytest.raises(NotImplementedError, match='training slice'):
        fused_attention(q, k, v, lengths, dropout_p=0.1)

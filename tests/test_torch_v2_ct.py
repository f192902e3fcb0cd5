"""The float MRF kernels of HiFi-GAN V2's levels (daft_exprt_torch/ops/
mrf_ct.py) against the JAX package's Pallas kernels in interpret mode.

- ``mrf_ct_plain`` (the plain version of ``fused_mrf_ct``) against
  ``fused_mrf_ct`` with per-tap and merged-tap weights, and
  ``mrf_phase_noups_plain`` against ``fused_mrf_phase(in_phase=False)``
  (no upsample prologue) at V2's (C, p) = (32, 4), (16, 8), (8, 8); two
  tiles each, every sample, edges included. The weights are the JAX
  packers' arrays. Bands: float32 max-abs 1e-5 (the float32 vocoder band),
  bfloat16 rel-L2 2e-3 (the bf16 band of tests/test_torch_hifigan.py: a
  sum in another order can flip a bf16 rounding of a conv input).
- The port's ``fused_mrf_ct`` packer against JAX's, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import mrf_ct as mc
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, _t
from tests.torch_port_utils import max_abs, mrf_params, rel_l2, to_torch


def _check(out, ref, dtype):
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    if dtype == torch.float32:
        assert max_abs(out.numpy(), ref) < 1e-5
    else:
        assert rel_l2(out.float().numpy(), ref) <= 2e-3


def _case(C, T, seed, dtype):
    rng = np.random.RandomState(seed)
    params = mrf_params(rng, 0, C, KS, DILS, w_scale=(C * 7) ** -0.5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    x = (rng.randn(2, C, T) * 0.5).astype(np.float32)
    x[1, :, :T // 4] *= 4.0
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    return jp, xj, xt.transpose(1, 2).contiguous()


def _out(y):
    return np.asarray(y.astype(jnp.float32)).transpose(0, 2, 1)


@pytest.mark.parametrize('C,merge,dtype', [
    (64, True, torch.float32),        # V2's L0, bf16 tier's form
    (32, False, torch.float32),
    (16, True, torch.bfloat16),       # V2's L2 when no phase tile divides
])
def test_mrf_ct_plain_matches_jax(C, merge, dtype):
    tile = 256
    jp, xj, xt = _case(C, 2 * tile, C + merge, dtype)
    jw = jvk.pack_mrf_weights(jp, 0, KS, DILS, merge_taps=merge)
    ref = _out(jvk.fused_mrf_ct(xj, jw, KS, DILS, tile=tile, merge_taps=merge,
                                interpret=True))
    mrf = mc.prepare_mrf_ct(_t(jw), KS, DILS, merge_taps=merge)
    _check(mc.mrf_ct_plain(xt, mrf), ref, dtype)


@pytest.mark.parametrize('C,p,dtype', [
    (32, 4, torch.float32),           # V2's L1
    (16, 8, torch.bfloat16),          # V2's L2
    (8, 8, torch.float32),            # V2's L3
])
def test_mrf_phase_noups_plain_matches_jax(C, p, dtype):
    tile = 128
    jp, xj, xt = _case(C, 2 * tile * p, C + p, dtype)
    jw = jvk.pack_mrf_phase_weights(jp, 0, KS, DILS, p)
    ref = _out(jvk.fused_mrf_phase(xj, jw, KS, DILS, p, tile=tile,
                                   interpret=True))
    mrf = mc.prepare_mrf_ct(mc.pack_mrf_weights(
        jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
                dtype), jp), 0, KS, DILS), KS, DILS)
    _check(mc.mrf_phase_noups_plain(xt, mrf), ref, dtype)


def test_ct_packer_matches_jax():
    rng = np.random.RandomState(2)
    params = mrf_params(rng, 0, 16, KS, DILS)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_torch(params)
    packed = {}
    for merge in (False, True):
        tw = mc.pack_mrf_weights(tp, 0, KS, DILS, merge_taps=merge)
        jw = jvk.pack_mrf_weights(jp, 0, KS, DILS, merge_taps=merge)
        assert len(tw) == len(jw) == 12
        for a, b in zip(tw, jw):
            assert tuple(a.shape) == b.shape
            assert np.array_equal(a.numpy(), np.asarray(b))
        packed[merge] = mc.prepare_mrf_ct(tw, KS, DILS, merge_taps=merge)
    # both forms read back the tc layout the kernel's prepare_mrf takes
    for a, b, c in zip(packed[False].packed, packed[True].packed,
                       vk.pack_mrf_tc_weights(tp, 0, KS, DILS)):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_wrappers_run_plain_versions_on_cpu():
    rng = np.random.RandomState(3)
    tp = to_torch(mrf_params(rng, 0, 8, KS, DILS))
    mrf = vk.prepare_mrf(vk.pack_mrf_tc_weights(tp, 0, KS, DILS), KS, DILS)
    assert mrf.blk is None
    x = torch.from_numpy((rng.randn(1, 96, 8) * 0.5).astype(np.float32))
    ref = mc.mrf_ct_plain(x, mrf)
    for fn in (mc.fused_mrf_ct, mc.fused_mrf_phase_noups):
        n, calls = fn.launches, sum(fn.calls.values())
        assert torch.equal(fn(x, mrf), ref)
        assert fn.launches == n and sum(fn.calls.values()) == calls

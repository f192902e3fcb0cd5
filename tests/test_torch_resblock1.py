"""``fused_resblock1`` (daft_exprt_torch/ops/vocoder_kernels.py: one
ResBlock1 chain, one k and its dilations) against the JAX package's Pallas
kernel in interpret mode, and its CUDA route's launch plan (``mrf_tc.cu``'s
chain kernels, a group of one chain) replayed on the CPU.

The TPU kernel pads x once by its 64-aligned halo and runs valid convs on
each tile, so the result is a fixed function of the zero-padded input:
float32 agrees at every sample, utterance edges included, to 1e-5; bf16
(activations rounded where the TPU kernel rounds them) to rel-L2 1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_bf16_engine import _nan_alloc, _replay_tc
from tests.test_torch_f32_engine import _replay_f32
from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2

DILS = (1, 3, 5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    with one_torch_thread():
        yield


def _block(rng, C, k, n_dil=3):
    return {f'{pre}_{i}': {
        'w': (rng.randn(C, C, k) * (C * k) ** -0.5).astype(np.float32),
        'b': (rng.randn(C) * 0.05).astype(np.float32)}
        for pre in ('convs1', 'convs2') for i in range(n_dil)}


def _torch_block(rb, dtype=torch.float32):
    return {n: {a: torch.from_numpy(t).to(dtype) for a, t in c.items()}
            for n, c in rb.items()}


def test_pack_resblock_weights_matches_jax():
    rng = np.random.RandomState(0)
    rb = _block(rng, 32, 7)
    want = jvk.pack_resblock_weights(
        jax.tree_util.tree_map(jnp.asarray, rb), 3)
    got = vk.pack_resblock_weights(_torch_block(rb), 3)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('k', [3, 11])
def test_resblock1_plain_matches_jax(k, dtype):
    """C = 128, two utterances of two tiles of 128 samples."""
    rng = np.random.RandomState(k)
    C, T, tile = 128, 256, 128
    rb = _block(rng, C, k)
    x = (rng.randn(2, T, C) * 0.5).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jw = [a.astype(jdt) for a in jvk.pack_resblock_weights(
        jax.tree_util.tree_map(jnp.asarray, rb), len(DILS))]
    ref = np.asarray(jvk.fused_resblock1(
        jnp.asarray(x, jdt), *jw, kernel_size=k, dilations=DILS, tile=tile,
        interpret=True).astype(jnp.float32))
    w = vk.pack_resblock_weights(_torch_block(rb, tdt), len(DILS))
    out = vk.resblock1_plain(torch.from_numpy(x).to(tdt), *w, k, DILS, tile)
    assert out.dtype == tdt and out.shape == ref.shape
    if dtype == 'float32':
        assert max_abs(out.numpy(), ref) < 1e-5        # every sample
    else:
        assert rel_l2(out.float().numpy(), ref) <= 1e-2
    # not the input: the chain's branches carry the checked values
    assert max_abs(out.float().numpy(), x) > 0.05


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_resblock1_launch_plan_replays_plain(dtype):
    """The CUDA route's plan for one chain (a group of one chain: a single
    FINAL launch of ``tc_f32_kernel`` or ``tc_bf_kernel``, scale 1, no
    chain buffers) replayed block by block on NaN buffers; float32 in the
    kernel's 3xTF32 arithmetic."""
    rng = np.random.RandomState(3)
    C, k = 128, 7
    w = vk.pack_resblock_weights(_torch_block(_block(rng, C, k), dtype), 3)
    x = torch.from_numpy((rng.randn(2, 448, C) * 0.5).astype(np.float32)
                         ).to(dtype)
    plan = vk._tc_f32_plan if dtype == torch.float32 else vk._tc_bf_plan
    launches, out, _ = plan(x, [None], (k,), (DILS,), _nan_alloc, 132)
    assert len(launches) == 1 and launches[0].scale == 1.0
    assert launches[0].mode == vk.FINAL and launches[0].n_blocks > 1
    if dtype == torch.float32:
        out, writes = _replay_f32(launches, x, w)
    else:
        out, writes = _replay_tc(launches, x, w, dtype)
    assert bool((writes[0] == 1).all())
    ref = vk.resblock1_plain(x, *w, k, DILS, 64)
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert max_abs(out, ref) < 1e-5
    else:
        assert rel_l2(out.float(), ref.float()) < 1e-3


def test_resblock1_wrapper_runs_plain_version_on_cpu():
    rng = np.random.RandomState(4)
    w = vk.pack_resblock_weights(_torch_block(_block(rng, 16, 3)), 3)
    x = torch.from_numpy(rng.randn(1, 128, 16).astype(np.float32))
    n, calls = vk.fused_resblock1.launches, sum(
        vk.fused_resblock1.calls.values())
    assert torch.equal(vk.fused_resblock1(x, *w, 3, DILS, tile=64),
                       vk.resblock1_plain(x, *w, 3, DILS, 64))
    assert vk.fused_resblock1.launches == n
    assert sum(vk.fused_resblock1.calls.values()) == calls
    with pytest.raises(ValueError, match='multiple of tile'):
        vk.fused_resblock1(x, *w, 3, DILS, tile=96)

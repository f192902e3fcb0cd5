"""A chain level whose upsample cannot fuse, in the port
(daft_exprt_torch/models/hifigan.py, ops/mrf_int8.py) against the JAX
package.

The JAX generator runs such a level (want_p = u * p_in, but p*C !=
p_in*C_in, so the upsample cannot be the phase kernel's prologue) as lrelu,
``conv_transpose1d_phase`` and the phase kernel without prologue. No
published config reaches it; this synthetic ResBlock1 config does: HiFi-GAN
V2's widths (128 initial channels) with upsample rates (8, 4, 2, 2) and
kernels (16, 8, 4, 4). L0 (C = 64) takes ``fused_mrf_ct``; L1 (C = 32,
p = 4 = u * 1, p*C = 128 != p_in*C_in = 64) is the level; L2 (C = 16, p = 8
= 2 * 4, 8 * 16 == 4 * 32) is a fused chain again.

- ``conv_transpose1d_phase`` against JAX's on the same numpy inputs (float32
  rel-L2 <= 1e-6, summation order only; bf16 <= 1e-2, a bf16 rounding of
  each partial sum) and against torch's ConvTranspose1d on the interleaved
  signal.
- ``level_routes`` against the JAX generator's recorded kernel calls
  (tests/test_torch_v2_routing.py's stubs) in every tier, at 8 frames (the
  fewest at which a phase tile of 64 columns divides L1), 128 and 12 (no
  tile: the ct fallback).
- One generator forward at B=1 x 8 frames in float32 against JAX's
  ``use_pallas=True`` (interpret mode), level by level and end to end:
  rel-L2 <= 1e-5, the band of tests/test_torch_v2_generator.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th
from daft_exprt_torch.ops.mrf_int8 import conv_transpose1d_phase

from tests.test_torch_v2_routing import _jax_routes, _port_routes
from tests.torch_port_utils import rel_l2, to_numpy

CFG = dict(th.DEFAULT_CONFIG, upsample_initial_channel=128,
           upsample_rates=[8, 4, 2, 2], upsample_kernel_sizes=[16, 8, 4, 4])
FRAMES = 8      # L1's phase columns: 8 frames x 8 = 64, one tile


def _from_phase(x_p, p):
    """(B, p*C, Q) phase layout -> (B, C, Q*p)."""
    B, PC, Q = x_p.shape
    return x_p.reshape(B, p, PC // p, Q).transpose(0, 2, 3, 1).reshape(
        B, PC // p, Q * p)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('u,k,p_in,C_in,C_out', [
    (4, 8, 1, 64, 32),      # the synthetic config's L1
    (2, 4, 2, 32, 32),      # p_in > 1, p*C != p_in*C_in
    (3, 7, 2, 16, 8),       # odd stride, k - 2 * pad != u
])
def test_conv_transpose1d_phase_matches_jax(dtype, u, k, p_in, C_in, C_out):
    rng = np.random.RandomState(u * 100 + k)
    U = 24
    x_p = rng.randn(2, p_in * C_in, U).astype(np.float32)
    w = (rng.randn(C_in, C_out, k) * (C_in * k) ** -0.5).astype(np.float32)
    b = (rng.randn(C_out) * 0.1).astype(np.float32)
    pad = (k - u) // 2
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    want = np.asarray(jvk.conv_transpose1d_phase(
        jnp.asarray(x_p).astype(jdt), jnp.asarray(w), jnp.asarray(b), u, pad,
        p_in).astype(jnp.float32))
    got = conv_transpose1d_phase(torch.from_numpy(x_p).to(tdt),
                                 torch.from_numpy(w), torch.from_numpy(b), u,
                                 pad, p_in)
    assert got.dtype == tdt and got.shape == want.shape == (
        2, u * p_in * C_out, U)
    band = 1e-2 if dtype == 'bfloat16' else 1e-6
    assert rel_l2(got.float().numpy(), want) <= band
    if dtype == 'float32':
        # the same samples as torch's ConvTranspose1d on the interleaved
        # signal, cut to u times its length (the phase layout's columns)
        x = torch.from_numpy(_from_phase(x_p, p_in))
        ref = F.conv_transpose1d(x, torch.from_numpy(w), torch.from_numpy(b),
                                 stride=u, padding=pad)[..., :U * u * p_in]
        sample = torch.from_numpy(_from_phase(got.numpy(), u * p_in))
        n = min(ref.shape[-1], sample.shape[-1])
        assert rel_l2(sample[..., :n].numpy(), ref[..., :n].numpy()) <= 1e-6


def test_level_routes_match_jax(monkeypatch):
    """L1 routes to the phase kernel without prologue after the phase
    upsample, where a tile divides it, in each tier; JAX records the same
    kernel calls."""
    for B, frames in ((1, FRAMES), (8, 128), (1, 12)):
        for tier in ('bf16', 'dynamic', 'static'):
            want, scales = _jax_routes(monkeypatch, CFG, B, frames, tier)
            got = _port_routes(CFG, B, frames, tier, scales)
            assert got == want, (B, frames, tier)
    params = th.init_generator_params(0, CFG, device='cpu')
    routes = th.level_routes(params, CFG, 1, FRAMES)
    assert [(r.kind, r.ups_p_in) for r in routes] == [
        ('ct', 0), ('phase', 1), ('chain', 0), ('phase', 0)]
    assert routes[1].p == 4 and routes[1].tile == 64
    # one frame fewer in each phase column: no tile, the ct fallback
    assert th.level_routes(params, CFG, 1, FRAMES - 4)[1].kind == 'ct'


def test_generator_matches_jax_float32():
    jp = jh.init_generator_params(jax.random.PRNGKey(3), CFG, std=0.06)
    tp = generator_from_jax(to_numpy(jp))
    mel = (np.log(np.random.RandomState(3).rand(1, 80, FRAMES) + 1e-5) * 0.3
           ).astype(np.float32)
    j_taps = {}

    def jax_tap(i, x, cur_p, cur_tc):
        assert not cur_tc
        j_taps[i] = _from_phase(np.asarray(x), cur_p)
    want = np.asarray(jh.generator_forward(
        jp, jnp.asarray(mel), CFG, use_pallas=True, interpret=True,
        _tap=jax_tap))
    t_taps = {}
    with torch.no_grad():
        got = th.generator_forward(
            tp, torch.from_numpy(mel), CFG, use_fast=True,
            _tap=lambda i, x: t_taps.__setitem__(i, x.numpy())).numpy()
    assert sorted(t_taps) == sorted(j_taps) == [0, 1, 2, 3]
    for i in j_taps:
        assert t_taps[i].shape == j_taps[i].shape, i
        assert rel_l2(t_taps[i], j_taps[i]) <= 1e-5, i
    assert got.shape == want.shape == (1, 1, FRAMES * 128)
    assert np.abs(want).max() > 1e-3
    assert rel_l2(got, want) <= 1e-5

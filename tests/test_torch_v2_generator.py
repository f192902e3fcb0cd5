"""The port's HiFi-GAN V2 generator (daft_exprt_torch/models/hifigan.py,
V1 at 128 initial channels: levels of C = 64/32/16/8) against JAX
``generator_forward(use_pallas=True, interpret=True)``.

- The routing fault the port had: its fast route sent every level with
  k - 2p = u through the fused-upsample chain, which at V2's widths is
  another function (5.3e-2 rel-L2 from JAX). In float32 with std-0.06
  weights the port now follows JAX at every level and every sample of the
  waveform, rel-L2 <= 1e-5 (the float32 vocoder band).
- The bf16 tier at B=1 x 16 frames (``compare_tier``, which the int8 and
  12-frame files share): L0 ``fused_mrf_ct`` (merged taps), L1-L3
  ``fused_mrf_phase`` without prologue. Every level of the port (its own
  packed weights) on JAX's upsample of JAX's level input, rel-L2 <= 2e-3,
  and the port's upsample on the same input at the same band. End to end
  rel-L2 <= 2e-2 in bf16 (the band of the port's bf16 tier against its
  float32 route in tests/test_torch_hifigan.py: the unit-gain weights,
  which keep every level's branches in the output, carry each level's
  bf16 rounding differences into the next) and <= 5e-2 in the int8 tiers
  (the JAX package's band between two forms of the int8 generator: one
  flip upstream of a tile's scale requantises the tile).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8_generator import (
    _jax_scales_to_torch, _mels, unit_generator,
)
from tests.torch_port_utils import rel_l2, to_numpy

# HiFi-GAN V2 (jik876/hifi-gan config_v2.json): V1 at 128 initial channels
V2 = dict(th.DEFAULT_CONFIG, upsample_initial_channel=128)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


def _tensor(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def compare_tier(tier, frames, seed, kinds):
    """``tier`` ('bf16', 'dynamic' or 'static') of the V2 generator at B=1
    x ``frames`` against JAX, level by level and end to end; ``kinds``:
    the (kind, mode) each level must route to."""
    params = unit_generator(seed, V2)
    mel = _mels(seed, 1, frames)
    int8 = tier != 'bf16'
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    scales = jh.calibrate_act_scales(jp, jnp.asarray(mel), V2) \
        if tier == 'static' else None
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    taps = {}

    def jax_tap(i, x, cur_p, cur_tc):
        assert (cur_p, cur_tc) == (1, False)
        taps[i] = x
    want = jh.generator_forward(
        jp, jnp.asarray(mel, jnp.bfloat16), V2, use_pallas=True, int8=int8,
        int8_act_scales=scales, interpret=True, _tap=jax_tap)
    want = np.asarray(want.astype(jnp.float32))
    tp = _bf16(generator_from_jax(params))
    t_scales = _jax_scales_to_torch(scales) if scales is not None else None
    routes = th.level_routes(tp, V2, 1, frames, int8, t_scales)
    assert [(r.kind, r.mode) for r in routes] == kinds
    packed = th.pack_levels(tp, V2, t_scales, int8=int8)
    x_prev = jh._conv1d(jnp.asarray(mel, jnp.bfloat16), jp['conv_pre']['w'],
                        jp['conv_pre']['b'])
    with torch.no_grad():
        for i, (u, k) in enumerate(zip(V2['upsample_rates'],
                                       V2['upsample_kernel_sizes'])):
            xu = jh._conv_transpose1d(jh._lrelu(x_prev), jp[f'ups_{i}']['w'],
                                      jp[f'ups_{i}']['b'], stride=u,
                                      padding=(k - u) // 2)
            x = _tensor(xu).transpose(1, 2).contiguous()
            mine = th._upsample_tc(_tensor(x_prev), tp[f'ups_{i}'], u, k,
                                   False)
            assert rel_l2(mine.float().numpy(), x.float().numpy()) <= 2e-3
            # weights packed for 128 frames serve this length's route
            assert th._serves(packed[i], routes[i], False)
            y = th._mrf_level(x, packed[i], routes[i], False)
            ref = np.asarray(taps[i].astype(jnp.float32)).transpose(0, 2, 1)
            assert y.dtype == torch.bfloat16 and tuple(y.shape) == ref.shape
            assert rel_l2(y.float().numpy(), ref) <= 2e-3, i
            x_prev = taps[i]
        levels = []
        got = th.generator_forward(
            tp, torch.from_numpy(mel).bfloat16(), V2, use_fast=True,
            int8=int8, int8_act_scales=t_scales, packed=packed,
            _tap=lambda i, x: levels.append((i, tuple(x.shape))))
    assert levels == [(i, (1, 128 >> (i + 1), frames * n)) for i, n in
                      enumerate((8, 64, 128, 256))]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() > 0.05
    assert rel_l2(got.float().numpy(), want) <= (5e-2 if int8 else 2e-2)


def test_v2_bf16_tier_matches_jax():
    compare_tier('bf16', 16, 5, [('ct', ''), ('phase', ''), ('phase', ''),
                                 ('phase', '')])


def test_v2_fast_route_matches_jax_float32():
    """B=1 x 16 frames: L0 ct (merged taps), L1-L3 the phase kernel
    without prologue (p = 4, 8, 8); conv_post in the generator's tail.
    The former route (L0 through the fused-upsample chain) is held to
    differ."""
    jp = jh.init_generator_params(jax.random.PRNGKey(0), V2, std=0.06)
    tp = generator_from_jax(to_numpy(jp))
    mel = (np.log(np.random.RandomState(0).rand(1, 80, 16) + 1e-5) * 0.3
           ).astype(np.float32)
    j_taps = {}

    def jax_tap(i, x, cur_p, cur_tc):
        assert (cur_p, cur_tc) == (1, False)
        j_taps[i] = np.asarray(x)
    want = np.asarray(jh.generator_forward(
        jp, jnp.asarray(mel), V2, use_pallas=True, interpret=True,
        _tap=jax_tap))
    t_taps = {}
    with torch.no_grad():
        got = th.generator_forward(
            tp, torch.from_numpy(mel), V2, use_fast=True,
            _tap=lambda i, x: t_taps.__setitem__(i, x.numpy())).numpy()
    assert [r.kind for r in th.level_routes(tp, V2, 1, 16)] == \
        ['ct', 'phase', 'phase', 'phase']
    assert sorted(t_taps) == sorted(j_taps) == [0, 1, 2, 3]
    for i in j_taps:
        assert t_taps[i].shape == j_taps[i].shape
        assert rel_l2(t_taps[i], j_taps[i]) <= 1e-5, i
    assert got.shape == want.shape == (1, 1, 16 * 256)
    assert np.abs(want).max() > 1e-3
    assert rel_l2(got, want) <= 1e-5
    x0 = th._conv1d(torch.from_numpy(mel), tp['conv_pre']['w'],
                    tp['conv_pre']['b'])
    ks = V2['resblock_kernel_sizes']
    dils = V2['resblock_dilation_sizes']
    chain = vk.mrf_phase_plain(x0, vk.pack_mrf_tc_weights(tp, 0, ks, dils),
                               ks, dils,
                               (tp['ups_0']['w'], tp['ups_0']['b'], 8, 4))
    assert rel_l2(chain.numpy(), j_taps[0]) > 1e-3

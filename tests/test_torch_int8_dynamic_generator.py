"""The port's int8 HiFi-GAN routes below the phase-tc batch and its
int8-dynamic tier (daft_exprt_torch/models/hifigan.py) against JAX
``generator_forward(use_pallas=True, int8=True, interpret=True)`` at V1's
channel widths and upsample geometry with fewer kernel sizes and
dilations (tests/test_torch_int8_generator.py's config), in bf16 as the
tiers serve:

- the int8-dynamic tier (no act scales) at B=1 and B=2: ``fused_mrf_ct``
  q8 at L0 and L1, the int8 ``fused_mrf_phase`` (dynamic) at L2 and L3
  with conv_post;
- the int8-static tier at B=1 (below ``PTC_MIN_BATCH``): ``fused_mrf_tc``
  q8 at L0 and L1, the int8 ``fused_mrf_phase`` (q8f) at L2 and L3.

Every level of the port (its own packed weights and glue) on the input
JAX gave that level, rel-L2 <= 2e-3 (NUMERICS_r05.json
``ptc_vs_banded_int8``): a wide level of the dynamic tier takes JAX's own
upsample output, since one bf16 ulp of the upsample can move a tile's
scale. End to end, rel-L2 <= 5e-2, the JAX package's own band between two
forms of the int8 generator (tests/test_vocoder_kernels.py
``test_generator_ptc_int8_serving``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th
from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8_generator import (
    CFG, _jax_scales_to_torch, _mels, unit_generator,
)
from tests.torch_port_utils import rel_l2


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


def _tensor(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize('tier,B', [('dynamic', 1), ('dynamic', 2),
                                    ('static', 1)])
def test_int8_generator_below_ptc_batch_matches_jax(tier, B):
    """T=24 frames: L0 runs one ct tile of 192 samples, L1 one of 1536;
    L2 and L3 three phase tiles of 512 columns, each quantising its
    upsample input with its own scale; conv_post fuses at L3."""
    params = unit_generator(3)
    mel = _mels(4 + B, B, 24)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    scales = jh.calibrate_act_scales(jp, jnp.asarray(mel), CFG) \
        if tier == 'static' else None
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    taps, raw = {}, {}

    def jax_tap(i, x, cur_p, cur_tc):
        raw[i] = x
        assert cur_p == (1, 1, 2, 4)[i]
        assert cur_tc == (tier == 'static' and i < 2)
        if cur_tc:
            taps[i] = x                                   # (B, T, C)
        elif i == 3:
            Bx, p, Q = x.shape
            taps[i] = x.reshape(Bx, p, Q).transpose(0, 2, 1).reshape(Bx, 1, -1)
        else:                                   # phase -> sample-major
            Bx, pc, Q = x.shape
            taps[i] = x.reshape(Bx, cur_p, pc // cur_p, Q).transpose(
                0, 3, 1, 2).reshape(Bx, Q * cur_p, pc // cur_p)

    want = jh.generator_forward(
        jp, jnp.asarray(mel, jnp.bfloat16), CFG, use_pallas=True, int8=True,
        int8_act_scales=scales, interpret=True, _tap=jax_tap)
    want = np.asarray(want.astype(jnp.float32))
    assert sorted(taps) == [0, 1, 2, 3]
    tp = _bf16(generator_from_jax(params))
    t_scales = _jax_scales_to_torch(scales) if scales is not None else None
    packed = th.pack_levels(tp, CFG, t_scales, int8=True)
    assert isinstance(packed[2], th.NarrowLevel)
    assert packed[2].phase.dynamic == (tier == 'dynamic')
    assert packed[0].dynamic == (tier == 'dynamic')

    x_prev = jh._conv1d(jnp.asarray(mel, jnp.bfloat16), jp['conv_pre']['w'],
                        jp['conv_pre']['b'])
    with torch.no_grad():
        for i in range(4):
            if i < 2 and tier == 'dynamic':
                # JAX's own upsample output (B, C, T), as the level had it
                xu = jh._conv_transpose1d(
                    jh._lrelu(x_prev), jp[f'ups_{i}']['w'],
                    jp[f'ups_{i}']['b'], stride=8, padding=4)
                x = _tensor(xu).transpose(1, 2).contiguous()
                y = mi.fused_mrf_ct_q8(x, packed[i],
                                       mi.ct_tile(x.shape[1], x.shape[2]))
                ref = np.asarray(taps[i].astype(jnp.float32))
                x_prev = raw[i]
            elif i < 2:
                x_in = _tensor(x_prev)
                x = th._conv_transpose1d_poly(
                    th._lrelu(x_in), tp[f'ups_{i}']['w'], tp[f'ups_{i}']['b'],
                    8, 4, in_tc=i == 1)
                y = vk.fused_mrf_tc_q8(x, packed[i])
                ref = np.asarray(taps[i].astype(jnp.float32))
                x_prev = taps[i]
            else:
                x_in = _tensor(taps[i - 1])
                y, post_done = th._narrow_int8_level(
                    x_in, packed[i], th.level_routes(
                        tp, CFG, B, 24, int8=True, act_scales=t_scales)[i],
                    False)
                assert post_done == (i == 3)
                ref = np.asarray(taps[i].astype(jnp.float32))
            assert y.dtype == torch.bfloat16 and tuple(y.shape) == ref.shape
            assert rel_l2(y.float().numpy(), ref) <= 2e-3, i
        levels = []
        got = th.generator_forward(
            tp, torch.from_numpy(mel).bfloat16(), CFG, use_fast=True,
            int8=True, int8_act_scales=t_scales,
            _tap=lambda i, x: levels.append((i, tuple(x.shape))))
    assert levels == [(0, (B, 256, 192)), (1, (B, 128, 1536)),
                      (2, (B, 64, 3072)), (3, (B, 1, 6144))]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() > 0.05
    assert rel_l2(got.float().numpy(), want) <= 5e-2

"""The port's HiFi-GAN generator under the JAX package's routing switches
(daft_exprt_torch/models/hifigan.py keywords ``int8_fused`` and
``ptc_bf16``, and partial ``int8_act_scales`` dicts) against JAX
``generator_forward(use_pallas=True, interpret=True)`` with the same
switches set in the environment, at V1's channel widths and upsample
geometry with fewer kernel sizes and dilations
(tests/test_torch_int8_generator.py's config), B=1 and 16 frames, bf16:

- ``int8_fused=False`` (``DAFT_INT8_FUSED_EPI=0``), the static tier below
  the phase-tc batch: ``fused_mrf_tc`` q8 at L0/L1, the q8s int8
  ``fused_mrf_phase`` at L2/L3 (conv_post fused at L3);
- ``ptc_bf16=True`` (``DAFT_MRF_PTC_BF16=1``), the bf16 tier with the
  phase-tc batch threshold at 1 on both sides: ``fused_mrf_tc`` at L0/L1,
  ``fused_mrf_ptc`` fdot at L2/L3;
- calibration entries for L0 and L1 only (and for L0-L2), threshold 1:
  ``fused_mrf_tc`` q8 at L0/L1, ``fused_mrf_ptc`` dyn at L2/L3 (static at
  L2 with its entry).

Every level of the port (its own packed weights and glue) on the input JAX
gave that level: rel-L2 <= 2e-3 at the int8 levels (NUMERICS_r05.json
``ptc_vs_banded_int8``), <= 1e-2 at the bf16 tc levels and <= 3e-2 at the
fdot ones (``ptc_bf16_vs_banded_bf16``). End to end rel-L2 <= 5e-2, the
JAX package's band between two forms of a generator: one ulp can move a
dynamic scale and requantise a tile.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8_generator import (
    CFG, _jax_scales_to_torch, _mels, unit_generator,
)
from tests.torch_port_utils import rel_l2

FRAMES = 16
CASES = {        # name: (JAX environment, port keywords, scale levels)
    'q8s': ({'DAFT_INT8_FUSED_EPI': '0'}, dict(int8_fused=False),
            (0, 1, 2, 3)),
    'fdot': ({'DAFT_MRF_PTC_BF16': '1', 'DAFT_PTC_MIN_BATCH': '1'},
             dict(ptc_bf16=True, ptc_min_batch=1), None),
    'dyn': ({'DAFT_PTC_MIN_BATCH': '1'}, dict(ptc_min_batch=1), (0, 1)),
    'static-dyn': ({'DAFT_PTC_MIN_BATCH': '1'}, dict(ptc_min_batch=1),
                   (0, 1, 2)),
}
ROUTES = {'q8s': [('tc', 'q8f'), ('tc', 'q8f'), ('chain', 'q8s'),
                  ('chain', 'q8s')],
          'fdot': [('tc', ''), ('tc', ''), ('ptc', ''), ('ptc', '')],
          'dyn': [('tc', 'q8f'), ('tc', 'q8f'), ('ptc', 'q8'), ('ptc', 'q8')],
          'static-dyn': [('tc', 'q8f'), ('tc', 'q8f'), ('ptc', 'q8f'),
                         ('ptc', 'q8')]}


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


def _tensor(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize('case', sorted(CASES))
def test_generator_under_switch_matches_jax(case, monkeypatch):
    env, kw, levels = CASES[case]
    params = unit_generator(5)
    mel = _mels(6, 1, FRAMES)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    scales = None
    if levels is not None:
        full = jh.calibrate_act_scales(jp, jnp.asarray(mel), CFG)
        scales = {i: full[i] for i in levels}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    taps = {}

    def jax_tap(i, x, cur_p, cur_tc):
        if cur_tc and i == 3 and x.shape[2] == cur_p:    # ptc + conv_post
            taps[i] = x.reshape(x.shape[0], 1, -1)
        elif cur_tc:                                     # (B, Q, p*C) rows
            B, Q, lanes = x.shape
            taps[i] = x.reshape(B, Q * cur_p, lanes // cur_p)
        elif i == 3:                                     # phase + conv_post
            taps[i] = x.reshape(x.shape[0], cur_p, -1).transpose(
                0, 2, 1).reshape(x.shape[0], 1, -1)
        else:                                            # phase layout
            B, pc, Q = x.shape
            taps[i] = x.reshape(B, cur_p, pc // cur_p, Q).transpose(
                0, 3, 1, 2).reshape(B, Q * cur_p, pc // cur_p)

    want = jh.generator_forward(
        jp, jnp.asarray(mel, jnp.bfloat16), CFG, use_pallas=True,
        int8=scales is not None, int8_act_scales=scales, interpret=True,
        _tap=jax_tap)
    want = np.asarray(want.astype(jnp.float32))
    assert sorted(taps) == [0, 1, 2, 3]
    tp = _bf16(generator_from_jax(params))
    t_scales = None if scales is None else _jax_scales_to_torch(scales)
    int8 = scales is not None
    routes = th.level_routes(tp, CFG, 1, FRAMES, int8, t_scales, **kw)
    assert [(r.kind, r.mode) for r in routes] == ROUTES[case]
    pack_kw = {k: v for k, v in kw.items() if k != 'ptc_min_batch'}
    packed = th.pack_levels(tp, CFG, t_scales, int8, **pack_kw)
    x_prev = jh._conv1d(jnp.asarray(mel, jnp.bfloat16), jp['conv_pre']['w'],
                        jp['conv_pre']['b'])
    with torch.no_grad():
        for i, route in enumerate(routes):
            x_in = _tensor(x_prev if i == 0 else taps[i - 1])
            band = 2e-3
            if route.kind == 'tc':
                x = th._conv_transpose1d_poly(
                    th._lrelu(x_in), tp[f'ups_{i}']['w'], tp[f'ups_{i}']['b'],
                    8, 4, in_tc=i == 1)
                y = vk.fused_mrf_tc_q8(x, packed[i]) if route.mode else \
                    vk.fused_mrf_tc(x, packed[i])
                band = 2e-3 if route.mode else 1e-2
            elif route.mode:
                y, post_done = th._narrow_int8_level(x_in, packed[i], route,
                                                     False)
                assert post_done == (i == 3)
            else:
                y = vk.fused_mrf_ptc_f(x_in.transpose(1, 2), packed[i].ptc,
                                       route.tile)
                y = y if i == 3 else y.transpose(1, 2)
                band = 3e-2
            ref = np.asarray(taps[i].astype(jnp.float32))
            assert y.dtype == torch.bfloat16 and tuple(y.shape) == ref.shape
            assert rel_l2(y.float().numpy(), ref) <= band, (i, route)
        got = th.generator_forward(
            tp, torch.from_numpy(mel).bfloat16(), CFG, use_fast=True,
            int8=int8, int8_act_scales=t_scales, packed=packed, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() > 0.05
    assert rel_l2(got.float().numpy(), want) <= 5e-2

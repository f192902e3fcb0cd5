"""The port's int8-static HiFi-GAN tier (daft_exprt_torch/models/hifigan.py)
against the JAX package: ``calibrate_act_scales`` (rel <= 1e-5, float32
reference forwards) and the whole int8 generator against
``generator_forward(use_pallas=True, int8=True, int8_act_scales=...,
interpret=True)`` at V1's channel widths and upsample geometry with fewer
kernel sizes and dilations, in bf16 (as the tier serves) and float32,
at B=1 with the phase-tc batch threshold set to 1 on both sides (JAX's
``DAFT_PTC_MIN_BATCH``, the port's ``ptc_min_batch``); at the default
threshold the port's B=1 route (the int8 phase kernel) is held to the same
output at the cross-form band. Band rel-L2 <= 2e-3
(NUMERICS_r05.json ``ptc_vs_banded_int8``) for every level on the input
JAX gave it; see the test for the end-to-end band. Unit-gain weights
(std 1/sqrt(fan-in)) keep every level's branches in the output.
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

from tests.torch_port_utils import rel_l2

CFG = dict(th.DEFAULT_CONFIG, resblock_kernel_sizes=[3, 7],
           resblock_dilation_sizes=[[1, 3], [1, 3]])


def unit_generator(seed, cfg=CFG):
    """Generator params with unit-gain convs (numpy, JAX layout)."""
    rng = np.random.RandomState(seed)

    def conv(c_out, c_in, k, fan):
        return {'w': (rng.randn(c_out, c_in, k) * fan ** -0.5
                      ).astype(np.float32),
                'b': (rng.randn(c_out) * 0.05).astype(np.float32)}

    c0 = cfg['upsample_initial_channel']
    p = {'conv_pre': conv(c0, cfg['model_in_dim'], 7, cfg['model_in_dim'] * 7)}
    ch = c0
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        out = c0 // 2 ** (i + 1)
        w = conv(ch, out, k, ch * k / u)
        p[f'ups_{i}'] = {'w': w['w'], 'b': w['b'][:out]}
        for j, (rk, dils) in enumerate(zip(cfg['resblock_kernel_sizes'],
                                           cfg['resblock_dilation_sizes'])):
            p[f'resblock_{i}_{j}'] = {
                f'{pre}_{l}': conv(out, out, rk, out * rk)
                for l in range(len(dils)) for pre in ('convs1', 'convs2')}
        ch = out
    p['conv_post'] = conv(1, ch, 7, ch * 7)
    p['ups_0']['b'] = p['ups_0']['b'][:c0 // 2]
    return p


def _mels(seed, B, T):
    rng = np.random.RandomState(seed)
    return (np.log(rng.rand(B, 80, T) + 1e-5) * 0.3).astype(np.float32)


def _jax_scales_to_torch(scales):
    return {i: [tuple(torch.from_numpy(np.array(s)) for s in e)
                for e in lvl] for i, lvl in scales.items()}


def test_calibrate_act_scales_matches_jax():
    cfg = {'sampling_rate': 22050, 'upsample_rates': [8, 2],
           'upsample_kernel_sizes': [16, 4], 'upsample_initial_channel': 128,
           'resblock': '1', 'resblock_kernel_sizes': [3, 7],
           'resblock_dilation_sizes': [[1, 3], [1, 3, 5]], 'model_in_dim': 80}
    params = unit_generator(1, cfg)
    mels = _mels(2, 2, 40)
    want = jh.calibrate_act_scales(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mels), cfg)
    got = th.calibrate_act_scales(generator_from_jax(params), mels, cfg)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        assert len(got[i]) == len(want[i]) == 2
        for (g1, g2), (w1, w2) in zip(got[i], want[i]):
            for g, w in ((g1, w1), (g2, w2)):
                assert g.dtype == torch.float32 and g.shape == w.shape
                assert rel_l2(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_int8_generator_matches_jax(dtype, monkeypatch):
    """T=24 frames: 1536 rows at L2/L3, so the phase-tc tile is 512 rows
    and each utterance has three tiles, each quantising its upsample input
    with its own scale; conv_post fuses at L3.

    Every level of the port's tier (its own packed weights and glue) on
    the input JAX gave that level: rel-L2 <= 2e-3 (NUMERICS_r05.json
    ``ptc_vs_banded_int8``); the phase-tc levels come out bit-identical,
    the tc levels differ where an ulp of the polyphase upsample flips an
    int8 value. End to end such a flip can also move a tile's dynamic
    upsample scale, which requantises the whole tile, so the waveform is
    held to the JAX package's own band between two forms of the int8
    generator, rel-L2 <= 5e-2 (tests/test_vocoder_kernels.py
    ``test_generator_ptc_int8_serving``)."""
    params = unit_generator(3)
    mel = _mels(4, 1, 24)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    scales = jh.calibrate_act_scales(jp, jnp.asarray(mel), CFG)
    monkeypatch.setenv('DAFT_PTC_MIN_BATCH', '1')
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jp)
    taps = {}

    def jax_tap(i, x, cur_p, cur_tc):
        assert cur_tc and cur_p == (1, 1, 2, 4)[i]
        B, Q, lanes = x.shape
        taps[i] = x.reshape(B, 1, -1) if i == 3 else \
            x.reshape(B, Q * cur_p, lanes // cur_p)   # sample-major

    want = jh.generator_forward(
        jp, jnp.asarray(mel, jdt), CFG, use_pallas=True, int8=True,
        int8_act_scales=scales, interpret=True, _tap=jax_tap)
    want = np.asarray(want.astype(jnp.float32))
    assert sorted(taps) == [0, 1, 2, 3]         # tc, tc, ptc, ptc + post
    tp = {k: {kk: (vv.to(tdt) if torch.is_tensor(vv) else
                   {a: t.to(tdt) for a, t in vv.items()})
              for kk, vv in v.items()}
          for k, v in generator_from_jax(params).items()}
    t_scales = _jax_scales_to_torch(scales)
    packed = th.pack_levels(tp, CFG, t_scales)

    def tensor(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)

    x_in = tensor(jh._conv1d(jnp.asarray(mel, jdt), jp['conv_pre']['w'],
                             jp['conv_pre']['b']))
    with torch.no_grad():
        for i in range(4):
            if i < 2:
                x = th._conv_transpose1d_poly(
                    th._lrelu(x_in), tp[f'ups_{i}']['w'], tp[f'ups_{i}']['b'],
                    8, 4, in_tc=i == 1)
                y = vk.fused_mrf_tc_q8(x, packed[i])
            else:
                y, post_done = th._narrow_int8_level(
                    x_in, packed[i], th.level_routes(
                        tp, CFG, 1, 24, act_scales=t_scales,
                        ptc_min_batch=1)[i], False)
                assert post_done == (i == 3)
            ref = np.asarray(taps[i].astype(jnp.float32))
            assert y.dtype == tdt and tuple(y.shape) == ref.shape
            assert rel_l2(y.float().numpy(), ref) <= 2e-3, i
            x_in = tensor(taps[i])
        levels = []
        got = th.generator_forward(
            tp, torch.from_numpy(mel).to(tdt), CFG, use_fast=True,
            int8_act_scales=t_scales, ptc_min_batch=1,
            _tap=lambda i, x: levels.append((i, tuple(x.shape))))
    assert levels == [(0, (1, 256, 192)), (1, (1, 128, 1536)),
                      (2, (1, 64, 3072)), (3, (1, 1, 6144))]
    assert got.dtype == tdt and got.shape == want.shape
    assert np.abs(want).max() > 0.05
    assert rel_l2(got.float().numpy(), want) <= 5e-2
    # below the batch threshold the narrow levels take the int8 phase
    # kernel (q8f): another form of the same int8 generator, held to the
    # phase-tc output at the JAX package's cross-form band
    n = sum(mi.fused_mrf_ptc.calls.values())
    with torch.no_grad():
        below = th.generator_forward(tp, torch.from_numpy(mel).to(tdt), CFG,
                                     use_fast=True, int8_act_scales=t_scales)
    assert sum(mi.fused_mrf_ptc.calls.values()) == n
    assert below.dtype == tdt and below.shape == got.shape
    assert rel_l2(below.float().numpy(), want) <= 5e-2

"""The port's level routing (daft_exprt_torch/models/hifigan.py
``level_routes``) against the JAX generator's.

- Each level's kernel, mode, phases, tile and merged-taps flag as the JAX
  generator hands them to its Pallas kernels (recorded by stubs while
  ``jax.eval_shape`` traces the generator), for V1 and V2, in the bf16,
  int8-dynamic and int8-static tiers, at B=8 and B=1, at 128 frames and at
  12 (where no phase tile divides V2's L1 and L2, which fall back to
  ``fused_mrf_ct``); and under the JAX package's switches, set with
  ``monkeypatch.setenv`` on the JAX side and passed as the port's
  keywords: ``DAFT_INT8_FUSED_EPI=0`` (``int8_fused=False``: q8s),
  ``DAFT_MRF_PTC_BF16=1`` (``ptc_bf16=True``: fdot), and partial act-scale
  dicts ({0, 1}, {0, 1, 2}: ptc's dyn mode).
- V1's routes are the kernels the port ran before the router followed the
  JAX decision: tc, tc, phase chain, phase chain (bf16); ct q8, ct q8,
  int8 phase chain x2 (dynamic); tc q8, tc q8, then ptc from batch 8 or
  the q8f phase chain below it (static).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.models import hifigan as th

# HiFi-GAN V2 (jik876/hifi-gan config_v2.json): V1 at 128 initial channels
V2 = dict(th.DEFAULT_CONFIG, upsample_initial_channel=128)
CONFIGS = {'V1': th.DEFAULT_CONFIG, 'V2': V2}


def _mode(int8_chain, act_scales, int8_fused=True):
    if not int8_chain:
        return ''
    if act_scales is None:
        return 'q8'
    return 'q8f' if int8_fused else 'q8s'


def _jax_routes(monkeypatch, cfg, B, frames, tier, levels=None):
    """The JAX generator's kernel calls, as (kind, mode, p, tile, merge);
    ``levels``: the levels the static tier's act-scale dict covers (all
    when None)."""
    seen = []

    def tc(x, w, ks, dils, tile=4096, q8=False, **kw):
        seen.append(('tc', 'q8f' if q8 else ''))
        return x

    def ct(x, w, ks, dils, tile=8192, merge_taps=False, int8_chain=False,
           act_scales=None, int8_fused=True, **kw):
        seen.append(('ct', _mode(int8_chain, act_scales, int8_fused), 1,
                     tile, merge_taps))
        return x

    def phase(x, w, ks, dils, p, tile=2048, post_k=0, ups_weights=None,
              int8_chain=False, act_scales=None, int8_fused=True, **kw):
        kind = 'chain' if ups_weights is not None else 'phase'
        seen.append((kind, _mode(int8_chain, act_scales, int8_fused), p, tile,
                     False))
        if post_k:
            return jnp.zeros((x.shape[0], p, x.shape[2]), x.dtype)
        return x

    def ptc(x, w, ks, dils, p, tile=8192, post_k=0, dyn=False, fdot=False,
            **kw):
        seen.append(('ptc', '' if fdot else ('q8' if dyn else 'q8f'), p,
                     tile, False))
        if post_k:
            return jnp.zeros(x.shape[:2] + (p,), x.dtype)
        return x

    for name, fn in (('fused_mrf_tc', tc), ('fused_mrf_ct', ct),
                     ('fused_mrf_phase', phase), ('fused_mrf_ptc', ptc)):
        monkeypatch.setattr(jvk, name, fn)
    params = jax.eval_shape(lambda k: jh.init_generator_params(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.bfloat16), params)
    scales = None
    if tier == 'static':
        scales = {i: [tuple(np.ones((len(d), params[f'ups_{i}']['w'].shape[1]),
                                    np.float32) for _ in range(2))
                      for d in cfg['resblock_dilation_sizes']]
                  for i in range(len(cfg['upsample_rates']))
                  if levels is None or i in levels}
    jax.eval_shape(lambda m: jh.generator_forward(
        params, m, cfg, use_pallas=True, int8=tier != 'bf16',
        int8_act_scales=scales, interpret=True),
        jax.ShapeDtypeStruct((B, 80, frames), jnp.bfloat16))
    return seen, scales


def _port_routes(cfg, B, frames, tier, scales, **switches):
    params = th.init_generator_params(0, cfg, device='cpu')
    routes = th.level_routes(params, cfg, B, frames, tier != 'bf16', scales,
                             **switches)
    return [(r.kind, r.mode) if r.kind == 'tc' else
            (r.kind, r.mode, r.p, r.tile, r.merge) for r in routes]


@pytest.mark.parametrize('name', ['V1', 'V2'])
def test_level_routes_match_jax(monkeypatch, name):
    cfg = CONFIGS[name]
    for B, frames in ((8, 128), (1, 128), (1, 12)):
        for tier in ('bf16', 'dynamic', 'static'):
            want, scales = _jax_routes(monkeypatch, cfg, B, frames, tier)
            got = _port_routes(cfg, B, frames, tier, scales)
            assert got == want, (name, B, frames, tier)


SWITCHES = [      # (JAX environment, the port's keywords, tier, levels)
    ({'DAFT_INT8_FUSED_EPI': '0'}, dict(int8_fused=False), 'static', None),
    ({'DAFT_MRF_PTC_BF16': '1'}, dict(ptc_bf16=True), 'bf16', None),
    ({}, {}, 'static', (0, 1)),
    ({}, {}, 'static', (0, 1, 2)),
]


@pytest.mark.parametrize('name', ['V1', 'V2'])
def test_level_routes_match_jax_under_switches(monkeypatch, name):
    cfg = CONFIGS[name]
    for B, frames in ((8, 128), (1, 12)):
        for env, switches, tier, levels in SWITCHES:
            with monkeypatch.context() as m:
                for key, value in env.items():
                    m.setenv(key, value)
                want, scales = _jax_routes(m, cfg, B, frames, tier, levels)
            got = _port_routes(cfg, B, frames, tier, scales, **switches)
            assert got == want, (name, B, frames, env, levels)


def test_v1_routes_under_switches():
    """V1 at B=8 x 1024 frames: every new kernel mode has a route."""
    params = th.init_generator_params(0, th.DEFAULT_CONFIG, device='cpu')

    def kinds(B, **kw):
        return [(r.kind, r.mode) for r in th.level_routes(
            params, th.DEFAULT_CONFIG, B, 1024, **kw)]
    scales = {i: [(1, 1)] for i in range(4)}
    partial = {i: scales[i] for i in (0, 1)}
    assert kinds(8, act_scales=partial) == [
        ('tc', 'q8f'), ('tc', 'q8f'), ('ptc', 'q8'), ('ptc', 'q8')]
    assert kinds(8, act_scales={**partial, 2: scales[2]}) == [
        ('tc', 'q8f'), ('tc', 'q8f'), ('ptc', 'q8f'), ('ptc', 'q8')]
    assert kinds(1, act_scales=partial) == [
        ('tc', 'q8f'), ('tc', 'q8f'), ('chain', 'q8'), ('chain', 'q8')]
    assert kinds(8, ptc_bf16=True) == [('tc', ''), ('tc', ''), ('ptc', ''),
                                       ('ptc', '')]
    assert kinds(1, act_scales=scales, int8_fused=False) == [
        ('tc', 'q8f'), ('tc', 'q8f'), ('chain', 'q8s'), ('chain', 'q8s')]
    assert kinds(8, act_scales=scales, int8_fused=False) == [
        ('tc', 'q8f'), ('tc', 'q8f'), ('ptc', 'q8f'), ('ptc', 'q8f')]


def test_v1_router_keeps_the_former_kernels():
    params = th.init_generator_params(0, th.DEFAULT_CONFIG, device='cpu')

    def kinds(B, **kw):
        return [(r.kind, r.mode) for r in th.level_routes(
            params, th.DEFAULT_CONFIG, B, 1024, **kw)]
    assert kinds(8) == [('tc', ''), ('tc', ''), ('chain', ''),
                        ('chain', '')]
    assert kinds(8, int8=True) == [('ct', 'q8'), ('ct', 'q8'),
                                   ('chain', 'q8'), ('chain', 'q8')]
    scales = {i: [(1, 1)] for i in range(4)}
    assert kinds(8, act_scales=scales) == [('tc', 'q8f'), ('tc', 'q8f'),
                                           ('ptc', 'q8f'), ('ptc', 'q8f')]
    assert kinds(1, act_scales=scales) == [('tc', 'q8f'), ('tc', 'q8f'),
                                           ('chain', 'q8f'), ('chain', 'q8f')]


def test_packed_weights_of_another_tier_are_refused():
    params = th.init_generator_params(0, V2, device='cpu')
    mel = torch.zeros(1, 80, 16)
    with pytest.raises(ValueError, match='do not serve'):
        th.generator_forward(params, mel, V2, use_fast=True, int8=True,
                             packed=th.pack_levels(params, V2))
    # weights packed for the other position of a switch are refused too
    scales = {i: [tuple(torch.ones(len(d), params[f'ups_{i}']['w'].shape[1])
                        for _ in range(2))
                  for d in V2['resblock_dilation_sizes']] for i in range(4)}
    with pytest.raises(ValueError, match='do not serve'):
        th.generator_forward(params, mel, V2, use_fast=True,
                             int8_act_scales=scales, int8_fused=False,
                             packed=th.pack_levels(params, V2, scales))

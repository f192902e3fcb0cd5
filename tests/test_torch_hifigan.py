"""The port's HiFi-GAN generator (daft_exprt_torch/models/hifigan.py) against
the JAX package, level by level through the ``_tap`` hook, on the small
configs of tests/test_hifigan.py. Params are made once with JAX's init and
carried across by the bridge; mels are seeded numpy.

Bands: the float32 plain route vs JAX ``use_pallas=False`` at 1e-5
(PARITY.md's vocoder band); the fast route's plain versions (float32
params) vs JAX ``use_pallas=True, interpret=True`` at 1e-4, every sample;
``HiFiGanVocoder(fast='bf16')`` vs the JAX fast wrapper at rel-L2 2e-3 and
vs the port's float32 route at rel-L2 2e-2 (relative: the random weights
give a waveform of ~1e-3, below tests/test_hifigan.py's absolute bands).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_tpu.ops.vocoder_kernels import from_phase
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th

from tests.torch_port_utils import max_abs, rel_l2, to_numpy

# tests/test_hifigan.py:151-155 (phase route at both levels, conv_post
# fused at the last) and :279-288 (a wide tc level, then a phase level)
CFG_PHASE = {'sampling_rate': 22050, 'upsample_rates': [2, 2],
             'upsample_kernel_sizes': [4, 4], 'upsample_initial_channel': 128,
             'resblock': '1', 'resblock_kernel_sizes': [3, 7],
             'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5]],
             'model_in_dim': 80}
CFG_TC = {'sampling_rate': 22050, 'upsample_rates': [8, 2],
          'upsample_kernel_sizes': [16, 4], 'upsample_initial_channel': 256,
          'resblock': '1', 'resblock_kernel_sizes': [3, 7],
          'resblock_dilation_sizes': [[1, 3], [1, 3]], 'model_in_dim': 80}
CONFIGS = {'phase': CFG_PHASE, 'tc': CFG_TC}


def _case(cfg, seed, T=128, B=2, std=0.03):
    jp = jh.init_generator_params(jax.random.PRNGKey(seed), cfg, std=std)
    rng = np.random.RandomState(seed)
    mel = np.log(rng.rand(B, 80, T).astype(np.float32) + 1e-5) * 0.3
    return jp, generator_from_jax(to_numpy(jp)), mel


def _jax_levels(jp, mel, cfg, **kw):
    taps = {}

    def tap(i, x, cur_p, cur_tc):
        x = jnp.swapaxes(x, 1, 2) if cur_tc else (
            from_phase(x, cur_p) if cur_p > 1 else x)
        taps[i] = np.asarray(x)

    wav = np.asarray(jh.generator_forward(jp, jnp.asarray(mel), cfg,
                                          _tap=tap, **kw))
    return taps, wav


def _port_levels(tp, mel, cfg, **kw):
    taps = {}

    def tap(i, x):
        taps[i] = x.float().numpy()

    with torch.no_grad():
        wav = th.generator_forward(tp, torch.from_numpy(mel), cfg, _tap=tap,
                                   **kw)
    return taps, wav.float().numpy()


@pytest.mark.parametrize('name', ['phase', 'tc'])
def test_plain_route_matches_jax_xla_per_level(name):
    cfg = CONFIGS[name]
    jp, tp, mel = _case(cfg, seed=1)
    j_taps, j_wav = _jax_levels(jp, mel, cfg, use_pallas=False)
    t_taps, t_wav = _port_levels(tp, mel, cfg, use_fast=False)
    assert sorted(t_taps) == sorted(j_taps) == [0, 1]
    for i in j_taps:
        assert t_taps[i].shape == j_taps[i].shape
        assert max_abs(t_taps[i], j_taps[i]) < 1e-5, i
    assert t_wav.shape == j_wav.shape
    assert max_abs(t_wav, j_wav) < 1e-5


@pytest.mark.parametrize('name', ['phase', 'tc'])
def test_fast_route_matches_jax_pallas_per_level(name):
    """float32 params: the fused-kernel routes' plain versions against the
    Pallas kernels, every sample (edges included)."""
    cfg = CONFIGS[name]
    jp, tp, mel = _case(cfg, seed=2)
    j_taps, j_wav = _jax_levels(jp, mel, cfg, use_pallas=True,
                                interpret=True)
    t_taps, t_wav = _port_levels(tp, mel, cfg, use_fast=True)
    assert sorted(t_taps) == sorted(j_taps) == [0, 1]
    for i in j_taps:
        assert t_taps[i].shape == j_taps[i].shape
        assert max_abs(t_taps[i], j_taps[i]) < 1e-4, i
    assert t_wav.shape == j_wav.shape
    assert max_abs(t_wav, j_wav) < 1e-4


def test_bf16_vocoder_matches_jax_fast_wrapper():
    """tests/test_hifigan.py:203-230's config and mels. The init's std 0.01
    gives a waveform of max |x| ~6e-4, so the bands are relative: against
    the JAX fast wrapper (the same bf16 function, padding included) rel-L2
    <= 2e-3; against the port's float32 route rel-L2 <= 2e-2 where the fast
    tier pads nothing (T a multiple of 128 frames). With T=137 the fast
    tier pads to 256 frames with the mel floor, which moves the last
    samples, so a floor of 0 must fall outside the JAX band."""
    cfg = {'sampling_rate': 22050, 'upsample_rates': [2, 2],
           'upsample_kernel_sizes': [4, 4], 'upsample_initial_channel': 128,
           'resblock': '1', 'resblock_kernel_sizes': [3],
           'resblock_dilation_sizes': [[1, 3]], 'model_in_dim': 80}
    jp = jh.init_generator_params(jax.random.PRNGKey(0), cfg)
    tp = generator_from_jax(to_numpy(jp))
    mel = np.random.RandomState(3).randn(80, 256).astype(np.float32)
    t_voc = th.HiFiGanVocoder(tp, cfg, fast='bf16', device='cpu')
    t_f32 = th.HiFiGanVocoder(tp, cfg, fast=False, device='cpu')
    for m in (mel, mel[:, :137]):
        j_fast = jh.HiFiGanVocoder(params=jp, config=cfg, fast=True).infer(m)
        t_fast = t_voc.infer(m)
        assert t_fast.shape == j_fast.shape == (m.shape[1] * 4,)
        assert t_fast.dtype == np.float32
        assert rel_l2(t_fast, j_fast) <= 2e-3
    t_exact = t_f32.infer(mel)
    assert rel_l2(t_voc.infer(mel), t_exact) <= 2e-2
    zero_floor = np.pad(mel[:, :137], ((0, 0), (0, 256 - 137)))
    assert rel_l2(t_voc.infer(zero_floor)[:137 * 4], j_fast) > 2e-3


@pytest.mark.parametrize('case', ['uncalibrated', 'batch_below_8'])
def test_int8_tier_is_not_a_fallback(case):
    """The int8 routes below the phase-tc batch run their int8 kernels and
    match the JAX int8 wrapper: the int8-dynamic tier (no calibration
    mels: ``fused_mrf_ct`` q8 at the wide level, the dynamic int8
    ``fused_mrf_phase`` at the narrow one) and, in the calibrated tier, a
    narrow level below the batch threshold of 8 (the q8f int8
    ``fused_mrf_phase``). Band rel-L2 <= 5e-2 (the JAX package's band
    between two forms of the int8 generator: the JAX wrapper packs the
    wide level's static weights under jit, an ulp apart in their scales).
    A level outside V1's widths (C=96, then 48) takes the JAX generator's
    route too, ``fused_mrf_ct`` q8 at C=96 and the float merged-tap form
    at C=48 (int8 needs C % 32 == 0), and matches it at the same band."""
    jp, tp, mel = _case(CFG_TC, seed=0, T=128, B=1)
    cal = mel if case == 'batch_below_8' else None
    voc = th.HiFiGanVocoder(tp, CFG_TC, fast='int8', device='cpu',
                            int8_calibration_mels=cal)
    assert voc.int8 and (voc.act_scales is None) == (case == 'uncalibrated')
    assert voc.packed[0].dynamic == (case == 'uncalibrated')
    assert isinstance(voc.packed[1], th.NarrowLevel)
    assert voc.packed[1].phase.dynamic == (case == 'uncalibrated')
    got = voc.infer(mel[0])
    want = jh.HiFiGanVocoder(params=jp, config=CFG_TC, fast='int8',
                             int8_calibration_mels=cal).infer(mel[0])
    assert got.shape == want.shape == (128 * 16,)
    assert np.abs(want).max() > 0
    assert rel_l2(got, want) <= 5e-2
    cfg = dict(CFG_TC, upsample_initial_channel=192)    # C=96 at level 0
    jp2, tp2, _ = _case(cfg, seed=0, T=128, B=1)
    m = mel[:, :, :32]
    assert th.level_routes(tp2, cfg, 1, 32, int8=True) == [
        th.Route('ct', 'q8', 1, 256), th.Route('ct', '', 1, 512, True)]
    with torch.no_grad():
        got = th.generator_forward(
            {k: {kk: (vv.bfloat16() if torch.is_tensor(vv) else
                      {a: t.bfloat16() for a, t in vv.items()})
                 for kk, vv in v.items()} for k, v in tp2.items()},
            torch.from_numpy(m).bfloat16(), cfg, use_fast=True, int8=True)
    want = jh.generator_forward(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp2),
        jnp.asarray(m, jnp.bfloat16), cfg, use_pallas=True, int8=True,
        interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert rel_l2(got.float().numpy(), want) <= 5e-2


def test_generator_bridge_is_a_copy_of_every_leaf():
    jp = jh.init_generator_params(jax.random.PRNGKey(4), CFG_TC)
    tp = generator_from_jax(to_numpy(jp))
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)

    def get(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    n = 0
    for path, leaf in j_leaves:
        t = get(tp, path)
        assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
        assert np.array_equal(t.numpy(), np.asarray(leaf))
        n += 1
    assert n == sum(1 for _ in _torch_leaves(tp))
    with pytest.raises(KeyError):
        generator_from_jax({'conv_pre': {'w': np.zeros(3), 'g': np.zeros(3)}})


def _torch_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _torch_leaves(v)
        else:
            yield v


def test_init_generator_params_shapes_match_jax():
    jp = jax.eval_shape(lambda key: jh.init_generator_params(
        key, jh.DEFAULT_CONFIG), jax.random.PRNGKey(0))
    tp = th.init_generator_params(0, th.DEFAULT_CONFIG, device='cpu')
    j = {'/'.join(str(p.key) for p in path): leaf.shape
         for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    t = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                t['/'.join(prefix + (k,))] = tuple(v.shape)
    walk(tp, ())
    assert t == j

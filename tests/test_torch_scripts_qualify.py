"""The port's int8 qualification tool (daft_exprt_torch/scripts/
qualify_int8.py) against the JAX script (scripts/qualify_int8.py) on the
same numpy inputs: the synthetic corpus, the multi-resolution STFT
distance, the gate, the saturation report and the per-level taps at V1's
widths, the JAX script's weights file, the GAN loop's segment draws; and
the ``fuse_post`` switch of the generator (the JAX package's
``DAFT_FUSE_POST``) on the port's plain int8 route. Port code runs on one
torch thread."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.models import hifigan as th

from scripts import qualify_int8 as jq
from tests.torch_port_utils import one_torch_thread, rel_l2, to_numpy
from tests.torch_scripts_utils import port_tool

q = port_tool('qualify_int8')


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope='module')
def v1():
    """V1 params (the port's seeded init, as numpy), a 16-frame eval mel
    and a calibration mel of the synthetic corpus (the port's loss mel)."""
    from daft_exprt_torch.vocoder_finetune import make_loss_mel_fn
    jp = to_numpy(th.init_generator_params(0, device='cpu'))
    y = q.build_corpus(np.random.RandomState(1234), 2, 16 * 256)
    with torch.no_grad():
        mels = make_loss_mel_fn(device='cpu')(torch.from_numpy(y[:, 0]))
    mels = mels.numpy()
    return jp, mels[:1], mels[1:]


def test_build_corpus_matches_jax():
    a = jq.build_corpus(np.random.RandomState(3), 3, 2048)
    b = q.build_corpus(np.random.RandomState(3), 3, 2048)
    assert a.shape == b.shape == (3, 1, 2048) and a.dtype == b.dtype
    assert np.array_equal(a, b)


def test_mrstft_distance_matches_jax():
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 3, 6000)
    for got, want in zip(q.mrstft_distance(x, y), jq.mrstft_distance(x, y)):
        assert abs(got - want) <= 1e-12


def _results(scale):
    """Crafted results: every metric ``scale`` times its limit."""
    trained = {tier: {m: lim * scale for m, lim in lims.items()}
               for tier, lims in jq.GATE_THRESHOLDS.items()}
    return {
        'trained': trained,
        'calibration_sweep': {
            'cal_matched': {'sat_max': jq.SAT_MATCHED_MAX * scale},
            'cal_noise': {'wav_rel_l2': jq.NOISE_DETECT_MIN / scale}},
        'per_level_rel_l2': {'level_0': 1e-3, 'level_1': 2e-3,
                             'level_2': 2e-3 * (2.9 if scale < 1 else 3.5),
                             'level_3': jq.LEVEL_FINAL_MAX * scale},
    }


@pytest.mark.parametrize('scale', [0.5, 1.5])
def test_gate_matches_jax(scale):
    for name in ('GATE_THRESHOLDS', 'SAT_MATCHED_MAX', 'LEVEL_FINAL_MAX',
                 'LEVEL_GROWTH_MAX', 'NOISE_DETECT_MIN'):
        assert getattr(q, name) == getattr(jq, name), name
    res = _results(scale)
    want = jq.gate(copy.deepcopy(res))
    got = q.gate(copy.deepcopy(res))
    assert got == want
    assert want[0] == ('pass' if scale < 1 else 'fail')
    # one failing metric fails the verdict on both sides
    res['trained']['int8_pallas']['mel_l1'] = 1.0
    assert q.gate(res) == jq.gate(res) and q.gate(res)[0] == 'fail'


def test_saturation_report_matches_jax(v1):
    jp, mel, cal = v1
    t_scales = th.calibrate_act_scales(generator_from_jax(jp), cal)
    j_scales = {i: [(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
                    for a, b in lvl] for i, lvl in t_scales.items()}
    want = jq.saturation_report(jax.tree_util.tree_map(jnp.asarray, jp),
                                mel, j_scales)
    got = q.saturation_report(generator_from_jax(jp), mel, t_scales)
    assert sorted(got) == sorted(want) == [f'level_{i}' for i in range(4)]
    T, C = mel.shape[-1], 512
    for i in range(4):
        T, C = T * (8, 8, 2, 2)[i], C // 2
        n = mel.shape[0] * C * T                      # elements a point
        for stat in ('mean', 'max'):
            assert abs(got[f'level_{i}'][stat] - want[f'level_{i}'][stat]) \
                <= 1.0 / n, (i, stat)
    assert max(v['max'] for v in want.values()) > 0


def test_per_level_budget_taps_match_jax(v1):
    """The float32 taps the budget compares against are JAX's XLA taps;
    the port's budget runs end to end (plain int8 route on the CPU) and
    its last level is the MRF output."""
    jp, mel, cal = v1
    j_taps = {}

    def tap(i, x, p, tc):
        j_taps[f'level_{i}'] = np.asarray(x, np.float32)
    jh.generator_forward(jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(mel), use_pallas=False, _tap=tap)
    tp = generator_from_jax(jp)
    with th.full_f32():
        t_taps, _ = q.level_taps(tp, torch.from_numpy(mel))
    assert sorted(t_taps) == sorted(j_taps)
    for k in j_taps:
        assert t_taps[k].shape == j_taps[k].shape
        assert rel_l2(t_taps[k].numpy(), j_taps[k]) <= 1e-5, k
    budget = q.per_level_budget(tp, torch.from_numpy(mel),
                                th.calibrate_act_scales(tp, cal))
    assert sorted(budget) == sorted(j_taps)
    assert all(np.isfinite(v) and 0 < v < 0.1 for v in budget.values())


def test_fuse_post_off_gives_the_mrf_output(v1):
    jp, mel, cal = v1
    tp = generator_from_jax(jp)
    scales = th.calibrate_act_scales(tp, cal)
    p16 = th._to(tp, torch.bfloat16, 'cpu')
    m16 = torch.from_numpy(mel).bfloat16()
    runs = {}
    for fuse in (True, False):
        taps, wav = q.level_taps(p16, m16, use_fast=True,
                                 int8_act_scales=scales, ptc_min_batch=1,
                                 fuse_post=fuse, plain=True)
        runs[fuse] = (taps, wav.float().numpy())
    T = mel.shape[-1] * 256
    assert tuple(runs[True][0]['level_3'].shape) == (1, 1, T)
    assert tuple(runs[False][0]['level_3'].shape) == (1, 32, T)
    for k in ('level_0', 'level_1', 'level_2'):
        assert torch.equal(runs[True][0][k], runs[False][0][k])
    assert runs[False][1].shape == runs[True][1].shape == (1, 1, T)
    assert rel_l2(runs[False][1], runs[True][1]) <= 1e-2
    # weights packed with conv_post do not serve fuse_post=False, and the
    # other way round
    for packed_with in (True, False):
        packed = th.pack_levels(p16, act_scales=scales, int8=True,
                                fuse_post=packed_with)
        with pytest.raises(ValueError, match='fuse_post'):
            th.generator_forward(p16, m16, use_fast=True,
                                 int8_act_scales=scales, ptc_min_batch=1,
                                 packed=packed, fuse_post=not packed_with,
                                 plain=True)


def test_weights_file_crosses_between_packages(v1, tmp_path):
    from flax import traverse_util
    jp, mel, _ = v1
    path = tmp_path / 'weights.npz'
    flat = {'/'.join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jp).items()}
    np.savez(path, **flat)                  # as the JAX script writes it
    tp = q.load_weights(str(path))
    want = np.asarray(jh.generator_forward(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(mel),
        use_pallas=False))
    with torch.no_grad(), th.full_f32():
        got = th.generator_forward(tp, torch.from_numpy(mel)).numpy()
    assert rel_l2(got, want) <= 1e-5
    # the port's file reads back as the JAX script reads its own
    q.save_weights(str(tmp_path / 'port.npz'), tp)
    back = dict(np.load(tmp_path / 'port.npz'))
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_train_generator_draws_the_jax_segments(monkeypatch):
    """The JAX loop with stand-in steps (its corpus and draws only) and
    the port's loop for real at a small generator config: the same rows
    of the same corpus each step; two steps give finite losses."""
    import daft_exprt_tpu.vocoder_finetune as jvf
    import daft_exprt_tpu.models.discriminators as jd
    seen_j, seen_t = [], []

    def jax_steps(compute_dtype='float32'):
        def d_step(d, d_opt, sn, g, mel, y):
            seen_j.append(np.asarray(y))
            return d, d_opt, sn, 0.0

        def g_step(g, g_opt, d, sn, mel, y, y_mel):
            return g, g_opt, 0.0, 0.0

        class Opt:
            def init(self, p):
                return None
        return d_step, g_step, (Opt(), Opt()), lambda w: w[:, None, ::256]

    monkeypatch.setattr(jvf, 'make_gan_steps', jax_steps)
    monkeypatch.setattr(jvf, 'generator_to_weight_norm', lambda p: p)
    monkeypatch.setattr(jvf, 'generator_from_weight_norm', lambda p: p)
    monkeypatch.setattr(jh, 'init_generator_params', lambda key: {})
    monkeypatch.setattr(jd, 'init_msd_params', lambda key: ({}, {}))
    monkeypatch.setattr(jd, 'init_mpd_params', lambda key: {})
    jq.train_generator(2, 1, seed=3)

    real = q.make_gan_steps

    def port_steps(*a, **k):
        d_step, g_step, optims, loss_mel_fn = real(*a, **k)

        def rec_d(mpd, msd, d_opt, g, mel, y):
            seen_t.append(y.numpy())
            loss = d_step(mpd, msd, d_opt, g, mel, y)
            seen_t.append(float(loss))
            return loss
        return rec_d, g_step, optims, loss_mel_fn

    monkeypatch.setattr(q, 'make_gan_steps', port_steps)
    small = dict(th.DEFAULT_CONFIG, upsample_initial_channel=16,
                 resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]])
    params = q.train_generator(2, 1, seed=3, device='cpu', config=small)
    assert len(seen_j) == 2 and len(seen_t) == 4
    for y_j, y_t in zip(seen_j, seen_t[::2]):
        assert y_j.shape == y_t.shape == (1, 1, 8192)
        assert np.array_equal(y_j, y_t)
    assert all(np.isfinite(v) for v in seen_t[1::2])
    from daft_exprt_torch.vocoder_finetune import param_leaves
    assert all(torch.isfinite(v).all() and not v.requires_grad
               for v in param_leaves(params))

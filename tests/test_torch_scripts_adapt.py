"""The port's adaptation tools (daft_exprt_torch/scripts/adapt_speaker.py
and adapt_accent.py) against the top-level scripts on the CPU: one epoch
of one batch (the whole training list) at a small width, every dropout at
0, from one set of weights saved as both packages' checkpoints.

- The unfrozen roots after the step, the loss and the grad norm (over
  every parameter, frozen ones included) within test_torch_train_step's
  band: loss and grad norm rel 1e-5; parameters within 1e-3 lr where
  |g| > 1e-6, within 2 lr elsewhere (Adam's first update ~lr sign(g)).
- The frozen parameters bit-equal to the input in the port. The JAX
  scripts' ``optax.masked(optax.adam(lr), mask)`` passes the raw gradient
  through on masked-out leaves and ``apply_updates`` adds it: there JAX's
  parameters move by +g (within 1e-4 of the leaf's largest gradient, the
  train-step band for gradients), a difference by design.
- The memorized embedding in ``extra`` rel-L2 1e-5 of JAX's.
"""
import numpy as np
import pytest
import torch

import jax

from daft_exprt_tpu import checkpoint as jax_ckpt
from daft_exprt_tpu.parallel import train_step as jts
from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.models.pitch_predictor import BatchNorm
from daft_exprt_torch.parallel import train_step as pts
from daft_exprt_torch.scripts import adapt_accent, adapt_speaker

from tests.synth_data import build_synthetic_dataset
from tests.torch_port_utils import one_torch_thread, rel_l2
from tests.torch_scripts_utils import (
    jax_parser, save_both_checkpoints, small_config,
)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('scripts_adapt')
    train_list, _, _ = build_synthetic_dataset(str(root / 'ds'),
                                               files_per_speaker=3)
    jax_ck, port_ck, params = save_both_checkpoints(
        str(root), small_config(stats={}))
    return root, train_list, jax_ck, port_ck, params


def _record_steps(monkeypatch):
    """Both packages' make_train_step, wrapped to record each step's
    metrics (and, in the port, the gradients)."""
    seen = {'jax': [], 'port': []}
    j_make, p_make = jts.make_train_step, pts.make_train_step

    def jax_make(*a, **kw):
        step = j_make(*a, **kw)

        def run(*args):
            out = step(*args)
            seen['jax'].append({k: float(v) for k, v in out[2].items()})
            return out
        return run

    def port_make(model, *a, **kw):
        step = p_make(model, *a, **kw)

        def run(*args):
            m = step(*args)
            seen['port'].append(({k: float(v) for k, v in m.items()}, {
                n: p.grad.clone() for n, p in model.named_parameters()}))
            return m
        return run

    monkeypatch.setattr(jts, 'make_train_step', jax_make)
    monkeypatch.setattr(pts, 'make_train_step', port_make)
    return seen


def _run_both(name, port_tool, setup, monkeypatch, extra_argv=()):
    root, train_list, jax_ck, port_ck, params = setup
    seen = _record_steps(monkeypatch)
    argv = ['-tf', train_list, '--epochs', '1', '--batch_size', '8',
            '--learning_rate', '1e-3'] + list(extra_argv)
    jax_out, port_out = str(root / f'{name}_jax'), str(root / f'{name}_port')
    jmod = __import__(f'scripts.{name}', fromlist=['main'])
    jmod.main(jax_parser(name).parse_args(
        ['-chk', jax_ck, '-out', jax_out] + argv))
    with one_torch_thread():
        port_tool.main(['-chk', port_ck, '-out', port_out, '--device',
                        'cpu'] + argv)
    assert len(seen['jax']) == len(seen['port']) == 1
    jpayload, _ = jax_ckpt.load_checkpoint(jax_out)
    tpayload, tmeta = ckpt.load_checkpoint(port_out)
    assert tpayload['optimizer'] is None and tmeta['iteration'] == 1
    return (params, jpayload, tpayload, seen['jax'][0], seen['port'][0])


def _check_step(params, jpayload, tpayload, jm, port_step, unfrozen,
                lr=1e-3):
    tm, grads = port_step
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    before = acoustic_state_from_jax(params)
    after_j = acoustic_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jpayload['params']))
    after_t = tpayload['model']
    n_frozen = n_moved = 0
    for k, b in before.items():
        g = grads[k]
        if k.split('.', 1)[0] in unfrozen:
            d = (after_t[k] - after_j[k]).abs()
            assert float(torch.where(g.abs() <= 1e-6, 0.0, d).max()) <= \
                1e-3 * lr, k
            assert float(d.max()) <= 2 * lr + 1e-7, k
            assert not torch.equal(after_t[k], b), k
        else:
            n_frozen += 1
            assert torch.equal(after_t[k], b), k
            moved = after_j[k] - b
            assert float((moved - g).abs().max()) <= \
                1e-4 * float(g.abs().max()) + 1e-7, k
            n_moved += bool(g.abs().max() > 1e-6)
    assert n_frozen > 10 and n_moved > 10, (n_frozen, n_moved)


def test_adapt_speaker_matches_jax(setup, monkeypatch):
    params, jp, tp, jm, ts = _run_both('adapt_speaker', adapt_speaker, setup,
                                       monkeypatch, ('--tier', '2'))
    _check_step(params, jp, tp, jm, ts, adapt_speaker.TIERS[2])
    want = np.asarray(jp['extra']['memorized_spk_emb'])
    got = tp['extra']['memorized_spk_emb'].numpy()
    assert got.shape == want.shape == (192,)
    assert rel_l2(got, want) <= 1e-5


def test_adapt_accent_matches_jax(setup, monkeypatch):
    params, jp, tp, jm, ts = _run_both('adapt_accent', adapt_accent, setup,
                                       monkeypatch, ('--unfreeze_decoder',))
    _check_step(params, jp, tp, jm, ts, ['style_adapter', 'frame_decoder'])
    want = np.asarray(jp['extra']['memorized_accent_emb'])
    got = tp['extra']['memorized_accent_emb'].numpy()
    assert got.shape == want.shape == (16,)
    assert rel_l2(got, want) <= 1e-5


def test_freeze_mask_matches_jax():
    from scripts.adapt_speaker import make_freeze_mask as jax_mask
    tree = {'spk_projection': {'kernel': np.zeros(3)},
            'frame_decoder': {'block_0': {'w': np.zeros(2)}},
            'style_adapter': {'g': np.zeros(1)}}
    roots = ['spk_projection', 'style_adapter']
    want = jax_mask(tree, roots)
    got = adapt_speaker.make_freeze_mask(
        ['spk_projection.kernel', 'frame_decoder.block_0.w',
         'style_adapter.g'], roots)
    assert got == {'spk_projection.kernel': want['spk_projection']['kernel'],
                   'frame_decoder.block_0.w':
                   want['frame_decoder']['block_0']['w'],
                   'style_adapter.g': want['style_adapter']['g']}


@pytest.mark.parametrize('training', [True, False])
def test_batch_norm_matches_flax(training):
    """The pitch predictor's BatchNorm against flax's in both modes, on
    values with a large mean (where the biased variance's E[x^2] - E[x]^2
    form matters): outputs and, in training mode, the running averages
    after two calls."""
    import flax.linen as fnn
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 37, 8) * 2.0 + 5.0).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=not training, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x[0])
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.3 * rng.rand(*v.shape).astype(
            np.float32), variables)
    tbn = BatchNorm(8)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables['params']['scale']))
        tbn.bias.copy_(torch.from_numpy(variables['params']['bias']))
        tbn.running_mean.copy_(torch.from_numpy(
            variables['batch_stats']['mean']))
        tbn.running_var.copy_(torch.from_numpy(
            variables['batch_stats']['var']))
    tbn.train(training)
    for xi in x:
        want, mutated = bn.apply(variables, xi, mutable=['batch_stats'])
        variables = dict(variables, **mutated)
        got = tbn(torch.from_numpy(xi))
        assert float((got - torch.from_numpy(np.asarray(want))).abs(
            ).max()) <= 1e-5
    for name, key in (('running_mean', 'mean'), ('running_var', 'var')):
        want = np.asarray(variables['batch_stats'][key])
        assert np.abs(getattr(tbn, name).numpy() - want).max() <= 1e-6, name

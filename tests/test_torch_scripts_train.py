"""The port's training tools (daft_exprt_torch/scripts/training.py and
train_pitch_predictor.py) against the top-level scripts on the CPU, on
test_torch_frontend.py's four-utterance corpus (markers given, so
``pre_process --skip_mfa --skip_ecapa``, and seeded stand-ins for the
ECAPA embeddings), at a small width with every dropout at 0:

- ``pre_process``: the same train.txt / validation.txt (up to each run's
  features root) and stats.json within rel 1e-4 (the features are within
  test_torch_frontend's bands, the F0 tracks on >= 99% of lines);
- ``train --num_iterations 2`` on the same features and initial weights
  (JAX's, carried over through the bridge): every logged loss term and
  the grad norm of the last step within rel 1e-5 (test_torch_train_step's
  band); the checkpoint written and ``config.json`` saved;
- ``fine_tune`` from each run's checkpoint: the same pairs, .npy mels
  max-abs 1e-3 and .wav files equal;
- ``train_pitch_predictor``, one step from the same initial variables:
  the loss and every parameter within 1e-5 of JAX's (but where float32
  cannot resolve the sign of the gradient, which Adam's first step
  follows: within 2 lr), every running statistic within 1e-5 relative
  (flax BatchNorm: biased batch variance, momentum 0.9), and its output
  loads strictly through ``load_frozen_pitch_predictor``.

Beside them, ``full_f32`` (which pre_process's feature threads each
enter) keeps TF32 off while any thread's body runs and restores torch's
process-wide flags when the last body leaves.
"""
import functools
import json
import logging
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax

from daft_exprt_torch.scripts import training as ttraining
from daft_exprt_torch.scripts import train_pitch_predictor as tpp

from tests.test_torch_frontend import write_corpus
from tests.torch_port_utils import max_abs, one_torch_thread
from tests.torch_scripts_utils import SMALL0, jax_parser

OVERRIDES = dict(phoneme_encoder=SMALL0, accent_encoder=SMALL0,
                 frame_decoder=SMALL0, length_buckets=[8, 16],
                 frame_buckets=[128, 256], batch_size=2,
                 compute_dtype='float32', dynamic_stats_subset_size=2,
                 pitch_consistency_weight=0.0)


def _argv(root, which, *cmd, device=()):
    return ['-dd', str(root / 'dataset'), '-ed', str(root / which), '-en',
            'exp', '--config_overrides', json.dumps(OVERRIDES)] + \
        list(device) + list(cmd)


def _jax_run(root, which, *cmd):
    import scripts.training as jtraining
    args = jax_parser('training').parse_args(_argv(root, which, *cmd))
    return args.func.__name__, getattr(jtraining, args.func.__name__)(args)


def _port_run(root, which, *cmd):
    with one_torch_thread():
        return ttraining.main(_argv(root, which, *cmd,
                                    device=('--device', 'cpu')))


@pytest.fixture(scope='module')
def preprocessed(tmp_path_factory):
    root = tmp_path_factory.mktemp('scripts_train')
    write_corpus(root)
    cmd = ('pre_process', '--skip_mfa', '--skip_ecapa', '--pitch_method',
           'device')
    _jax_run(root, 'jax', *cmd)
    _port_run(root, 'port', *cmd)
    rng = np.random.RandomState(0)
    for which in ('jax', 'port'):
        feats = root / which / 'features'
        for spk in sorted(os.listdir(feats)):
            for f in sorted(os.listdir(feats / spk)):
                if f.endswith('.markers'):
                    np.save(feats / spk / f.replace('.markers',
                                                    '.spk_emb.npy'),
                            rng.randn(192).astype(np.float32))
        rng = np.random.RandomState(0)
    return root


def test_pre_process_matches_jax(preprocessed):
    root = preprocessed
    for name in ('train.txt', 'validation.txt'):
        lines = {}
        for which in ('jax', 'port'):
            with open(root / which / 'exp' / name) as f:
                lines[which] = f.read().replace(str(root / which), 'ROOT')
        assert lines['jax'] == lines['port'] and lines['jax'].strip()
    stats = {}
    for which in ('jax', 'port'):
        with open(root / which / 'exp' / 'stats.json') as f:
            stats[which] = json.load(f)
    assert set(stats['jax']) == set(stats['port'])
    for spk, want in stats['jax'].items():
        if spk == 'symbols':
            assert stats['port'][spk] == want
            continue
        for k in ('energy', 'pitch'):
            for s in ('mean', 'std'):
                assert stats['port'][spk][k][s] == pytest.approx(
                    want[k][s], rel=1e-4), (spk, k, s)


@pytest.fixture(scope='module')
def trained(preprocessed):
    """``train --num_iterations 2`` by both tools on the JAX run's
    features, from JAX's initial weights; returns their final metrics."""
    from daft_exprt_tpu import train as jtrain
    from daft_exprt_tpu.hparams import HyperParams as JaxHParams
    from daft_exprt_torch import train as port_train
    from daft_exprt_torch.bridge import acoustic_state_from_jax
    root = preprocessed
    shutil.copytree(root / 'jax' / 'exp', root / 'port_train' / 'exp')
    results = {}
    orig_launch = jtrain.launch_training

    def jax_launch(hparams, **kw):
        # one device, as the port's single process (the conftest gives
        # JAX eight virtual CPU devices)
        from daft_exprt_tpu.parallel.mesh import make_mesh
        results['jax'] = orig_launch(hparams, mesh=make_mesh(
            n_data=1, devices=jax.devices('cpu')[:1]), **kw)
        return results['jax']

    orig_init = port_train.init_model_and_state

    def port_init(hparams, device=None, seed=None):
        model, opt = orig_init(hparams, device, seed)
        jhp = JaxHParams(**{k: v for k, v in hparams.__dict__.items()
                            if k not in ('n_symbols',)})
        params = jtrain.init_model_and_state(jhp)[1]
        model.load_bridged(acoustic_state_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        return model, opt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, 'launch_training', jax_launch)
        mp.setattr(port_train, 'init_model_and_state', port_init)
        _jax_run(root, 'jax', 'train', '--num_iterations', '2')
        results['port'] = _port_run(root, 'port_train', 'train',
                                    '--num_iterations', '2')
    return root, results


def test_train_matches_jax(trained):
    root, results = trained
    (_, jm), (_, tm) = results['jax'], results['port']
    assert set(tm) == set(jm) and 'grad_norm' in tm
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    out = root / 'port_train' / 'exp'
    assert (out / 'checkpoints' / 'DaftExprt_2').is_file()
    assert (out / 'config.json').is_file()
    with open(out / 'checkpoints' / 'DaftExprt_2.json') as f:
        assert json.load(f)['iteration'] == 2


def test_fine_tune_matches_jax(trained):
    root, _ = trained
    dirs = {}
    for which, run in (('jax', _jax_run), ('port_train', _port_run)):
        ck = str(root / which / 'exp' / 'checkpoints' / 'DaftExprt_2')
        run(root, which, 'fine_tune', '-chk', ck)
        dirs[which] = root / which / 'exp' / 'fine_tuning_dataset'
    pairs = {w: sorted(os.path.relpath(os.path.join(dp, f), d)
                       for dp, _, fs in os.walk(d) for f in fs)
             for w, d in dirs.items()}
    # a .npy and a .wav for each utterance of the training list
    assert pairs['jax'] == pairs['port_train'] and len(pairs['jax']) == 4
    for rel in pairs['jax']:
        a, b = (dirs[w] / rel for w in ('jax', 'port_train'))
        if rel.endswith('.npy'):
            assert max_abs(np.load(a), np.load(b)) < 1e-3, rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _jax_pitch_init(n_mel, t_max, seed, dropout=0.0):
    from daft_exprt_tpu.models.pitch_predictor import PitchPredictor
    model = PitchPredictor(n_mel_channels=n_mel, dropout=dropout)
    return model.init({'params': jax.random.PRNGKey(seed)},
                      np.zeros((1, n_mel, t_max), np.float32),
                      deterministic=True, use_running_average=False)


def test_train_pitch_predictor_matches_jax(preprocessed, tmp_path, caplog):
    """One step of both tools on the JAX run's features, dropout 0, from
    JAX's initial variables (the port's initialiser replaced by them)."""
    import scripts.train_pitch_predictor as jtpp
    from daft_exprt_tpu import checkpoint as jax_ckpt
    from daft_exprt_tpu.models import pitch_predictor as jpp_mod
    from daft_exprt_torch.bridge import pitch_predictor_from_jax
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models import pitch_predictor as tpp_mod
    from daft_exprt_torch.train import load_frozen_pitch_predictor
    feats = str(preprocessed / 'jax' / 'features')
    argv = ['-fd', feats, '--epochs', '1', '--batch_size', '4', '--t_max',
            '160', '--seed', '7']
    init = _jax_pitch_init(80, 160, 7)
    want_init = pitch_predictor_from_jax(init['params'], init['batch_stats'])

    def init_from_jax(self, seed):
        assert seed == 7
        self.load_state_dict(want_init, strict=True)
        return self

    with pytest.MonkeyPatch.context() as mp, \
            caplog.at_level(logging.INFO):
        mp.setattr(jpp_mod, 'PitchPredictor', functools.partial(
            jpp_mod.PitchPredictor, dropout=0.0))
        mp.setattr(tpp_mod.PitchPredictor, 'init_random_', init_from_jax)
        mp.setattr(tpp_mod.PitchPredictor, '__init__', functools.partialmethod(
            tpp_mod.PitchPredictor.__init__, dropout=0.0))
        jtpp.main(jax_parser('train_pitch_predictor').parse_args(
            argv + ['-out', str(tmp_path / 'jax')]))
        with one_torch_thread():
            path = tpp.main(argv + ['-out', str(tmp_path / 'port'),
                                    '--device', 'cpu'])
    losses = [float(m) for m in re.findall(
        r'epoch 1: masked MSE ([0-9.]+) \(1 steps\)', caplog.text)]
    assert len(losses) == 2
    assert losses[1] == pytest.approx(losses[0], abs=1e-5)
    payload, _ = jax_ckpt.load_checkpoint(str(tmp_path / 'jax' /
                                              'pitch_predictor_epoch_1'))
    want = pitch_predictor_from_jax(payload['params']['params'],
                                    payload['params']['batch_stats'])
    hp = HyperParams(verbose=False, training_files='x', validation_files='x',
                     output_directory=str(tmp_path), language='english',
                     speakers=['s'], pitch_predictor_path=path)
    got = load_frozen_pitch_predictor(hp, device='cpu').state_dict()
    assert set(got) == set(want)
    # the step's gradient in float32 on both sides and in float64 (the
    # port). Adam's first update is ~lr sign(g): where float32 cannot
    # resolve g's sign (the biases and kernels before a BatchNorm in
    # training mode have gradients of cancelling terms: |g64| within twice
    # either side's float32 error) or g sits at Adam's noise floor (0 < |g|
    # <= 1e-6 on some side, test_torch_train_step's rule), the two sides
    # may differ by 2 lr; elsewhere (dead ReLU channels' zero gradients
    # included) they agree within 1e-5
    from daft_exprt_torch.bridge import acoustic_state_from_jax
    mel, f0, lengths = next(tpp.batches(
        tpp.collect_files(feats), 4, 160, np.random.RandomState(7)))
    jmodel = jpp_mod.PitchPredictor(n_mel_channels=80, dropout=0.0)

    def jax_loss(params):
        out, _ = jmodel.apply(
            {'params': params, 'batch_stats': init['batch_stats']}, mel,
            deterministic=True, use_running_average=False,
            mutable=['batch_stats'])
        mask = ((np.arange(out.shape[1])[None] < lengths[:, None])
                & (f0 != 0.0)).astype(np.float32)
        return (((out - f0) ** 2) * mask).sum() / (mask.sum() + 1e-5)
    grads = {'jax': acoustic_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(jax_loss)(init['params'])))}
    for dtype in (torch.float32, torch.float64):
        model = tpp_mod.PitchPredictor(dropout=0.0)
        model.load_state_dict(want_init)
        model = model.to(dtype).train()
        tpp.masked_mse(model(torch.from_numpy(mel).to(dtype)),
                       torch.from_numpy(f0).to(dtype),
                       torch.from_numpy(lengths)).backward()
        grads[dtype] = {n: p.grad.double()
                        for n, p in model.named_parameters()}
    lr, n_loose, n_all = 1e-4, 0, 0
    for k, v in want.items():
        d = (got[k] - v).abs()
        if k not in grads[torch.float64]:
            # running statistics: 1e-5 relative to values up to ~1e2
            assert float((d / v.abs().clamp(min=1.0)).max()) <= 1e-5, k
            assert not torch.equal(v, want_init[k]), k     # moved
            continue
        g64 = grads[torch.float64][k]
        err = torch.maximum((grads['jax'][k].double() - g64).abs(),
                            (grads[torch.float32][k] - g64).abs())
        g_max = torch.maximum(torch.maximum(grads['jax'][k].double().abs(),
                                            grads[torch.float32][k].abs()),
                              g64.abs())
        loose = ((g64.abs() <= 2 * err) | (g_max <= 1e-6)) & (g_max > 0)
        n_loose, n_all = n_loose + int(loose.sum()), n_all + loose.numel()
        assert float(torch.where(loose, 0.0, d).max()) <= 1e-5, k
        assert float(d.max()) <= 2 * lr + 1e-7, k
    assert n_loose <= 1e-3 * n_all, (n_loose, n_all)


def test_full_f32_restores_the_flags_across_threads():
    """Four threads entering and leaving full_f32 out of step, as
    extract_features' threads do: every body sees TF32 off, and torch's
    flags are as before once all have left."""
    from daft_exprt_torch.ops.vocoder_kernels import full_f32
    b = torch.backends
    flags = (lambda: (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32))
    before, seen = flags(), set()
    start = threading.Barrier(4)

    def work(i):
        start.wait()
        for j in range(40):
            with full_f32():
                time.sleep(0.0005 * ((i + j) % 3))
                seen.add(flags())

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {(False, False)}
    assert flags() == before

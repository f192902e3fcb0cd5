"""The port's training data pipeline and driver (daft_exprt_torch/data,
train.py, checkpoint.py) on ``tests/synth_data.py``'s on-disk dataset:

- the port's dataset, collation, iterators and dynamic speaker stats give
  arrays identical to the JAX package's on the same files and seed;
- ``train(hp, num_iterations=4, device='cpu')`` at a tiny width runs,
  validates, writes checkpoints and resumes from one with the same
  iteration and optimizer state;
- the frozen pitch predictor loads from the port's and the reference's
  state-dict layouts; a file that needs unpickling is refused.
"""
import os

import numpy as np
import pytest
import torch

from daft_exprt_tpu import checkpoint as jax_ckpt
from daft_exprt_tpu.data import (
    DaftExprtDataset as JaxDataset,
    DynamicSpeakerStatsManager as JaxStats,
    collate_batch as jax_collate, prepare_data_iterators as jax_iterators,
)
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.bridge import pitch_predictor_from_jax
from daft_exprt_torch.data import (
    DaftExprtDataset, DynamicSpeakerStatsManager, collate_batch,
    prepare_data_iterators,
)
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.models.pitch_predictor import PitchPredictor
from daft_exprt_torch.train import (
    init_model_and_state, load_frozen_pitch_predictor, train,
)

from tests.synth_data import build_synthetic_dataset

SMALL = {'nb_blocks': 1, 'hidden_embed_dim': 16, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 24,
         'conv_dropout': 0.1}


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_synth'))
    train_list, val_list, _ = build_synthetic_dataset(root,
                                                      files_per_speaker=8)
    return root, train_list, val_list


def _kw(root, train_list, val_list, out='out', **kw):
    kwargs = dict(
        verbose=False, training_files=train_list, validation_files=val_list,
        output_directory=os.path.join(root, out), language='english',
        speakers=['speaker_0', 'speaker_1'],
        phoneme_encoder=dict(SMALL), accent_encoder=dict(SMALL),
        frame_decoder=dict(SMALL), length_buckets=[16, 32],
        frame_buckets=[64, 128], batch_size=2, accumulation_steps=1,
        iters_check_for_model_improvement=4, iters_per_checkpoint=1000,
        warmup_steps=10, pitch_consistency_weight=0.0,
        dynamic_stats_subset_size=3, stats_refresh_interval=2)
    kwargs.update(kw)
    return kwargs


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_data_pipeline_matches_jax(synth):
    root, train_list, val_list = synth
    kw = _kw(root, train_list, val_list)
    hp, jhp = HyperParams(**kw), JaxHParams(**kw)
    ds, jds = DaftExprtDataset(train_list, hp), JaxDataset(train_list, jhp)
    assert len(ds) == len(jds) == 14
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        _equal({k: v for k, v in a.items() if k not in
                ('features_dir', 'feature_file')},
               {k: v for k, v in b.items() if k not in
                ('features_dir', 'feature_file')})
    batch, dirs, files = collate_batch([ds[i] for i in (0, 3, 5)], hp)
    jbatch, jdirs, jfiles = jax_collate([jds[i] for i in (0, 3, 5)], jhp)
    _equal(batch, jbatch)
    assert (dirs, files) == (jdirs, jfiles)

    stats, jstats = DynamicSpeakerStatsManager(hp), JaxStats(jhp)
    train_it, val_it, n = prepare_data_iterators(hp)
    jtrain_it, jval_it, jn = jax_iterators(jhp)
    assert n == jn and len(train_it) == len(jtrain_it)
    for epoch in (0, 1):
        train_it.set_epoch(epoch)
        jtrain_it.set_epoch(epoch)
        for (b, _, _), (jb, _, _) in zip(train_it, jtrain_it):
            stats.refresh_stats()
            jstats.refresh_stats()
            _equal(b, jb)
            _equal(stats.process_batch(b), jstats.process_batch(jb))
    for (b, _, _), (jb, _, _) in zip(val_it, jval_it):
        _equal(b, jb)


def _save_pitch_predictor(path, seed=0):
    pp = PitchPredictor(80)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pp.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    torch.save({'state_dict': pp.state_dict()}, path)
    return pp


def test_train_checkpoints_and_resumes(synth):
    """4 iterations with all five loss terms (a saved random pitch
    predictor), a validation at 4 (best model) and a checkpoint; then a
    resume to 6 that starts from the saved iteration and optimizer
    state."""
    root, train_list, val_list = synth
    pp_path = os.path.join(root, 'pitch_predictor.pt')
    _save_pitch_predictor(pp_path)
    kw = _kw(root, train_list, val_list, out='run',
             pitch_predictor_path=pp_path, pitch_consistency_weight=0.15)
    hp = HyperParams(**kw)
    model, metrics = train(hp, num_iterations=4, device='cpu')
    assert np.isfinite(metrics['loss']) and metrics['pitch_consistency_loss'] > 0
    ck_dir = os.path.join(hp.output_directory, 'checkpoints')
    assert os.path.isfile(os.path.join(ck_dir, 'best_model'))
    ck4 = os.path.join(ck_dir, 'DaftExprt_4')
    payload, meta = ckpt.load_checkpoint(ck4)
    assert meta['iteration'] == 4 and np.isfinite(meta['best_val_loss'])
    assert meta['config_params']['batch_size'] == 2
    assert payload['optimizer']['updates'] == 4
    for k, v in model.state_dict().items():
        assert torch.equal(payload['model'][k], v), k

    # what the resume starts from: the saved model and optimizer state
    hp2 = HyperParams(**dict(kw, checkpoint=ck4))
    m2, opt2 = init_model_and_state(hp2, device='cpu', seed=99)
    m2.load_state_dict(payload['model'])
    opt2.load_state_dict(payload['optimizer'])
    saved = payload['optimizer']['state']
    for i, st in opt2.state_dict()['state'].items():
        for name, t in st.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(
                saved[i][name])), (i, name)

    model6, metrics6 = train(hp2, num_iterations=6, device='cpu')
    payload6, meta6 = ckpt.load_checkpoint(os.path.join(ck_dir,
                                                        'DaftExprt_6'))
    assert meta6['iteration'] == 6 and payload6['optimizer']['updates'] == 6
    assert np.isfinite(metrics6['loss'])
    moved = [k for k, v in payload6['model'].items()
             if not torch.equal(v, payload['model'][k])]
    assert len(moved) > 10


def test_frozen_pitch_predictor_loads_both_layouts(tmp_path, synth):
    """The port's state dict (under 'state_dict') and the reference
    predictor's (conv_layers.*, weight norm) give the same predictor as the
    JAX package's converter."""
    root, train_list, val_list = synth
    rng = np.random.RandomState(0)
    ref_sd = {}
    for ci, bi in ((0, 2), (4, 6), (8, 10)):
        c_in = 80 if ci == 0 else 256
        ref_sd[f'conv_layers.{ci}.conv.weight_v'] = rng.randn(256, c_in, 3)
        ref_sd[f'conv_layers.{ci}.conv.weight_g'] = rng.rand(256, 1, 1) + .5
        ref_sd[f'conv_layers.{ci}.conv.bias'] = rng.randn(256)
        for n in ('weight', 'bias', 'running_mean'):
            ref_sd[f'conv_layers.{bi}.{n}'] = rng.randn(256)
        ref_sd[f'conv_layers.{bi}.running_var'] = rng.rand(256) + 0.5
    ref_sd['conv_layers.12.conv.weight_v'] = rng.randn(1, 256, 3)
    ref_sd['conv_layers.12.conv.weight_g'] = rng.rand(1, 1, 1) + 0.5
    ref_sd['conv_layers.12.conv.bias'] = rng.randn(1)
    ref_sd = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in ref_sd.items()}
    path = str(tmp_path / 'reference_pp.pt')
    torch.save({'state_dict': {'module.' + k: v for k, v in ref_sd.items()}},
               path)
    hp = HyperParams(**_kw(root, train_list, val_list,
                           pitch_predictor_path=path,
                           pitch_consistency_weight=0.15))
    pp = load_frozen_pitch_predictor(hp, device='cpu')
    params, stats = jax_ckpt.convert_torch_pitch_predictor(
        {k: v.numpy() for k, v in ref_sd.items()})
    want = pitch_predictor_from_jax(params, stats)
    for k, v in pp.state_dict().items():
        assert float((v - want[k]).abs().max()) <= 1e-6 * float(
            want[k].abs().max()), k

    own = str(tmp_path / 'own_pp.pt')
    ref = _save_pitch_predictor(own, seed=3)
    pp2 = load_frozen_pitch_predictor(HyperParams(**_kw(
        root, train_list, val_list, pitch_predictor_path=own,
        pitch_consistency_weight=0.15)), device='cpu')
    for k, v in ref.state_dict().items():
        assert torch.equal(pp2.state_dict()[k], v)
    assert load_frozen_pitch_predictor(HyperParams(**_kw(
        root, train_list, val_list, pitch_predictor_path=own)), 'cpu') is None


class _Payload:
    """An object that only full unpickling can restore."""


def test_loads_refuse_unpickling(tmp_path, synth):
    root, train_list, val_list = synth
    path = str(tmp_path / 'pickled.pt')
    torch.save({'model': {}, 'optimizer': None, 'extra': _Payload()}, path)
    with pytest.raises(ValueError, match='weights_only'):
        ckpt.load_checkpoint(path)
    hp = HyperParams(**_kw(root, train_list, val_list,
                           pitch_predictor_path=path,
                           pitch_consistency_weight=0.15))
    with pytest.raises(ValueError, match='refusing to unpickle'):
        load_frozen_pitch_predictor(hp, device='cpu')

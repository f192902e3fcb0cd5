"""``train()`` data-parallel over two gloo ranks, through ``launch_training``,
on ``tests/synth_data.py``'s dataset, 2 iterations at a tiny width: each
rank reads the sampler shard that JAX's ``prepare_data_iterators(host_id,
num_hosts)`` gives that host, both ranks end with the same metrics and
parameters, only rank 0 logs, validates aloud and saves checkpoints, and
``launch_training`` writes ``training.log`` and ``config.json``."""
import json
import os

import numpy as np
import pytest

from daft_exprt_tpu.data import prepare_data_iterators as jax_iterators
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.parallel.launch import run_ranks

from tests import torch_dist_workers as workers
from tests.synth_data import build_synthetic_dataset

SMALL = {'nb_blocks': 1, 'hidden_embed_dim': 16, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 24,
         'conv_dropout': 0.1}
ITERS = 2


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_mp'))
    train_list, val_list, _ = build_synthetic_dataset(root,
                                                      files_per_speaker=8)
    kw = dict(
        verbose=False, training_files=train_list, validation_files=val_list,
        output_directory=os.path.join(root, 'out'), language='english',
        speakers=['speaker_0', 'speaker_1'], phoneme_encoder=dict(SMALL),
        accent_encoder=dict(SMALL), frame_decoder=dict(SMALL),
        length_buckets=[16, 32], frame_buckets=[64, 128], batch_size=2,
        accumulation_steps=1, iters_check_for_model_improvement=ITERS,
        iters_per_checkpoint=1000, warmup_steps=10,
        pitch_consistency_weight=0.0, dynamic_stats_subset_size=3,
        stats_refresh_interval=2)
    ranks = run_ranks(workers.train_multiprocess, 2, args=(kw, ITERS),
                      device='cpu', timeout=240, threads=1)
    return kw, ranks


def test_ranks_agree(run):
    _, (r0, r1) = run
    assert r0['metrics'] == r1['metrics']
    assert np.isfinite(r0['metrics']['loss'])
    for k, v in r0['params'].items():
        assert np.array_equal(v, r1['params'][k]), k


def test_each_rank_reads_the_jax_host_shard(run):
    kw, ranks = run
    jhp = JaxHParams(**kw)
    for host, res in enumerate(ranks):
        train_it, _, _ = jax_iterators(jhp, batch_size=kw['batch_size'],
                                       host_id=host, num_hosts=2)
        train_it.set_epoch(0)
        want = [b for b, _ in zip((b for b, _, _ in train_it), range(ITERS))]
        assert len(res['batches']) == ITERS
        for got, ref in zip(res['batches'], want):
            assert set(got) == set(ref)
            for k in ref:
                assert np.array_equal(got[k], np.asarray(ref[k])), (host, k)
    assert not np.array_equal(ranks[0]['batches'][0]['mel_specs'],
                              ranks[1]['batches'][0]['mel_specs'])


def test_only_the_chief_logs_and_saves(run):
    kw, (r0, r1) = run
    assert any(m.startswith('Train loss [2]') for m in r0['messages'])
    assert any(m.startswith('Validation loss [2]') for m in r0['messages'])
    assert any(m.startswith('saved checkpoint') for m in r0['messages'])
    assert r1['messages'] == []
    out = kw['output_directory']
    ck_dir = os.path.join(out, 'checkpoints')
    assert sorted(os.listdir(ck_dir)) == ['DaftExprt_2', 'DaftExprt_2.json',
                                          'best_model', 'best_model.json']
    payload, meta = ckpt.load_checkpoint(os.path.join(ck_dir, 'DaftExprt_2'))
    assert meta['iteration'] == ITERS
    for k, v in r1['params'].items():
        assert np.array_equal(payload['model'][k].numpy(), v), k
    with open(os.path.join(out, 'training.log')) as f:
        log = f.read()
    assert 'Train loss [1]' in log and 'Train loss [2]' in log
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f)['batch_size'] == kw['batch_size']

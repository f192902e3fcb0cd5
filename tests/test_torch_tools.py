"""The port's host tools against the JAX package's: ``utils/profiling.py``
(``ThroughputCounter``'s and ``timed_section``'s arithmetic,
``profiler_trace`` writing a Chrome trace on the CPU, ``synchronize``),
``frontend/ecapa.py`` with a seeded stand-in ``embed_fn`` (the same
``.spk_emb.npy`` files and average embedding as JAX's; SpeechBrain's
absence raises the same error) and ``utils/plots.plot_1d_overlay``."""
import json
import os

import numpy as np
import pytest
import torch

from daft_exprt_tpu.frontend import ecapa as jax_ecapa
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.utils import profiling as jax_profiling
from daft_exprt_torch.frontend import ecapa
from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.utils import profiling
from daft_exprt_torch.utils.plots import plot_1d_overlay

KW = dict(verbose=False, training_files='x', validation_files='x',
          output_directory='/nonexistent', language='english',
          speakers=['a'])


@pytest.mark.parametrize('centered', [False, True])
def test_throughput_counter_matches_jax(centered):
    counters = []
    for cls, hp_cls in ((profiling.ThroughputCounter, HyperParams),
                        (jax_profiling.ThroughputCounter, JaxHParams)):
        hp = hp_cls(**KW)
        hp.centered = centered
        c = cls(hp)
        c.add([1024, 200, 1], 0.5)
        c.add(np.array([640]), 0.25)
        counters.append(c)
    a, b = counters
    assert a.audio_seconds == b.audio_seconds and a.rate == b.rate
    assert a.frames_to_seconds(77) == b.frames_to_seconds(77)
    assert a.report() == b.report()


def test_timed_section_and_synchronize():
    out, ref = {}, {}
    with profiling.timed_section('x', out):
        pass
    with jax_profiling.timed_section('x', ref):
        pass
    assert set(out) == set(ref) == {'x'} and out['x'] >= 0.0
    profiling.synchronize({'a': [torch.ones(2), (torch.zeros(1), 3)]})
    profiling.synchronize({})


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / 'prof')) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    with open(tmp_path / 'prof' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)


def _fake_embed(wav):
    """A seeded stand-in encoder: 192 random projections of the wav's
    first 4000 samples."""
    proj = np.random.RandomState(7).randn(192, 4000).astype(np.float32)
    x = np.zeros(4000, np.float32)
    x[:min(4000, len(wav))] = wav[:4000]
    return proj @ x


def _corpus(root):
    """features/<spk>/ list entries and the wavs under features/<spk>/wavs
    (the lookup's second candidate) at 22.05 kHz, resampled to 16 kHz."""
    rng = np.random.RandomState(0)
    lines = []
    for spk in ('spk_a', 'spk_b'):
        feat = os.path.join(root, 'features', spk)
        os.makedirs(os.path.join(feat, 'wavs'))
        for i in range(2):
            save_wav(os.path.join(feat, 'wavs', f'utt_{i}.wav'),
                     0.3 * rng.randn(22050 // 4 + 97 * i), 22050)
            lines.append(f'{feat}|utt_{i}|{spk}')
    lines.append(f'{os.path.join(root, "features", "spk_a")}|missing|spk_a')
    with open(os.path.join(root, 'list.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return os.path.join(root, 'list.txt')


def test_ecapa_files_match_jax(tmp_path):
    roots = [str(tmp_path / 'port'), str(tmp_path / 'jax')]
    lists = [_corpus(r) for r in roots]
    n_port = ecapa.compute_ecapa_for_file_lists([lists[0]],
                                                embed_fn=_fake_embed)
    n_jax = jax_ecapa.compute_ecapa_for_file_lists([lists[1]],
                                                   embed_fn=_fake_embed)
    assert n_port == n_jax == 4
    for spk in ('spk_a', 'spk_b'):
        for i in range(2):
            a, b = (np.load(os.path.join(r, 'features', spk,
                                         f'utt_{i}.spk_emb.npy'))
                    for r in roots)
            assert a.shape == (192,) and a.dtype == np.float32
            assert np.array_equal(a, b)
    # existing files are kept unless asked
    assert ecapa.compute_ecapa_for_file_lists([lists[0]],
                                              embed_fn=_fake_embed) == 0
    wav_dir = os.path.join(roots[0], 'features', 'spk_a', 'wavs')
    assert np.array_equal(
        ecapa.average_embedding_from_wav_dir(wav_dir, embed_fn=_fake_embed),
        jax_ecapa.average_embedding_from_wav_dir(wav_dir,
                                                 embed_fn=_fake_embed))
    empty = tmp_path / 'empty'
    empty.mkdir()
    with pytest.raises(ValueError, match='no wav files'):
        ecapa.average_embedding_from_wav_dir(str(empty), embed_fn=_fake_embed)


def test_ecapa_without_speechbrain_raises_the_same_error():
    try:
        import speechbrain  # noqa: F401
        pytest.skip('speechbrain is installed')
    except ImportError:
        pass
    with pytest.raises(ImportError, match='speechbrain is required'):
        ecapa.average_embedding_from_wav_dir('/nonexistent', device='cpu')
    with pytest.raises(ImportError, match='speechbrain is required'):
        jax_ecapa.average_embedding_from_wav_dir('/nonexistent')


def test_plot_1d_overlay_writes_a_png(tmp_path):
    path = str(tmp_path / 'pitch.png')
    plot_1d_overlay([np.sin(np.arange(50) / 5), np.arange(50) / 50],
                    labels=['gt', 'pred'], filename=path, title='pitch')
    with open(path, 'rb') as f:
        assert f.read(8) == b'\x89PNG\r\n\x1a\n'

"""The port's synthesis entry point (daft_exprt_torch/generate.py:
``generate_mel_specs`` through ``Synthesizer`` and a vocoder) against the
JAX package's, at test_torch_acoustic.py's small acoustic width with a
small float32 HiFi-GAN, on the CPU, three utterances of different lengths
at the entry point's default batch size of 1.

Bands: the host prosody transforms (durations, integer durations, energy,
pitch) exactly equal; mels max-abs 1e-3 (``test_inference_matches_jax_f32``);
the float32 vocoder's waveforms rel-L2 2e-3 (the bf16 tier's band against
the JAX wrapper, tests/test_torch_hifigan.py) from the written wav files.
"""
import copy
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax

from daft_exprt_tpu import generate as jgen
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch import generate as tgen
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.frontend.duration import duration_to_integer
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.models import hifigan as th
from daft_exprt_torch.utils import chunker

from tests.test_torch_acoustic import HP_KW, SMALL, _jax_model, _port_model
from tests.torch_port_utils import max_abs, rel_l2, to_numpy

STATS = {'spk 0': {'energy': {'mean': 0.8, 'std': 1.7},
                   'pitch': {'mean': 5.1, 'std': 0.25}},
         'spk 1': {'energy': {'mean': 1.2, 'std': 2.1},
                   'pitch': {'mean': 4.7, 'std': 0.31}}}
VOC_CFG = {'sampling_rate': 22050, 'upsample_rates': [2, 2],
           'upsample_kernel_sizes': [4, 4], 'upsample_initial_channel': 64,
           'resblock': '1', 'resblock_kernel_sizes': [3],
           'resblock_dilation_sizes': [[1, 3]], 'model_in_dim': 80}


def _inputs(hp, seed=0):
    """Three sentences (phone groups and punctuation) of different lengths
    with external prosody, speaker ids and per-sentence factors."""
    rng = np.random.RandomState(seed)
    phones = [s for s in hp.symbols if s[0].isalpha()]
    sentences, prosody = [], []
    for n_words in (3, 7, 5):
        sent = []
        for w in range(n_words):
            sent.append([phones[i] for i in rng.randint(0, len(phones),
                                                        rng.randint(2, 5))])
            sent.append(' ' if w < n_words - 1 else '.')
        n = sum(len(x) if isinstance(x, list) else 1 for x in sent)
        frames = rng.randint(2, 9, n).astype(np.float64)
        frames[rng.rand(n) < 0.1] = 0.0
        energy = rng.rand(n) * 3.0
        pitch = np.where(rng.rand(n) < 0.3, 0.0, 100.0 + rng.rand(n) * 150.0)
        sentences.append(sent)
        prosody.append({'symbols': list(range(n)), 'durations_frames': frames,
                        'energy': energy, 'pitch': pitch})
    n_sym = [len(p['symbols']) for p in prosody]
    dur = [None, list(1.0 + 0.2 * rng.randn(n_sym[1])), None]
    f0 = [list(rng.randn(k) * 10.0) for k in n_sym]
    return dict(sentences=sentences, file_names=['a', 'b', 'c'],
                speaker_ids=[0, 1, 1], dur_factors=dur,
                pitch_factors=['add', f0], external_prosody=prosody,
                source_stats={'energy': {'mean': 1.5, 'std': 0.9},
                              'pitch': {'mean': 170.0, 'std': 40.0}},
                alpha_dur=1.2, alpha_pitch=0.9, alpha_energy=1.1,
                external_embeddings=rng.randn(
                    hp.external_emb_dim).astype(np.float32),
                external_accent_emb=rng.randn(
                    SMALL['hidden_embed_dim']).astype(np.float32))


@pytest.mark.parametrize('transform', ['add', 'multiply'])
def test_generate_mel_specs_matches_jax(tmp_path, transform):
    hp_j, jmodel, params = _jax_model('float32', True)
    hp_j.stats = STATS
    hp_t, tmodel = _port_model('float32', True, params)
    hp_t.stats = STATS
    jvp = jh.init_generator_params(jax.random.PRNGKey(5), VOC_CFG, std=0.1)
    j_voc = jh.HiFiGanVocoder(params=jvp, config=VOC_CFG, fast=False)
    t_voc = th.HiFiGanVocoder(generator_from_jax(to_numpy(jvp)), VOC_CFG,
                              fast=False, device='cpu')
    kw = _inputs(hp_j)
    if transform == 'multiply':
        kw['pitch_factors'] = ['multiply', [None, [1.5] * len(
            kw['external_prosody'][1]['symbols']), None]]
    outs = {}
    for name, synth, hp in (
            ('jax', jgen.Synthesizer(jmodel, params, hp_j, vocoder=j_voc),
             hp_j),
            ('torch', tgen.Synthesizer(tmodel, hp_t, vocoder=t_voc), hp_t)):
        out_dir = str(tmp_path / name)
        outs[name] = (out_dir, (
            jgen if name == 'jax' else tgen).generate_mel_specs(
                synth, output_dir=out_dir, hparams=hp, batch_size=1,
                get_time_perf=True, save_outputs=True, **copy.deepcopy(kw)))
    (j_dir, j), (t_dir, t) = outs['jax'], outs['torch']
    assert sorted(j) == sorted(t) == ['__rtf__', 'a_spk_0', 'b_spk_1',
                                      'c_spk_1']
    assert t['__rtf__'] > 0
    for key in ('a_spk_0', 'b_spk_1', 'c_spk_1'):
        for jv, tv in zip(j[key][:4], t[key][:4]):
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv), key
        assert t[key][4].shape == j[key][4].shape
        assert max_abs(t[key][4], j[key][4]) < 1e-3
        assert max_abs(t[key][5], j[key][5]) < 1e-5
    assert len({t[k][4].shape[1] for k in ('a_spk_0', 'b_spk_1',
                                            'c_spk_1')}) == 3
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    assert len(os.listdir(t_dir)) == 9                 # npz, png, wav each
    for key in ('a_spk_0', 'b_spk_1', 'c_spk_1'):
        jm = np.load(os.path.join(j_dir, key + '.npz'))['mel_spec']
        tm = np.load(os.path.join(t_dir, key + '.npz'))['mel_spec']
        assert max_abs(tm, jm) < 1e-3
        sr_j, jw = wavfile.read(os.path.join(j_dir, key + '.wav'))
        sr_t, tw = wavfile.read(os.path.join(t_dir, key + '.wav'))
        assert sr_j == sr_t and tw.dtype == jw.dtype == np.int16
        assert tw.shape == jw.shape == (t[key][4].shape[1] * 4,)
        assert np.abs(jw).max() > 100
        assert rel_l2(tw, jw) <= 2e-3


def test_host_helpers_match_jax():
    hp = HyperParams(**HP_KW)
    hp_j = JaxHParams(**HP_KW)
    rng = np.random.RandomState(2)
    for trial in range(5):
        d = rng.rand(12) * 0.1 + 0.02
        segs = [[float(a), float(b)] for a, b in
                zip(np.cumsum(np.r_[0, d[:-1]]), np.cumsum(d))]
        from daft_exprt_tpu.frontend.duration import (
            duration_to_integer as j_dti)
        assert duration_to_integer([list(s) for s in segs], hp) == \
            j_dti([list(s) for s in segs], hp_j)
    preds = rng.rand(3, 9) * 0.08
    for a, b in zip(tgen.get_int_durations(preds, hp),
                    jgen.get_int_durations(preds, hp_j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pitch = np.where(rng.rand(2, 9) < 0.3, 0.0, rng.randn(2, 9))
    fac = rng.randn(2, 9) * 20.0
    hp.stats = hp_j.stats = STATS
    assert np.array_equal(tgen.pitch_shift(pitch, fac, hp, [0, 1]),
                          jgen.pitch_shift(pitch, fac, hp_j, [0, 1]))
    assert np.array_equal(tgen.pitch_multiply(pitch, [1.5, -1.0]),
                          jgen.pitch_multiply(pitch, [1.5, -1.0]))
    vals = np.where(rng.rand(20) < 0.2, 0.0, rng.rand(20) * 5.0)
    for src in (None, {'mean': 2.0, 'std': 0.5}):
        assert np.array_equal(
            tgen.normalize_external_feature(vals, vals == 0.0,
                                            {'mean': 1.0, 'std': 2.0}, src),
            jgen.normalize_external_feature(vals, vals == 0.0,
                                            {'mean': 1.0, 'std': 2.0}, src))
    kw = _inputs(hp_j)
    args = (kw['sentences'], [None] * 3, [None] * 3, [None] * 3, 'multiply',
            [0, 1, 1], ['a', 'b', 'c'])
    got = tgen.collate_for_synthesis(*args, hp, kw['external_prosody'])
    want = jgen.collate_for_synthesis(*args, hp_j, kw['external_prosody'])
    assert got[6] == want[6] == ['b', 'c', 'a']
    for a, b in zip(got[:6], want[:6]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [e['symbols'] for e in got[7]] == [e['symbols'] for e in want[7]]
    assert [list(c) for c in chunker(list(range(7)), 3)] == \
        [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(ValueError, match='Target speaker stats std'):
        tgen.normalize_external_feature(vals, vals == 0.0,
                                        {'mean': 1.0, 'std': 0.0})

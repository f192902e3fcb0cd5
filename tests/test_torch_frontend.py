"""The port's audio front end (daft_exprt_torch/frontend/{audio,duration,
markers,extract_features}.py, data/sets.py and
generate.py::extract_reference_parameters) against the JAX package's on
the CPU, on a small synthetic corpus (tests/test_frontend.py's utterance
and three more like it: pulse trains through a resonator at known F0s).

Bands: WAV reading and resampling, the shortest phone, the markers, the
duration tracks and the set lists equal; the mel max-abs 1e-3 (as
tests/test_torch_mel.py); the energy tracks within one step of their
3-decimal text (the mel's float32 differences can move a value across a
rounding boundary); the F0 tracks equal on >= 99% of lines; stats.json
within 1e-6 of JAX's on the same features.
"""
import json
import logging
import os

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import lfilter

from daft_exprt_tpu.data import sets as jsets
from daft_exprt_tpu.frontend import audio as jaudio
from daft_exprt_tpu.frontend import extract_features as jef
from daft_exprt_tpu.frontend import pitch as jfp
from daft_exprt_tpu.frontend.duration import \
    get_min_phone_duration as j_min_phone
from daft_exprt_tpu.frontend.markers import update_markers as j_update
from daft_exprt_tpu.generate import \
    extract_reference_parameters as j_reference
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_torch.data import sets as tsets
from daft_exprt_torch.frontend import audio as taudio
from daft_exprt_torch.frontend import extract_features as tef
from daft_exprt_torch.frontend import pitch as tfp
from daft_exprt_torch.frontend.duration import get_min_phone_duration
from daft_exprt_torch.frontend.markers import update_markers
from daft_exprt_torch.generate import extract_reference_parameters
from daft_exprt_torch.hparams import HyperParams

from tests.test_frontend import CASES, build_marker_lines
from tests.torch_port_utils import max_abs, one_torch_thread

SR = 22050
SPEAKERS = ['speaker_a', 'speaker_b']
# (speaker, name, F0 in Hz); speaker_a's first is test_frontend.py's
CORPUS = [('speaker_a', 'utt1', 140), ('speaker_a', 'utt2', 190),
          ('speaker_b', 'utt1', 230), ('speaker_b', 'utt2', 110)]
PHONES = [(0.20, 0.45, 'HH', 'hello', '0'),
          (0.45, 0.70, 'OW1', 'hello', '0'),
          (0.70, 0.90, 'SIL', '<sil>', '1'),
          (0.90, 1.30, 'W', 'world', '2'),
          (1.30, 1.70, 'D', 'world', '2')]


def hp_kw(**kw):
    return dict(dict(verbose=False, training_files='x', validation_files='x',
                     output_directory='/nonexistent', language='english',
                     speakers=['spk']), **kw)


def voice(f0, n=int(1.8 * SR), begin=0.2, end=1.7, sr=SR):
    """tests/test_frontend.py's 'hello world': silence, then a pulse train
    at ``f0`` through a 500 Hz resonator."""
    sig = np.zeros(n)
    idx = np.arange(int(begin * sr), int(end * sr), sr / f0).astype(int)
    sig[idx] = 1.0
    sig = lfilter([1.0], [1, -1.8 * np.cos(2 * np.pi * 500 / sr), 0.81], sig)
    return (sig / (np.abs(sig).max() * 1.3)).astype(np.float32)


def write_corpus(root):
    dataset = root / 'dataset'
    for spk in SPEAKERS:
        for sub in ('wavs', 'align'):
            (dataset / spk / sub).mkdir(parents=True)
    for spk, name, f0 in CORPUS:
        taudio.save_wav(str(dataset / spk / 'wavs' / f'{name}.wav'),
                        voice(f0), SR)
        with open(dataset / spk / 'align' / f'{name}.markers', 'w') as f:
            f.writelines(f'{b:.3f}\t{e:.3f}\t{p}\t{w}\t{wi}\n'
                         for b, e, p, w, wi in PHONES)
        (dataset / spk / 'align' / f'{name}.lab').write_text('hello world')
    for spk in SPEAKERS:
        (dataset / spk / 'metadata.csv').write_text(
            ''.join(f'{name}|hello world\n' for s, name, _ in CORPUS
                    if s == spk))
    return dataset


@pytest.fixture(scope='module')
def extracted(tmp_path_factory):
    """The corpus extracted by both packages (the card's tracker; the
    port on the CPU), in two feature trees."""
    root = tmp_path_factory.mktemp('corpus')
    dataset = write_corpus(root)
    with one_torch_thread():
        got = tef.extract_features(
            str(dataset), str(root / 'port'),
            HyperParams(**hp_kw(speakers=SPEAKERS)), pitch_method='device',
            device='cpu')
    jef.extract_features(str(dataset), str(root / 'jax'),
                         JaxHParams(**hp_kw(speakers=SPEAKERS)),
                         pitch_method='device')
    return root, got


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_load_wav_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.9, 0.9, 2000)
    cases = {'int16': (x * 32767).astype(np.int16),
             'int32': (x * 2 ** 31).astype(np.int32),
             'float32': x.astype(np.float32),
             'stereo': np.stack([x, -0.5 * x], 1).astype(np.float32)}
    for name, data in cases.items():
        path = str(tmp_path / f'{name}.wav')
        wavfile.write(path, SR, data)
        got, sr = taudio.load_wav(path)
        want, jsr = jaudio.load_wav(path)
        assert sr == jsr == SR and got.dtype == np.float32
        assert np.array_equal(got, want), name
        assert np.abs(got).max() <= 1.0
    path = str(tmp_path / 'hi.wav')
    wavfile.write(path, 44100, cases['int16'])
    got, sr = taudio.load_wav(path, target_sr=SR)
    want, _ = jaudio.load_wav(path, target_sr=SR)
    assert sr == SR and got.shape == (1000,)
    assert np.array_equal(got, want)
    with pytest.raises(TypeError):
        taudio.rescale_wav_to_float32(np.zeros(3, np.int64))


def test_min_phone_duration_matches_jax():
    lines = [f'{b:.3f}\t{e:.3f}\t{p}\t{w}\t{i}\n' for b, e, p, w, i in PHONES]
    assert get_min_phone_duration(lines) == j_min_phone(lines) == \
        pytest.approx(0.2)
    assert get_min_phone_duration(lines, 0.1) == j_min_phone(lines, 0.1)
    assert get_min_phone_duration([]) == j_min_phone([]) == 1000.0


@pytest.mark.parametrize('case_idx', range(len(CASES)))
def test_update_markers_matches_jax(case_idx):
    sentence, words_phones, sil_after = CASES[case_idx]
    lines = build_marker_lines(words_phones, sil_after=sil_after)
    sent_begin = float(lines[0].split('\t')[0])
    durs = list(range(3, 3 + len(lines)))
    got = update_markers('t', list(lines), sentence, sent_begin, list(durs),
                         HyperParams(**hp_kw()))
    want = j_update('t', list(lines), sentence, sent_begin, list(durs),
                    JaxHParams(**hp_kw()))
    assert got is not None and got == want
    assert got[-1][3] == '~'
    lines = build_marker_lines([('goodbye', ['G', 'UH1', 'D'])])
    assert update_markers('t', list(lines), 'hello', 0.37, [1, 2, 3],
                          HyperParams(**hp_kw()),
                          logging.getLogger('quiet')) is None


def test_extract_features_matches_jax(extracted):
    root, got = extracted
    assert got == {spk: [n for s, n, _ in CORPUS if s == spk]
                   for spk in SPEAKERS}
    for spk, name, f0 in CORPUS:
        port = root / 'port' / spk / name
        jax_ = root / 'jax' / spk / name
        mel, jmel = np.load(f'{port}.npy'), np.load(f'{jax_}.npy')
        assert mel.shape == jmel.shape and mel.shape[0] == 80
        assert max_abs(mel, jmel) < 1e-3
        assert _lines(f'{port}.markers') == _lines(f'{jax_}.markers')
        markers = [line.split('\t') for line in _lines(f'{port}.markers')]
        assert sum(int(m[2]) for m in markers) == mel.shape[1]
        for track in ('frames_nrg', 'symbols_nrg'):
            a = np.loadtxt(f'{port}.{track}')
            b = np.loadtxt(f'{jax_}.{track}')
            assert a.shape == b.shape and np.abs(a - b).max() <= 1.0011e-3
        for track in ('frames_f0', 'symbols_f0'):
            a, b = _lines(f'{port}.{track}'), _lines(f'{jax_}.{track}')
            assert len(a) == len(b)
            assert np.mean([x == y for x, y in zip(a, b)]) >= 0.99
        f0_track = np.loadtxt(f'{port}.frames_f0')
        assert len(f0_track) == mel.shape[1]
        voiced = f0_track[f0_track > 0]
        assert abs(np.exp(np.median(voiced)) - f0) / f0 < 0.08
    for spk in SPEAKERS:
        cfg = root / 'port' / spk / 'config.json'
        assert json.loads(cfg.read_text())['speakers'] == SPEAKERS
    hp = HyperParams(**hp_kw(speakers=SPEAKERS))
    assert tef.check_features_config_used(str(root / 'port'), hp) is True
    hp.min_f0 = 50
    assert tef.check_features_config_used(str(root / 'port'), hp) is False
    # a second call finds every file done
    with one_torch_thread():
        again = tef.extract_features(
            str(root / 'dataset'), str(root / 'port'),
            HyperParams(**hp_kw(speakers=SPEAKERS)), pitch_method='device',
            device='cpu')
    assert again == {spk: [] for spk in SPEAKERS}


def test_sets_and_stats_match_jax(extracted):
    root, _ = extracted
    out = {}
    for pkg, sets_mod, HP in (('port', tsets, HyperParams),
                              ('jax', jsets, JaxHParams)):
        hp = HP(**hp_kw(speakers=SPEAKERS,
                        training_files=str(root / pkg / 'lists' / 'train.txt'),
                        validation_files=str(root / pkg / 'lists' / 'val.txt')))
        sets_mod.create_sets(str(root / 'port'), hp,
                             proportion_validation=50.0)
        stats = sets_mod.extract_features_stats(hp)
        path = sets_mod.save_stats(stats, str(root / pkg / 'stats'))
        out[pkg] = (hp, json.loads(open(path).read()))
    for name in ('train.txt', 'val.txt'):
        assert _lines(root / 'port' / 'lists' / name) == \
            _lines(root / 'jax' / 'lists' / name)
    assert len(_lines(root / 'port' / 'lists' / 'train.txt')) == 2
    got, want = out['port'][1], out['jax'][1]
    assert sorted(got) == sorted(want) == ['spk 0', 'spk 1', 'symbols']

    def leaves(d, prefix=()):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    g, w = list(leaves(got)), list(leaves(want))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), k


def test_extract_reference_parameters_matches_jax(tmp_path):
    wav = np.concatenate([voice(160, n=int(1.2 * SR), begin=0.05, end=1.15),
                          np.zeros(300, np.float32)])
    path = str(tmp_path / 'ref.wav')
    taudio.save_wav(path, wav, SR)
    with one_torch_thread():
        got = extract_reference_parameters(
            path, str(tmp_path / 'port'), HyperParams(**hp_kw()),
            pitch_extractor=lambda w, sr, hp: tfp.extract_pitch(
                w, sr, hp, method='device', device='cpu'), device='cpu')
    want = j_reference(
        path, str(tmp_path / 'jax'), JaxHParams(**hp_kw()),
        pitch_extractor=lambda w, sr, hp: jfp.extract_pitch(
            w, sr, hp, method='device'))
    assert os.path.basename(got) == 'ref.npz'
    g, w = np.load(got), np.load(want)
    assert sorted(g.files) == sorted(w.files) == ['energy', 'mel_spec',
                                                  'pitch']
    T = g['mel_spec'].shape[1]
    assert len(g['energy']) == len(g['pitch']) == T
    assert g['mel_spec'].shape == w['mel_spec'].shape
    assert max_abs(g['mel_spec'], w['mel_spec']) < 1e-3
    np.testing.assert_allclose(g['energy'], w['energy'], rtol=1e-5)
    assert np.mean(g['pitch'] == w['pitch']) >= 0.99
    # an existing npz is kept
    assert extract_reference_parameters(
        path, str(tmp_path / 'port'), HyperParams(**hp_kw()),
        pitch_extractor=lambda *a: 1 / 0, device='cpu') == got

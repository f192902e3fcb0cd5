"""The traffic generators: a seed repeats its draws, and the draws follow
the mixes' stated distributions."""
import json

import numpy as np
import pytest

from tinybench import REPO, harness

PKG = REPO / 'portbench'


def _mod(name):
    h = harness(REPO)
    return h.load_module(PKG / 'gen' / f'{name}.py')


def _mix(name):
    return json.loads((PKG / 'traffic' / f'{name}.json').read_text())


@pytest.mark.parametrize('traffic', ['batch-synth.b128', 'batch-synth.b512'])
def test_utterances_repeat_and_follow_the_mix(traffic):
    gen, mix = _mod('utterances'), _mix(traffic)
    seed = 2 ** 31 + 977
    a = gen.Utterances(mix, seed, 76, 192, 128, 256, 22050, stream=3)
    b = gen.Utterances(mix, seed, 76, 192, 128, 256, 22050, stream=3)
    other = gen.Utterances(mix, seed + 1, 76, 192, 128, 256, 22050, stream=3)
    frames, per_symbol = [], []
    for _ in range(8):
        x, y, z = a.batch(), b.batch(), other.batch()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x['durations_int'].sum(1),
                                  z['durations_int'].sum(1))
        assert x['symbols'].shape[0] == mix['batch']
        for i in range(mix['batch']):
            n = x['input_lengths'][i]
            dur = x['durations_int'][i]
            assert (dur[:n] >= 1).all() and (dur[n:] == 0).all()
            assert (x['symbols'][i, :n] >= 1).all()
            assert (x['symbols'][i, :n] < 76).all()
            np.testing.assert_allclose(x['duration_preds'][i],
                                       dur * 256 / 22050, rtol=1e-6)
            frames.append(dur.sum())
            per_symbol.append(dur.sum() / n)
        assert len({tuple(r) for r in x['spk_embs']}) <= mix['speakers']
        assert len({tuple(r) for r in x['accent_emb']}) <= mix['accents']
    frames = np.array(frames)
    lo, hi = mix['frames']
    assert frames.min() >= lo and frames.max() <= hi
    # the maximum-entropy law on the range with the mix's mean: the mean
    # and the CDF at its deciles within four standard errors (a law on
    # [lo, hi] has sd at most (hi - lo) / 2)
    n = len(frames)
    assert abs(frames.mean() - mix['frames_mean']) < 4 * (hi - lo) / 2 / \
        np.sqrt(n)
    k = gen.maxent_rate((mix['frames_mean'] - lo) / (hi - lo))
    for q in np.linspace(0.1, 0.9, 9):
        x = lo + q * (hi - lo)
        law = np.expm1(k * q) / np.expm1(k)
        assert abs((frames <= x).mean() - law) < 4 * np.sqrt(
            law * (1 - law) / n) + 1 / (hi - lo)
    # L = round(T / u): T / L lies within u's range widened by the
    # rounding, at most half a symbol of the shortest utterance's
    ps = np.array(per_symbol)
    u_lo, u_hi = mix['frames_per_symbol']
    assert ps.min() >= u_lo / (1 + 0.5 * u_lo / lo)
    assert ps.max() <= u_hi / (1 - 0.5 * u_hi / lo)


@pytest.mark.parametrize('mean', [0.2, 0.5, 0.6072, 0.9])
def test_maxent_rate_gives_the_mean(mean):
    gen = _mod('utterances')
    k = gen.maxent_rate(mean)
    x = np.linspace(0, 1, 200001)
    w = np.exp(k * (x - 1))
    assert abs((x * w).sum() / w.sum() - mean) < 1e-4
    assert (k > 0) == (mean > 0.5)


def test_utterances_warmup_shapes():
    gen, mix = _mod('utterances'), _mix('batch-synth.b128')
    g = gen.Utterances(mix, 5, 76, 192, 128, 256, 22050, stream=2)
    for frames, symbols in mix['warmup_shapes']:
        x = g.batch(first=(frames, symbols))
        assert x['durations_int'].sum(1).max() == frames
        assert x['input_lengths'].max() == symbols


def test_segments_repeat_and_follow_the_mix():
    gen, mix = _mod('segments'), _mix('gan-segments.b16')
    seed = 2 ** 31 + 31
    x = gen.Segments(mix, seed, 1).batch()
    np.testing.assert_array_equal(x, gen.Segments(mix, seed, 1).batch())
    assert not np.array_equal(x, gen.Segments(mix, seed, 2).batch())
    assert x.shape == (mix['batch'], 1, mix['segment'])
    assert x.dtype == np.float32
    peak = np.abs(x).max(axis=-1)
    assert (peak < 1 / 1.3 + 10 * mix['noise']).all()
    assert (peak > 1 / 1.3 - 10 * mix['noise']).all()
    # the pulse spacing follows F0: the spectrum's strongest line below
    # the formant lies at a harmonic of an F0 inside the mix's range
    g = gen.Segments(mix, seed, 4)
    for _ in range(4):
        y = g.segment()
        spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
        freqs = np.fft.rfftfreq(len(y), 1 / 22050)
        ac = np.correlate(y, y, 'full')[len(y) - 1:]
        lag_lo = int(22050 / mix['f0'][1])
        lag = lag_lo + int(np.argmax(ac[lag_lo:int(22050 / mix['f0'][0]) + 2]))
        assert mix['f0'][0] - 2 <= 22050 / lag <= mix['f0'][1] + 2
        assert spec[freqs > 20].max() > 0

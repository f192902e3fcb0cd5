"""The port's pitch tracker (daft_exprt_torch/ops/pitch.py and
frontend/pitch.py) against the JAX package's on the CPU.

Bands: the FIR taps equal; the NCCF rel-L2 1e-5 (the port computes it in
float64 from the same float32 signal); ``_cummin_arg`` and both Viterbi
forms exactly JAX's states on the same scores, ties included (scores on a
grid of 1/8 make many); ``frame_f0`` on glottal signals at three F0s
equal to JAX's on >= 99% of frames; ``batched_frame_f0`` equal to the
single calls; the per-sample and per-frame protocols equal to JAX's.
"""
import stat
import sys
import tempfile

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

import jax.numpy as jnp

from daft_exprt_tpu.frontend import pitch as jfp
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.ops import pitch as jp
from daft_exprt_torch.frontend import pitch as tfp
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.ops import pitch as tp

from tests.torch_port_utils import one_torch_thread, rel_l2

SR = 22050
HP_KW = dict(verbose=False, training_files='x', validation_files='x',
             output_directory='/nonexistent', language='english',
             speakers=['s'])


def glottal_signal(f0hz, dur=1.0, sr=SR):
    """Impulse train through two resonators (voice-like), as
    tests/test_pitch.py makes it."""
    n = int(sr * dur)
    sig = np.zeros(n)
    idx = np.arange(0, n, sr / f0hz).astype(int)
    sig[idx[idx < n]] = 1.0
    sig = lfilter([1.0], [1, -1.8 * np.cos(2 * np.pi * 500 / sr), 0.81], sig)
    sig = lfilter([1.0], [1, -1.9 * np.cos(2 * np.pi * 1500 / sr), 0.92], sig)
    return (sig / (np.abs(sig).max() * 1.2)).astype(np.float32)


@pytest.fixture(scope='module')
def trackers():
    return (tp.PitchTracker(HyperParams(**HP_KW), device='cpu'),
            jp.PitchTracker(JaxHParams(**HP_KW)))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def test_highpass_fir_equals_jax():
    for sr in (16000, 22050, 44100):
        assert np.array_equal(tp._highpass_fir(sr), jp._highpass_fir(sr))


def test_nccf_matches_jax(trackers):
    t, j = trackers
    rng = np.random.RandomState(0)
    wav = glottal_signal(170, dur=0.4) + (0.01 * rng.randn(int(0.4 * SR))
                                          ).astype(np.float32)
    xj, n_frames, msj = j._prepare(jnp.asarray(wav)[None])
    xt, n_t, mst = t._prepare(torch.from_numpy(wav)[None])
    assert n_t == n_frames and xt.shape == xj.shape
    # the highpass: a true convolution, float64 rounded against float32
    assert rel_l2(xt[0].numpy(), np.asarray(xj[0])) < 1e-6
    assert abs(float(mst[0]) - float(msj[0])) <= 1e-6 * float(msj[0])
    a_fact = t.a_coef * t.win * float(msj[0])
    want = np.asarray(jp._nccf(xj[0], t.frame_step, t.win, t.min_lag,
                               t.max_lag, n_frames, a_fact=a_fact))
    got = tp._nccf(torch.tensor(np.asarray(xj)).double(), t.frame_step,
                   t.win, t.min_lag, t.max_lag, n_frames,
                   a_fact=a_fact)[0].float().numpy()
    assert got.shape == want.shape == (n_frames, t.n_lags)
    # rel-L2: JAX's float32 cumulative sums lose up to ~5e-5 of a score
    # where the lagged energy is small (the float64 port does not)
    assert rel_l2(got, want) < 1e-5


def test_cummin_arg_keeps_the_earlier_index_on_a_tie():
    vals = np.array([3, 1, 1, 2, 1, 0.5, 0.5], np.float32)
    idx = np.arange(len(vals))
    for carrier in (idx, idx[::-1].copy()):
        jv, ji = jp._cummin_arg(jnp.asarray(vals), jnp.asarray(carrier))
        tv, ti = tp._cummin_arg(torch.from_numpy(vals),
                                torch.from_numpy(carrier))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ti.numpy(), carrier[[0, 1, 1, 1, 1, 5, 5]])
    # torch.cummin alone keeps the later index
    assert torch.cummin(torch.from_numpy(vals), 0).indices.tolist() == \
        [0, 1, 2, 2, 4, 5, 6]
    # rows of many ties, a carrier shared by every row
    rng = np.random.RandomState(1)
    vals = (rng.randint(0, 5, (6, 40)) / 4.0).astype(np.float32)
    carrier = rng.permutation(40)
    jv, ji = jp._cummin_arg(jnp.asarray(vals),
                            jnp.broadcast_to(jnp.asarray(carrier), vals.shape))
    tv, ti = tp._cummin_arg(torch.from_numpy(vals), torch.from_numpy(carrier))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def _lag_tables(n_lags, first=20):
    lags = np.arange(first, first + n_lags).astype(np.float64)
    log_lags = np.log(lags).astype(np.float32)
    trans = np.abs(np.log(lags[:, None] / lags[None, :])).astype(np.float32)
    return log_lags, trans


@pytest.mark.parametrize('scores', ['continuous', 'tied'])
def test_viterbi_states_equal_jax(scores):
    rng = np.random.RandomState(3)
    n_lags, F, B = 37, 60, 3
    log_lags, trans = _lag_tables(n_lags)
    ncc = rng.uniform(-0.5, 1.0, (B, F, n_lags)).astype(np.float32)
    local_uv = rng.uniform(0.2, 1.0, (B, F)).astype(np.float32)
    if scores == 'tied':
        ncc = np.round(ncc * 8) / 8
        local_uv = np.round(local_uv * 8) / 8
    uv = np.float32(0.9)
    got_b = tp._viterbi(torch.from_numpy(ncc), torch.from_numpy(log_lags),
                        uv, n_lags, local_uv=torch.from_numpy(local_uv))
    dense_b = tp._viterbi_dense(torch.from_numpy(ncc),
                                torch.from_numpy(trans), uv, n_lags,
                                local_uv=torch.from_numpy(local_uv))
    for b in range(B):
        for lu in (None, local_uv[b]):
            jlu = None if lu is None else jnp.asarray(lu)
            tlu = None if lu is None else torch.from_numpy(lu)
            want = np.asarray(jp._viterbi(jnp.asarray(ncc[b]),
                                          jnp.asarray(log_lags), uv, n_lags,
                                          local_uv=jlu))
            got = tp._viterbi(torch.from_numpy(ncc[b]),
                              torch.from_numpy(log_lags), uv, n_lags,
                              local_uv=tlu).numpy()
            assert np.array_equal(got, want), (scores, b, lu is None)
            want_d = np.asarray(jp._viterbi_dense(
                jnp.asarray(ncc[b]), jnp.asarray(trans), uv, n_lags,
                local_uv=jlu))
            got_d = tp._viterbi_dense(torch.from_numpy(ncc[b]),
                                      torch.from_numpy(trans), uv, n_lags,
                                      local_uv=tlu).numpy()
            assert np.array_equal(got_d, want_d), (scores, b, lu is None)
            if scores == 'continuous':
                # exact ties aside, the envelope form is the dense one
                assert np.array_equal(got, got_d)
        # the batched pass steps every row at once, row for row the same
        assert np.array_equal(got_b[b].numpy(), np.asarray(jp._viterbi(
            jnp.asarray(ncc[b]), jnp.asarray(log_lags), uv, n_lags,
            local_uv=jnp.asarray(local_uv[b]))))
        assert np.array_equal(dense_b[b].numpy(), np.asarray(
            jp._viterbi_dense(jnp.asarray(ncc[b]), jnp.asarray(trans), uv,
                              n_lags, local_uv=jnp.asarray(local_uv[b]))))


def test_viterbi_on_the_trackers_scores(trackers):
    """Exact states on the scores of a real signal (509 lags)."""
    t, j = trackers
    wav = glottal_signal(140, dur=0.5)
    x, n_frames, ms = t._prepare(torch.from_numpy(wav)[None])
    ncc, local_uv = t._scores(x, n_frames, ms)
    got = tp._viterbi(ncc, t.log_lags, t.uv_cost, t.n_lags,
                      local_uv=local_uv)[0].numpy()
    want = np.asarray(jp._viterbi(jnp.asarray(ncc[0].numpy()), j.log_lags,
                                  jnp.float32(j.uv_cost), j.n_lags,
                                  local_uv=jnp.asarray(local_uv[0].numpy())))
    assert np.array_equal(got, want)
    assert (got < t.n_lags).mean() > 0.9


@pytest.mark.parametrize('f0', [120, 220, 330])
def test_frame_f0_matches_jax(trackers, f0):
    t, j = trackers
    wav = glottal_signal(f0)
    got, want = t.frame_f0(wav), np.asarray(j.frame_f0(wav))
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got == want).mean() >= 0.99
    voiced = got[got > 0]
    assert len(voiced) > 0.7 * len(got)
    assert abs(np.median(voiced) - f0) / f0 < 0.03


def test_batched_frame_f0_equals_single_calls(trackers):
    t, _ = trackers
    rng = np.random.RandomState(11)
    n = int(0.5 * SR)
    tt = np.arange(n) / SR
    wavs = np.stack([
        glottal_signal(120, dur=0.5),
        (0.4 * np.sin(2 * np.pi * 220 * tt)
         + 0.01 * rng.randn(n)).astype(np.float32),
        (0.02 * rng.randn(n)).astype(np.float32),
    ])
    batched = t.batched_frame_f0(wavs)
    assert isinstance(batched, torch.Tensor)
    assert batched.shape == (3, t.n_frames(n))
    for i in range(3):
        assert np.array_equal(batched[i].numpy(), t.frame_f0(wavs[i]))


def test_per_sample_and_frame_protocols_match_jax():
    hp, jhp = HyperParams(**HP_KW), JaxHParams(**HP_KW)
    wav = np.concatenate([glottal_signal(150, dur=0.6),
                          np.zeros(3000, np.float32),
                          glottal_signal(260, dur=0.5)])
    got = tfp.per_sample_f0_device(wav, SR, hp, device='cpu')
    want = jfp.per_sample_f0_device(wav, SR, jhp)
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == wav.shape
    assert (got == want).mean() >= 0.99
    assert set(np.unique(got[got <= 0])) <= {-1}
    got = tfp.extract_pitch(wav, SR, hp, method='device', device='cpu')
    want = jfp.extract_pitch(wav, SR, jhp, method='device')
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.99
    with pytest.raises(ValueError):
        tfp.extract_pitch(wav, SR, hp, method='crepe', device='cpu')


FAKE_TRACKER = '''#!{python}
"""Stands in for the native tracker: reads -i, writes -f as int16 F0 per
sample (-1 in the first tenth), and echoes its arguments to a log."""
import sys
import numpy as np
from scipy.io import wavfile
args = sys.argv[1:]
sr, wav = wavfile.read(args[args.index('-i') + 1])
f0 = np.full(len(wav), int(float(args[args.index('-m') + 1]) * 3), np.int16)
f0[:len(wav) // 10] = -1
with open(args[args.index('-f') + 1], 'wb') as f:
    f.write(f0.tobytes())
with open(sys.argv[0] + '.log', 'a') as f:
    f.write(' '.join(a for a in args if not a.endswith(('.wav', '.f0')))
            + '\\n')
'''


def test_native_protocol_matches_jax(tmp_path, monkeypatch):
    """Both packages call a tracker binary with the same arguments and
    read its int16 track the same way (a stand-in binary: the repo's
    native tracker is a build product)."""
    fake = tmp_path / 'daft-reaper'
    fake.write_text(FAKE_TRACKER.format(python=sys.executable))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    hp, jhp = HyperParams(**HP_KW), JaxHParams(**HP_KW)
    wav = glottal_signal(200, dur=0.3)
    got = tfp.per_sample_f0_native(wav, SR, hp, binary=str(fake))
    want = jfp.per_sample_f0_native(wav, SR, jhp, binary=str(fake))
    assert got.dtype == np.int16 and np.array_equal(got, want)
    assert len(got) == len(wav) and got[0] == -1 and got[-1] == 120
    log = (tmp_path / 'daft-reaper.log').read_text().splitlines()
    assert len(log) == 2 and log[0] == log[1]
    assert not list((tmp_path / 'daft_exprt_torch_reaper').iterdir())
    # 'auto' takes the binary where one is found, else the card's tracker
    for mod in (tfp, jfp):
        monkeypatch.setattr(mod, 'find_native_binary', lambda: str(fake))
    assert np.array_equal(
        tfp.extract_pitch(wav, SR, hp, device='cpu'),
        jfp.extract_pitch(wav, SR, jhp))
    for mod in (tfp, jfp):
        monkeypatch.setattr(mod, 'find_native_binary', lambda: None)
    got = tfp.extract_pitch(wav, SR, hp, device='cpu')
    want = jfp.extract_pitch(wav, SR, jhp)
    assert (got == want).mean() >= 0.99
    assert abs(np.exp(np.median(got[got > 0])) - 200) < 10

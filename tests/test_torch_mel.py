"""The port's log-mel extractor (daft_exprt_torch/ops/mel.py) and
Griffin-Lim (frontend/griffin_lim.py) against the JAX package's on the CPU.

Bands: the filterbank and DFT basis equal; the mel max-abs 1e-3 and mean
1e-5 (tests/test_mel.py's band against torch.stft; PARITY.md); ``batched``
the same on the valid frames and exactly log(min_clipping) past them;
``frame_energy`` rel 1e-5; ``mel_to_linear`` rel-L2 1e-4; Griffin-Lim with
JAX's initial phase injected rel-L2 1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.frontend import griffin_lim as jgl
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.ops import mel as jm
from daft_exprt_torch.frontend import griffin_lim as tgl
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.ops import mel as tm

from tests.torch_port_utils import max_abs, rel_l2

HP_KW = dict(verbose=False, training_files='x', validation_files='x',
             output_directory='/nonexistent', language='english',
             speakers=['s'])


@pytest.fixture(scope='module')
def extractors():
    return (tm.MelExtractor(HyperParams(**HP_KW), device='cpu'),
            jm.MelExtractor(JaxHParams(**HP_KW)))


def test_filterbank_and_basis_equal_jax():
    for args in ((22050, 1024, 80, 0, 8000), (16000, 512, 40, 50, 7600)):
        assert np.array_equal(tm.mel_filterbank(*args),
                              jm.mel_filterbank(*args))
    for n_fft in (512, 1024):
        for a, b in zip(tm._windowed_dft_basis(n_fft),
                        jm._windowed_dft_basis(n_fft)):
            assert np.array_equal(a, b)
    assert np.array_equal(tm._hann_periodic(1024), jm._hann_periodic(1024))


@pytest.mark.parametrize('n', [300, 9000, 40011])
def test_mel_matches_jax(extractors, n):
    t, j = extractors
    wav = (np.random.RandomState(n).randn(n) * 0.1).astype(np.float32)
    got, want = t(wav), np.asarray(j(wav))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (80, t.num_frames(n))
    assert max_abs(got, want) < 1e-3
    assert np.mean(np.abs(got - want)) < 1e-5


def test_batched_matches_jax(extractors):
    t, j = extractors
    rng = np.random.RandomState(5)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (5000, 33000, 300)]
    got, want = t.batched(wavs), np.asarray(j.batched(wavs))
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    got = got.numpy()
    floor = np.float32(np.log(t.min_clipping))
    for i, w in enumerate(wavs):
        n = t.num_frames(len(w))
        assert max_abs(got[i, :, :n], want[i, :, :n]) < 1e-3
        assert np.all(got[i, :, n:] == floor)
        assert np.all(want[i, :, n:] == floor)
        # each wav's own frames are its single call's
        assert max_abs(got[i, :, :n], t(w)) < 1e-4


def test_frame_energy_matches_jax():
    rng = np.random.RandomState(2)
    mel = rng.randn(80, 100).astype(np.float32)
    want = np.asarray(jm.frame_energy(mel))
    got = tm.frame_energy(mel, device='cpu')
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    batch = rng.randn(3, 80, 40).astype(np.float32)
    got = tm.frame_energy(torch.from_numpy(batch))
    assert isinstance(got, torch.Tensor) and got.shape == (3, 40)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(jm.frame_energy(batch[i])),
                                   rtol=1e-5)


def _tone_mel(hp_kw=HP_KW, n=6000):
    sr = 22050
    t = np.arange(n) / sr
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.05 * np.random.RandomState(0).randn(n)).astype(np.float32)
    return np.asarray(jm.MelExtractor(JaxHParams(**hp_kw))(wav))


def test_mel_to_linear_matches_jax():
    mel = _tone_mel()
    want = np.asarray(jgl.mel_to_linear(mel, JaxHParams(**HP_KW),
                                        nnls_iters=30))
    got = tgl.mel_to_linear(mel, HyperParams(**HP_KW), nnls_iters=30,
                            device='cpu')
    assert got.shape == want.shape == (513, mel.shape[1])
    assert rel_l2(got.numpy(), want) < 1e-4


def test_griffin_lim_matches_jax_with_its_phase():
    hp = HyperParams(**HP_KW)
    mag = np.asarray(jgl.mel_to_linear(_tone_mel(), JaxHParams(**HP_KW),
                                       nnls_iters=10))
    T = mag.shape[1]
    length = (T - 1) * hp.hop_length + hp.filter_length
    want = np.asarray(jgl._griffin_lim_core(jnp.asarray(mag), 1024, 256, 8,
                                            length))
    phase0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape))
    got = tgl._griffin_lim_core(torch.tensor(mag), 1024, 256, 8, length,
                                phase0=phase0).numpy()
    assert got.shape == want.shape == (length,)
    assert rel_l2(got, want) < 1e-3
    # the port's own phase (a torch.Generator, seed 0): a waveform all the
    # same, the tone's bin the loudest
    wav = tgl.griffin_lim_reconstruction_from_mel_spec(
        _tone_mel(n=22050), hp, n_iters=20, nnls_iters=10, device='cpu')
    assert np.isfinite(wav).all() and abs(np.abs(wav).max() - 0.95) < 1e-6
    spec = np.abs(np.fft.rfft(wav))
    assert abs(np.fft.rfftfreq(len(wav), 1 / 22050)[np.argmax(spec)]
               - 440) < 15

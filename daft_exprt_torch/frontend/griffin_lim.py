"""Vocoder-free waveform reconstruction: mel -> linear -> Griffin-Lim (port
of ``daft_exprt_tpu/frontend/griffin_lim.py``).

The mel inversion is a pinv projection refined by multiplicative NNLS
updates (matmuls); the Griffin-Lim loop runs the STFT and iSTFT as framed
``torch.fft.rfft`` / ``irfft`` with overlap-add by ``index_add_``, all on
the device of the input (a host array goes to ``device``, default cuda).

The initial phase cannot be JAX's (``jax.random.PRNGKey(0)``): it is drawn
from a ``torch.Generator`` (seed 0 unless one is passed), or injected as
``phase0``, fractions of a turn in [0, 1), so a caller can give it JAX's.
"""
import math

import numpy as np
import torch

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.ops.mel import _hann_periodic, mel_filterbank
from daft_exprt_torch.ops.vocoder_kernels import full_f32


def _on_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(np.asarray(x, dtype=np.float32),
                        device=resolve_device(device))


def mel_to_linear(mel_spec, hparams, nnls_iters=30, device=None):
    """Log-mel (n_mels, T) -> linear amplitude spectrogram (n_freq, T), a
    tensor on the input's device (a host array: on ``device``).

    pinv initialization + multiplicative-update NNLS refinement
    (|| M @ S - mel ||^2 with S >= 0)."""
    mel = torch.exp(_on_device(mel_spec, device))             # amplitude mels
    fb = torch.from_numpy(mel_filterbank(
        hparams.sampling_rate, hparams.filter_length, hparams.n_mel_channels,
        hparams.mel_fmin, hparams.mel_fmax)).to(mel.device)   # (n_mels, F)
    with full_f32():
        S = torch.clamp(torch.linalg.pinv(fb) @ mel, min=0.0) + 1e-6
        num = fb.T @ mel
        for _ in range(nnls_iters):
            den = fb.T @ (fb @ S) + 1e-8
            S = S * (num / den)
    return S


def _griffin_lim_core(mag, n_fft, hop, n_iters, length, phase0=None,
                      generator=None):
    """mag: (n_freq, T) float32 target amplitude on the device; returns the
    (length,) waveform there. ``phase0``: initial phase in turns, (n_freq,
    T), else uniform from ``generator`` (seed 0 if None)."""
    dev = mag.device
    window = torch.tensor(_hann_periodic(n_fft), dtype=torch.float32,
                          device=dev)
    T = mag.shape[1]
    idx = (torch.arange(T, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    # the window's overlap; only normalize where it has real mass —
    # dividing by the ~t^4 tail at the edges amplifies edge noise ~1/t^3
    # and the iteration feeds it back as low-frequency garbage
    win_sq = torch.zeros(length + n_fft, device=dev).index_add_(
        0, idx, (window * window).repeat(T))[:length]
    keep = win_sq > 1e-2
    win_sq = torch.clamp(win_sq, min=1e-2)

    def stft(x):
        frames = x[idx].reshape(T, n_fft) * window[None, :]
        return torch.fft.rfft(frames, dim=1).T               # (n_freq, T)

    def istft(spec):
        frames = torch.fft.irfft(spec.T, n=n_fft, dim=1) * window[None, :]
        x = torch.zeros(length + n_fft, device=dev).index_add_(
            0, idx, frames.reshape(-1))
        return torch.where(keep, x[:length] / win_sq,
                           torch.zeros_like(win_sq))

    if phase0 is None:
        gen = generator or torch.Generator().manual_seed(0)
        phase0 = torch.rand(mag.shape, generator=gen)
    if not isinstance(phase0, torch.Tensor):
        phase0 = torch.tensor(np.asarray(phase0))
    phase0 = phase0.to(dev, torch.float32)
    target = mag.to(torch.complex64)
    x = istft(target * torch.exp(2j * math.pi * phase0))
    for _ in range(n_iters):
        spec = stft(x)
        x = istft(target * (spec / torch.clamp(spec.abs(), min=1e-8)))
    return x


def reconstruct_signal_griffin_lim(magnitude, hparams, n_iters=60,
                                   device=None, phase0=None, generator=None):
    """Amplitude spectrogram (n_freq, T) -> host waveform, peak 0.95."""
    n_fft, hop = hparams.filter_length, hparams.hop_length
    mag = _on_device(magnitude, device)
    T = mag.shape[1]
    length = (T - 1) * hop + n_fft
    wav = _griffin_lim_core(mag, n_fft, hop, n_iters, length, phase0=phase0,
                            generator=generator).cpu().numpy()
    peak = np.abs(wav).max()
    if peak > 0:
        wav = wav / peak * 0.95
    return wav


def griffin_lim_reconstruction_from_mel_spec(mel_spec, hparams, n_iters=60,
                                             nnls_iters=30, device=None):
    """Log-mel (n_mels, T) -> host waveform."""
    linear = mel_to_linear(mel_spec, hparams, nnls_iters=nnls_iters,
                           device=device)
    return reconstruct_signal_griffin_lim(linear, hparams, n_iters=n_iters)

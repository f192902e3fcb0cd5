"""Log-mel extraction on the card (port of ``daft_exprt_tpu/ops/mel.py``).

The STFT is two dense matmuls against a windowed DFT basis (real and
imaginary), followed by the mel-filterbank matmul: reflect padding of
(n_fft - hop)/2 on both sides (center=False), periodic Hann window,
amplitude sqrt(re^2 + im^2 + 1e-9), mel projection, log-clamp at
min_clipping. The three matmuls run in full float32 (``full_f32``: no
TF32), as the JAX package asks for ``Precision.HIGHEST``.

The filterbank (Slaney mel scale and area normalisation, librosa's
default) and the DFT basis are built in numpy, as in the JAX package.

Reflect padding is done on the host with ``np.pad``: ``F.pad(...,
mode='reflect')`` refuses a pad as long as the input, and numpy (like
``jnp.pad``) reflects any length, so a wav shorter than
(n_fft - hop)/2 + 1 samples still gets the JAX package's frames.
"""
import numpy as np
import torch

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.ops.vocoder_kernels import full_f32

_MEL_HIGH_FREQ_Q = np.log(6.4) / 27.0
_MEL_BREAK_HZ = 1000.0
_MEL_FSP = 200.0 / 3.0


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mel = freq / _MEL_FSP
    log_region = freq >= _MEL_BREAK_HZ
    mel = np.where(
        log_region,
        _MEL_BREAK_HZ / _MEL_FSP + np.log(np.maximum(freq, 1e-10) / _MEL_BREAK_HZ) / _MEL_HIGH_FREQ_Q,
        mel,
    )
    return mel


def _mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    freq = mel * _MEL_FSP
    log_region = mel >= _MEL_BREAK_HZ / _MEL_FSP
    freq = np.where(
        log_region,
        _MEL_BREAK_HZ * np.exp(_MEL_HIGH_FREQ_Q * (mel - _MEL_BREAK_HZ / _MEL_FSP)),
        freq,
    )
    return freq


def mel_filterbank(sr, n_fft, n_mels, fmin, fmax):
    """Slaney-style triangular mel filterbank, shape (n_mels, 1 + n_fft//2)."""
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_min, mel_max = _hz_to_mel(fmin), _hz_to_mel(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]          # (n_mels+2, n_freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)

    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_periodic(n):
    # torch.hann_window default periodic=True
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float64)


def _windowed_dft_basis(n_fft):
    """Real/imag DFT basis with the Hann window folded in, (n_fft, n_freqs)."""
    n_freqs = 1 + n_fft // 2
    t = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_freqs)[None, :].astype(np.float64)
    phase = 2.0 * np.pi * t * k / n_fft
    win = _hann_periodic(n_fft)[:, None]
    basis_r = (np.cos(phase) * win).astype(np.float32)
    basis_i = (-np.sin(phase) * win).astype(np.float32)
    return basis_r, basis_i


def _mel_core(wav_padded, basis_r, basis_i, mel_fb_t, n_fft, hop,
              min_clipping):
    """wav_padded: (..., N) float32, already reflect-padded, on the device
    of the bases; returns (..., T, n_mels) log-mel, T = 1 + (N - n_fft) //
    hop. Frames are an index gather (a strided view), then the three
    matmuls in full float32."""
    frames = wav_padded.unfold(-1, n_fft, hop)                # (..., T, n_fft)
    with full_f32():
        re = torch.matmul(frames, basis_r)
        im = torch.matmul(frames, basis_i)
        spec = torch.sqrt(re * re + im * im + 1e-9)           # (..., T, n_freqs)
        mel = torch.matmul(spec, mel_fb_t)
    return torch.log(torch.clamp(mel, min=min_clipping))


class MelExtractor:
    """Log-mel extractor on ``device`` (default cuda; raises without CUDA
    unless ``device='cpu'``).

    ``__call__`` takes one host waveform and returns a host (n_mels, T)
    array, as the JAX extractor does; it computes exactly T frames (the
    JAX extractor pads to a bucket only to bound its recompiles).
    ``batched`` keeps the bucket: its frame axis is the JAX extractor's
    T_pad.
    """

    def __init__(self, hparams, device=None):
        self.device = resolve_device(device)
        self.n_fft = hparams.filter_length
        self.hop = hparams.hop_length
        self.sr = hparams.sampling_rate
        self.min_clipping = float(hparams.min_clipping)
        self.pad = (self.n_fft - self.hop) // 2
        self.bucket = self.hop * 128
        basis_r, basis_i = _windowed_dft_basis(self.n_fft)
        mel_fb = mel_filterbank(self.sr, self.n_fft, hparams.n_mel_channels,
                                hparams.mel_fmin, hparams.mel_fmax)
        self.basis_r, self.basis_i, self.mel_fb_t = (
            torch.tensor(a, device=self.device)
            for a in (basis_r, basis_i, mel_fb.T))

    def num_frames(self, n_samples):
        """Frame count for a waveform of ``n_samples`` (pre-padding)."""
        return 1 + (n_samples + 2 * self.pad - self.n_fft) // self.hop

    def _core(self, padded):
        return _mel_core(padded, self.basis_r, self.basis_i, self.mel_fb_t,
                         self.n_fft, self.hop, self.min_clipping)

    def _reflect(self, wav):
        return np.pad(np.asarray(wav, dtype=np.float32),
                      (self.pad, self.pad), mode='reflect')

    def _single(self, wav):
        """wav: float32 (n_samples,) -> (n_mels, T) log-mel on the device."""
        true_frames = self.num_frames(len(wav))
        padded = self._reflect(wav)
        if len(padded) < self.n_fft:       # fewer samples than one frame
            padded = np.pad(padded, (0, self.n_fft - len(padded)))
        mel = self._core(torch.from_numpy(padded).to(self.device))
        return mel[:max(true_frames, 0)].T

    def __call__(self, wav):
        """wav: float32 (n_samples,) in [-1, 1] -> host (n_mels, T) log-mel."""
        return self._single(wav).cpu().numpy()

    def with_energy(self, wav):
        """wav -> host (n_mels, T) log-mel and host (T,) ``frame_energy``,
        both from the one device result (one download each, no upload of
        the mel back to the card)."""
        mel = self._single(wav)
        return mel.cpu().numpy(), frame_energy(mel).cpu().numpy()

    def batched(self, wavs):
        """Variable-length host waveforms -> (B, n_mels, T_pad) float32 on
        the device. Each wav is reflect-padded on its own (its own tail is
        mirrored, not the batch's zeros), the batch is zero-padded to a
        multiple of the bucket (hop x 128 samples, the JAX extractor's) and
        runs as one call; frames past each wav's true frame count are
        pinned to log(min_clipping)."""
        true_frames = [self.num_frames(len(w)) for w in wavs]
        padded = [self._reflect(w) for w in wavs]
        max_len = max(len(p) for p in padded)
        total = -(-max_len // self.bucket) * self.bucket
        buf = np.zeros((len(padded), total), dtype=np.float32)
        for i, p in enumerate(padded):
            buf[i, :len(p)] = p
        mel = self._core(torch.from_numpy(buf).to(self.device))
        valid = (torch.arange(mel.shape[1], device=self.device)[None, :]
                 < torch.tensor(true_frames, device=self.device)[:, None])
        mel = torch.where(valid[..., None], mel,
                          torch.tensor(float(np.log(self.min_clipping)),
                                       device=self.device))
        return mel.transpose(1, 2)


def frame_energy(mel_spec, device=None):
    """Per-frame energy: L2 norm of the linear-scale mel bins over the mel
    axis, (..., n_mels, T) -> (..., T). A tensor stays on its device and
    gives a tensor; a host array is computed on ``device`` (default cuda)
    and comes back as a host array."""
    if isinstance(mel_spec, torch.Tensor):
        return torch.linalg.vector_norm(torch.exp(mel_spec), dim=-2)
    mel = torch.tensor(np.asarray(mel_spec, dtype=np.float32),
                       device=resolve_device(device))
    return torch.linalg.vector_norm(torch.exp(mel), dim=-2).cpu().numpy()

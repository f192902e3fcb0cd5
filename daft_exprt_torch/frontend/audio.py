"""Audio file I/O without librosa or soundfile (copy of
``daft_exprt_tpu/frontend/audio.py``): WAV through scipy.io.wavfile,
polyphase resampling through scipy.signal on the host."""
import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def rescale_wav_to_float32(x):
    """Rescale an integer/float waveform array to float32 in [-1, 1]."""
    if x.dtype == np.int16:
        y = x / 32768.0
    elif x.dtype == np.int32:
        y = x / 2147483648.0
    elif x.dtype == np.uint8:
        y = ((x / 255.0) - 0.5) * 2
    elif x.dtype in (np.float32, np.float64):
        y = x
    else:
        raise TypeError(f'unsupported sample type {x.dtype}')
    return y.astype(np.float32)


def load_wav(path, target_sr=None):
    """Read a WAV file as mono float32 in [-1, 1], optionally resampled.

    Returns (wav, sample_rate).
    """
    sr, data = wavfile.read(path)
    wav = rescale_wav_to_float32(data)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return wav, sr


def save_wav(path, wav, sr):
    """Write a float waveform in [-1, 1] as int16 PCM."""
    wav = np.asarray(wav)
    audio = (wav * 32767.5).clip(min=-32768, max=32767).astype(np.int16)
    wavfile.write(path, sr, audio)

"""WAV writing with scipy (copy of ``daft_exprt_tpu/frontend/audio.py``'s
``save_wav``)."""
import numpy as np
from scipy.io import wavfile


def save_wav(path, wav, sr):
    """Write a float waveform in [-1, 1] as int16 PCM."""
    wav = np.asarray(wav)
    audio = (wav * 32767.5).clip(min=-32768, max=32767).astype(np.int16)
    wavfile.write(path, sr, audio)

"""Voice-like audio segments drawn from a seed: the one generator that
every ``gan-segments`` mix reads, with its parameters from the mix's file.

Per segment (``segment`` samples at 22050 Hz): a pulse train at F0
uniform on ``f0`` Hz, voiced between a start in the first quarter and
an end in the last, through a two-pole resonator at a frequency uniform
on ``formant`` Hz, peak 1/1.3, and Gaussian noise of std ``noise`` on
top (``chip_smoke.py::voice_like``, copied, with the formant drawn).
"""
import numpy as np
from scipy.signal import lfilter

SR = 22050


class Segments:
    def __init__(self, mix, seed, stream=0):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 6007, int(stream)])

    def segment(self):
        rng, mix = self.rng, self.mix
        n = mix['segment']
        f0 = rng.uniform(*mix['f0'])
        formant = rng.uniform(*mix['formant'])
        begin = int(rng.integers(0, n // 4))
        end = int(rng.integers(3 * n // 4, n + 1))
        sig = np.zeros(n)
        idx = np.arange(begin, end, SR / f0).astype(int)
        sig[idx[idx < n]] = 1.0
        y = lfilter([1.0], [1, -1.8 * np.cos(2 * np.pi * formant / SR), 0.81],
                    sig)
        y = y / (np.abs(y).max() * 1.3) + mix['noise'] * rng.standard_normal(n)
        return y.astype(np.float32)

    def batch(self):
        """(B, 1, segment) float32."""
        return np.stack([self.segment() for _ in range(self.mix['batch'])])[
            :, None]

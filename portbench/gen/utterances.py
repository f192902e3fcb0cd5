"""Synthesis requests drawn from a seed: the one generator that every
``batch-synth`` mix reads, with its parameters from the mix's file.

Per utterance: frames T on ``frames`` (inclusive) from the
maximum-entropy law on that range with the mean ``frames_mean`` (a
truncated exponential: a corpus's documented shortest, longest and mean
clip, and no shape assumed beyond them); frames per
symbol u uniform on ``frames_per_symbol``, L = round(T / u) symbols whose
integer durations are a uniform random split of T (each at least 1),
symbol ids uniform over the symbol set (pad excluded), normalised symbol
energy and pitch N(0, 1), a speaker among ``speakers`` and an accent
among ``accents``, whose embeddings are drawn once from the seed.
"""
import math

import numpy as np


def maxent_rate(mean):
    """The rate k of the density exp(k x) / Z on [0, 1] whose mean is
    ``mean`` (0 < mean < 1; k = 0 is uniform), by bisection."""
    def mean_of(k):
        if abs(k) < 1e-9:
            return 0.5
        return 1.0 / -math.expm1(-k) - 1.0 / k
    lo, hi = -200.0, 200.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if mean_of(mid) < mean else (lo, mid)
    return 0.5 * (lo + hi)


class Utterances:
    def __init__(self, mix, seed, n_symbols, spk_dim, accent_dim, hop, sr,
                 stream=0):
        self.mix = mix
        self.n_symbols = n_symbols
        self.hop, self.sr = hop, sr
        self.rng = np.random.default_rng([int(seed), 7919, int(stream)])
        lo, hi = mix['frames']
        self.rate = maxent_rate((mix['frames_mean'] - lo) / (hi - lo))
        emb = np.random.default_rng([int(seed), 104729])
        self.spk = emb.standard_normal((mix['speakers'], spk_dim)).astype(
            np.float32)
        self.accent = emb.standard_normal(
            (mix['accents'], accent_dim)).astype(np.float32)

    def utterance(self, frames=None, max_frames=None, symbols=None,
                  max_symbols=None):
        """One utterance; ``frames`` / ``symbols`` fix its sizes and
        ``max_frames`` / ``max_symbols`` cap them (the warm-up's shapes)."""
        rng, mix = self.rng, self.mix
        lo, hi = mix['frames']
        hi = min(hi, max_frames or hi)
        T = self._frames(lo, hi) if frames is None else int(frames)
        u = rng.uniform(*mix['frames_per_symbol'])
        L = int(round(T / u)) if symbols is None else int(symbols)
        L = max(1, min(T, L, max_symbols or L))
        cuts = np.sort(rng.choice(np.arange(1, T), L - 1, replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [T]])).astype(np.int64)
        return dict(
            symbols=rng.integers(1, self.n_symbols, L),
            durations_int=dur,
            energy=rng.standard_normal(L).astype(np.float32),
            pitch=rng.standard_normal(L).astype(np.float32),
            speaker=int(rng.integers(0, len(self.spk))),
            accent=int(rng.integers(0, len(self.accent))))

    def _frames(self, lo, hi):
        # inverse CDF of the truncated exponential on the mix's range,
        # the draw's bin widened by half a frame each side
        k, span = self.rate, self.mix['frames'][1] - self.mix['frames'][0]
        u = self.rng.random()
        x = u if abs(k) < 1e-9 else math.log1p(u * math.expm1(k)) / k
        T = int(round(self.mix['frames'][0] - 0.5 + x * (span + 1)))
        return min(max(T, lo), hi)

    def batch(self, B=None, first=None):
        """A batch as ``Synthesizer.infer``'s numpy arguments, padded to
        its longest utterance. ``first`` = (frames, symbols) fixes the
        first utterance's sizes and caps the others' to them."""
        B = B or self.mix['batch']
        if first is None:
            utts = [self.utterance() for _ in range(B)]
        else:
            T, L = first
            utts = [self.utterance(T, symbols=L)] + [
                self.utterance(max_frames=T, max_symbols=L)
                for _ in range(B - 1)]
        L = max(len(u['symbols']) for u in utts)
        out = dict(symbols=np.zeros((B, L), np.int64),
                   duration_preds=np.zeros((B, L), np.float32),
                   durations_int=np.zeros((B, L), np.int64),
                   energy_preds=np.zeros((B, L), np.float32),
                   pitch_preds=np.zeros((B, L), np.float32),
                   input_lengths=np.zeros((B,), np.int64),
                   spk_embs=np.zeros((B, self.spk.shape[1]), np.float32),
                   accent_emb=np.zeros((B, self.accent.shape[1]),
                                       np.float32))
        for i, u in enumerate(utts):
            n = len(u['symbols'])
            out['symbols'][i, :n] = u['symbols']
            out['durations_int'][i, :n] = u['durations_int']
            out['duration_preds'][i, :n] = \
                u['durations_int'] * self.hop / self.sr
            out['energy_preds'][i, :n] = u['energy']
            out['pitch_preds'][i, :n] = u['pitch']
            out['input_lengths'][i] = n
            out['spk_embs'][i] = self.spk[u['speaker']]
            out['accent_emb'][i] = self.accent[u['accent']]
        return out


def frames_of(batch):
    """Each utterance's own frames."""
    return batch['durations_int'].sum(axis=1)

"""On-the-fly per-speaker prosody normalization + support-set embeddings.

The port's own copy of ``daft_exprt_tpu/data/dynamic_stats.py`` (numpy
only): the same files and seed give the same refreshed stats.

Capability parity with the reference manager
(reference: src/daft_exprt/dynamic_stats.py:20-195): maintain a random
support subset per speaker, periodically recompute pitch/energy mean/std and
the averaged ECAPA embedding, and z-score batches with them (zeros
preserved).

Deliberate fix vs the reference (SURVEY.md §7.1): the reference relies on
every DDP rank drawing identical random subsets only through a shared seed
state drift; here refreshes are seeded by (seed, refresh_index) so every
host computes bit-identical stats, which is what keeps data-parallel
replicas consistent without a collective.
"""
import logging
import os
import random
from collections import defaultdict

import numpy as np

_logger = logging.getLogger(__name__)


class DynamicSpeakerStatsManager:
    def __init__(self, hparams, seed=None):
        self.hparams = hparams
        self.subset_size = getattr(hparams, 'dynamic_stats_subset_size', 10)
        self.emb_dim = getattr(hparams, 'external_emb_dim', 192)
        self.seed = seed if seed is not None else hparams.seed
        self.refresh_index = 0
        self.file_list_by_speaker = defaultdict(list)
        self._load_file_list(hparams.training_files)
        self.current_stats = {}
        self.refresh_stats()

    def _load_file_list(self, training_files):
        with open(training_files, 'r', encoding='utf-8') as f:
            for line in f:
                parts = line.strip().split('|')
                if len(parts) < 3:
                    continue
                features_dir, feature_file, speaker_id = parts[:3]
                base = os.path.join(features_dir, feature_file)
                self.file_list_by_speaker[int(speaker_id)].append({
                    'energy': f'{base}.frames_nrg',
                    'pitch': f'{base}.frames_f0',
                    'spk_emb': f'{base}.spk_emb.npy',
                })

    def refresh_stats(self):
        """Draw new per-speaker subsets (deterministic in refresh_index) and
        recompute stats."""
        rng = random.Random(self.seed * 1_000_003 + self.refresh_index)
        self.refresh_index += 1
        new_stats = {}
        for speaker_id, files in self.file_list_by_speaker.items():
            max_k = min(len(files), self.subset_size)
            k = rng.randint(1, max_k)
            subset = rng.sample(files, k)

            pitch_vals, energy_vals, embs = [], [], []
            for entry in subset:
                try:
                    with open(entry['pitch'], 'r', encoding='utf-8') as f:
                        p = np.array([float(x) for x in f], dtype=np.float64)
                    pitch_vals.extend(p[p > 0])
                except OSError as e:
                    _logger.warning(f"pitch read error {entry['pitch']}: {e}")
                try:
                    with open(entry['energy'], 'r', encoding='utf-8') as f:
                        e_arr = np.array([float(x) for x in f],
                                         dtype=np.float64)
                    energy_vals.extend(e_arr[e_arr > 0])
                except OSError as e:
                    _logger.warning(f"energy read error {entry['energy']}: {e}")
                if os.path.exists(entry['spk_emb']):
                    embs.append(np.load(entry['spk_emb']).reshape(-1))

            def mean_std(vals):
                if len(vals) == 0:
                    return 0.0, 1.0
                arr = np.asarray(vals)
                std = float(np.std(arr))
                return float(np.mean(arr)), (std if std != 0 else 1.0)

            p_mean, p_std = mean_std(pitch_vals)
            e_mean, e_std = mean_std(energy_vals)
            avg_emb = (np.mean(np.stack(embs), axis=0) if embs
                       else np.zeros(self.emb_dim))
            new_stats[speaker_id] = {
                'pitch': {'mean': p_mean, 'std': p_std},
                'energy': {'mean': e_mean, 'std': e_std},
                'spk_emb': avg_emb.astype(np.float32),
            }
        self.current_stats = new_stats

    def process_batch(self, batch):
        """Normalize a collated numpy batch in place-free fashion; returns a
        new dict with normalized prosody and support-set-averaged spk_embs.
        (reference: dynamic_stats.py:131-195)."""
        out = dict(batch)
        frames_energy = batch['frames_energy'].copy()
        frames_pitch = batch['frames_pitch'].copy()
        symbols_energy = batch['symbols_energy'].copy()
        symbols_pitch = batch['symbols_pitch'].copy()
        spk_embs = batch['spk_embs'].copy()

        for sid in np.unique(batch['speaker_ids']):
            sid = int(sid)
            if sid not in self.current_stats:
                continue
            st = self.current_stats[sid]
            rows = batch['speaker_ids'] == sid
            for arr, key in ((frames_energy, 'energy'),
                             (symbols_energy, 'energy'),
                             (frames_pitch, 'pitch'),
                             (symbols_pitch, 'pitch')):
                vals = arr[rows]
                zero = vals == 0.0
                vals = (vals - st[key]['mean']) / st[key]['std']
                vals[zero] = 0.0
                arr[rows] = vals
            spk_embs[rows] = st['spk_emb']

        out.update(frames_energy=frames_energy, frames_pitch=frames_pitch,
                   symbols_energy=symbols_energy, symbols_pitch=symbols_pitch,
                   spk_embs=spk_embs)
        return out

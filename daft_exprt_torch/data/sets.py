"""Train/validation set creation + dataset-level feature statistics (copy
of ``daft_exprt_tpu/data/sets.py``): ``features_dir|file|speaker_id`` list
files with a validation item every 100/prop items; per-speaker
energy/pitch mean/std/min/max over the symbol-level tracks and
per-symbol duration stats, written to stats.json."""
import collections
import json
import logging
import os

import numpy as np

_logger = logging.getLogger(__name__)


def create_sets(features_dir, hparams, proportion_validation=0.1):
    os.makedirs(os.path.dirname(os.path.abspath(hparams.training_files)),
                exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(hparams.validation_files)),
                exist_ok=True)
    with open(hparams.training_files, 'w', encoding='utf-8') as f_train, \
            open(hparams.validation_files, 'w', encoding='utf-8') as f_val:
        for speaker, speaker_id in zip(hparams.speakers, hparams.speakers_id):
            spk_features_dir = os.path.join(features_dir, speaker)
            metadata = os.path.join(spk_features_dir, 'metadata.csv')
            with open(metadata, 'r', encoding='utf-8') as f:
                lines = [x.strip().split('|') for x in f]
            file_names = [line[0].strip() for line in lines]
            feature_files = [
                x for x in file_names
                if os.path.isfile(os.path.join(spk_features_dir, f'{x}.npy'))]
            every = int(100 / proportion_validation)
            val_count = 0
            for ctr, feature_file in enumerate(feature_files, start=1):
                line = f'{spk_features_dir}|{feature_file}|{speaker_id}\n'
                last_and_no_val = (ctr == len(feature_files)
                                   and val_count == 0)
                if ctr % every == 0 or last_and_no_val:
                    f_val.write(line)
                    val_count += 1
                else:
                    f_train.write(line)
            _logger.info(f'speaker "{speaker}" (id {speaker_id}): '
                         f'{len(feature_files) - val_count} train / '
                         f'{val_count} validation files')


def _read_floats(path):
    with open(path, 'r', encoding='utf-8') as f:
        return [float(line.strip()) for line in f]


def extract_features_stats(hparams):
    """Training-set stats: per-speaker energy/pitch (symbol level, non-zero
    only) and per-symbol duration distribution."""
    with open(hparams.training_files, 'r', encoding='utf-8') as f:
        training_files = [line.strip().split('|') for line in f
                          if line.strip()]

    symbols_durations = collections.defaultdict(list)
    speaker_stats = {f'spk {sid}': {'energy': [], 'pitch': []}
                     for sid in set(hparams.speakers_id)}

    for features_dir, feature_file, speaker_id in (
            x[:3] for x in training_files):
        base = os.path.join(features_dir, feature_file)
        with open(f'{base}.markers', 'r', encoding='utf-8') as f:
            for line in f:
                begin, end, _, symbol, _, _ = line.strip().split('\t')
                if symbol not in hparams.symbols:
                    raise ValueError(f'{base}.markers: unknown symbol '
                                     f'"{symbol}"')
                symbols_durations[symbol].append(float(end) - float(begin))
        energy_vals = [v for v in _read_floats(f'{base}.symbols_nrg')
                       if v != 0.0]
        pitch_vals = [v for v in _read_floats(f'{base}.symbols_f0')
                      if v != 0.0]
        speaker_stats[f'spk {int(speaker_id)}']['energy'].extend(energy_vals)
        speaker_stats[f'spk {int(speaker_id)}']['pitch'].extend(pitch_vals)

    symbols_stats = {}
    for symbol, durs in symbols_durations.items():
        symbols_stats[symbol] = {
            'dur_min': float(np.min(durs)), 'dur_max': float(np.max(durs)),
            'dur_mean': float(np.mean(durs)), 'dur_std': float(np.std(durs)),
        }
    stats = {}
    for speaker, vals in speaker_stats.items():
        stats[speaker] = {
            key: {
                'mean': float(np.mean(v)), 'std': float(np.std(v)),
                'min': float(np.min(v)), 'max': float(np.max(v)),
            } if len(v) else {'mean': 0.0, 'std': 1.0, 'min': 0.0, 'max': 0.0}
            for key, v in (('energy', vals['energy']),
                           ('pitch', vals['pitch']))
        }
    stats['symbols'] = symbols_stats
    return stats


def save_stats(stats, output_directory):
    os.makedirs(output_directory, exist_ok=True)
    path = os.path.join(output_directory, 'stats.json')
    with open(path, 'w') as f:
        json.dump(stats, f, indent=4, sort_keys=True)
    return path

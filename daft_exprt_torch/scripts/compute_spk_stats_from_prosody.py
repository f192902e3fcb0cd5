"""Symbol-prosody file -> speaker pitch/energy stats JSON (the port's
``scripts/compute_spk_stats_from_prosody.py``), for ``synthesize
--new_speaker_stats``.

    python -m daft_exprt_torch.scripts.compute_spk_stats_from_prosody \
        -spf PROSODY -o STATS.json [-l english]

Voiced pitch and non-zero energy values over every entry:
{pitch: {mean, std}, energy: {mean, std}}. Host work only; ``--device`` is
checked like every tool's.
"""
import argparse
import json
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args


def compute_stats(prosody_file, hparams):
    from daft_exprt_torch.scripts.synthesize import parse_symbol_prosody_file
    _, _, external_prosody = parse_symbol_prosody_file(prosody_file, hparams)
    pitch_vals, energy_vals = [], []
    for entry in external_prosody:
        pitch_vals.extend(p for p in entry['pitch'] if p != 0.0)
        energy_vals.extend(e for e in entry['energy'] if e != 0.0)
    if not pitch_vals or not energy_vals:
        raise ValueError('no voiced pitch / non-zero energy values found')
    return {
        'pitch': {'mean': float(np.mean(pitch_vals)),
                  'std': float(np.std(pitch_vals)) or 1.0},
        'energy': {'mean': float(np.mean(energy_vals)),
                   'std': float(np.std(energy_vals)) or 1.0},
    }


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-spf', '--symbol_prosody_file', type=str,
                        required=True)
    parser.add_argument('-o', '--output_file', type=str, required=True)
    parser.add_argument('-l', '--language', type=str, default='english')
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Write the stats JSON; returns the stats."""
    from daft_exprt_torch.hparams import HyperParams

    args = parse_args(build_parser(), argv)
    hparams = HyperParams(verbose=False, training_files='unused',
                          validation_files='unused',
                          output_directory=os.path.dirname(
                              os.path.abspath(args.output_file)),
                          language=args.language, speakers=['spk'])
    stats = compute_stats(args.symbol_prosody_file, hparams)
    with open(args.output_file, 'w') as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == '__main__':
    main()

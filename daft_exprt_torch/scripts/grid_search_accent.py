"""Grid search over accent-conversion knobs (the port's
``scripts/grid_search_accent.py``).

    python -m daft_exprt_torch.scripts.grid_search_accent -out OUT \
        -chk CKPT -spf PROSODY --alpha_dur 0.9 1.1 [--target_metrics T.json]

Sweeps the duration/pitch/energy exaggeration factors over a fixed
prosody file, synthesizes each configuration (``synthesize``'s run on
``--device``), scores its wavs with the native prosody metrics (pitch std
in semitones, energy nPVI, duration nPVI) and, with target metrics, ranks
the configurations by their mean relative distance to them. Writes
``grid_results.json``.
"""
import argparse
import itertools
import json
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args
from daft_exprt_torch.scripts.evaluation.compute_wer_and_accent_metrics \
    import prosody_metrics

_logger = logging.getLogger(__name__)


def run(args):
    """The grid's rows (written to ``grid_results.json``)."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.scripts.synthesize import synthesize

    target = None
    if args.target_metrics:
        with open(args.target_metrics) as f:
            target = json.load(f)

    grid = list(itertools.product(args.alpha_dur, args.alpha_pitch,
                                  args.alpha_energy))
    _logger.info(f'{len(grid)} grid configurations')
    results = []
    for a_dur, a_pitch, a_energy in grid:
        tag = f'dur{a_dur}_pitch{a_pitch}_energy{a_energy}'
        run_args = argparse.Namespace(**vars(args))
        run_args.output_dir = os.path.join(args.output_dir, tag)
        run_args.alpha_dur = a_dur
        run_args.alpha_pitch = a_pitch
        run_args.alpha_energy = a_energy
        run_args.real_time_factor = False
        run_args.control = False
        preds = synthesize(run_args)

        hp = HyperParams(verbose=False, training_files='unused',
                         validation_files='unused',
                         output_directory=run_args.output_dir,
                         language='english', speakers=['spk'])
        metrics = []
        for name in preds:
            wav_path = os.path.join(run_args.output_dir, f'{name}.wav')
            if not os.path.isfile(wav_path):
                continue
            wav, fs = load_wav(wav_path, target_sr=hp.sampling_rate)
            metrics.append(prosody_metrics(wav, fs, hp,
                                           pitch_method=args.pitch_method,
                                           device=args.device))
        agg = {}
        for key in ('pitch_std_semitones', 'energy_npvi', 'duration_npvi'):
            vals = [m[key] for m in metrics if m.get(key) is not None]
            agg[key] = float(np.mean(vals)) if vals else None
        score = None
        if target is not None:
            diffs = [abs(agg[k] - target[k]) / max(abs(target[k]), 1e-6)
                     for k in agg if agg[k] is not None and k in target]
            score = float(np.mean(diffs)) if diffs else None
        row = {'tag': tag, 'alpha_dur': a_dur, 'alpha_pitch': a_pitch,
               'alpha_energy': a_energy, **agg, 'target_distance': score}
        results.append(row)
        _logger.info(json.dumps(row))

    if target is not None:
        scored = [r for r in results if r['target_distance'] is not None]
        if scored:
            best = min(scored, key=lambda r: r['target_distance'])
            _logger.info(f"best configuration: {best['tag']} "
                         f"(distance {best['target_distance']:.4f})")
    with open(os.path.join(args.output_dir, 'grid_results.json'), 'w') as f:
        json.dump(results, f, indent=2)
    return results


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-spf', '--symbol_prosody_file', type=str,
                        required=True)
    parser.add_argument('-sid', '--speaker_id', type=int, default=0)
    parser.add_argument('--config_overrides', type=str, default='')
    parser.add_argument('--use_griffin_lim', action='store_true')
    parser.add_argument('--vocoder_checkpoint', type=str, default='')
    parser.add_argument('--reduce_buzz', action='store_true')
    parser.add_argument('-bs', '--batch_size', type=int, default=8)
    parser.add_argument('--new_speaker_stats', type=str, default='')
    parser.add_argument('--neutralize_prosody', action='store_true')
    parser.add_argument('--spk_emb_audios_dir', type=str, default='')
    parser.add_argument('--spk_emb_file', type=str, default='')
    parser.add_argument('--accent_emb_audios_dir', type=str, default='')
    parser.add_argument('--accent_emb_file', type=str, default='')
    parser.add_argument('--alpha_dur', type=float, nargs='*',
                        default=[0.9, 1.0, 1.1])
    parser.add_argument('--alpha_pitch', type=float, nargs='*',
                        default=[1.0, 1.2, 1.4])
    parser.add_argument('--alpha_energy', type=float, nargs='*',
                        default=[1.0, 1.2])
    parser.add_argument('--target_metrics', type=str, default='',
                        help='JSON of target prosody metrics to rank against')
    parser.add_argument('--pitch_method', type=str, default='auto')
    add_device_flag(parser)
    return parser


def main(argv=None):
    return run(parse_args(build_parser(), argv))


if __name__ == '__main__':
    main()

"""Populate a style bank (the port's ``scripts/make_style_bank.py``; the
bank's layout is in ``scripts/style_bank/english/README.md``).

    python -m daft_exprt_torch.scripts.make_style_bank -fd FEATURES \
        [-dd DATASET] [-out BANK] [-n 28] [--seed 1234]

- ``--features_dir`` (preferred): sample utterances from a preprocessed
  features directory and write everything the zero-argument synthesis demo
  needs: reference wavs (when findable next to the features or under
  ``--data_set_dir``), a ``bank.prosody`` file with per-utterance (symbol,
  duration, pitch, energy) tuples from the extracted features, an averaged
  ``spk_emb.npy`` and a ``speaker_stats.json`` with voiced-pitch /
  nonzero-energy mean and std.
- ``--data_set_dir`` alone: copy random wavs from a formatted dataset
  (audio only: accent references for ``--accent_emb_audios_dir``).

Host work only; ``--device`` is checked like every tool's.
"""
import argparse
import json
import os
import random
import shutil
import sys

import numpy as np

from daft_exprt_torch.scripts._cli import (
    PROJECT_ROOT, add_device_flag, parse_args,
)


def _read_floats(path):
    with open(path, 'r', encoding='utf-8') as f:
        return np.array([float(x) for x in f], dtype=np.float32)


def _find_wav(features_dir, name, data_set_dir=None):
    """Locate the source wav for a features entry: alongside the features,
    or under the formatted dataset's ``<speaker>/wavs/``."""
    speaker = os.path.basename(os.path.normpath(features_dir))
    candidates = [os.path.join(features_dir, f'{name}.wav'),
                  os.path.join(features_dir, 'wavs', f'{name}.wav')]
    if data_set_dir:
        candidates.append(os.path.join(data_set_dir, speaker, 'wavs',
                                       f'{name}.wav'))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def bank_from_features(features_root, output_dir, nb_files=28, seed=1234,
                       data_set_dir=None):
    """Build the full demo bank from preprocessed features dirs."""
    rng = random.Random(seed)
    entries = []                       # (features_dir, name)
    for root, _, files in os.walk(features_root):
        for f in files:
            if f.endswith('.markers'):
                entries.append((root, f[:-len('.markers')]))
    if not entries:
        sys.exit(f'no preprocessed features (.markers) under '
                 f'{features_root} — run pre_process first')
    entries.sort()                     # os.walk order is fs-dependent —
                                       # sort so --seed is reproducible
    entries = rng.sample(entries, min(nb_files, len(entries)))

    os.makedirs(output_dir, exist_ok=True)
    prosody_lines = []
    spk_embs = []
    all_pitch, all_energy = [], []
    n_wavs = 0
    used_names = set()
    for fdir, name in entries:
        base = os.path.join(fdir, name)
        # duplicate utterance basenames across speaker feature dirs would
        # collapse in the bank (last wav wins, prosody keys mispair in
        # synthesize) — uniquify with the speaker dir name
        out_name = name
        if out_name in used_names:
            speaker = os.path.basename(os.path.normpath(fdir))
            out_name = f'{speaker}_{name}'
            k = 2
            while out_name in used_names:
                out_name = f'{speaker}_{name}_{k}'
                k += 1
        used_names.add(out_name)
        symbols, durs = [], []
        with open(f'{base}.markers', 'r', encoding='utf-8') as f:
            for line in f:
                _, _, int_dur, symbol, _, _ = line.rstrip('\n').split('\t')
                symbols.append(symbol)
                durs.append(int(int_dur))
        sym_pitch = _read_floats(f'{base}.symbols_f0')
        sym_energy = _read_floats(f'{base}.symbols_nrg')
        tuples = [(s, d, round(float(p), 3), round(float(e), 3))
                  for s, d, p, e in zip(symbols, durs, sym_pitch,
                                        sym_energy)]
        prosody_lines.append(f'{out_name}|{tuples!r}\n')

        frames_f0 = _read_floats(f'{base}.frames_f0')
        frames_nrg = _read_floats(f'{base}.frames_nrg')
        all_pitch.append(frames_f0[frames_f0 > 0])
        all_energy.append(frames_nrg[frames_nrg != 0])

        emb_path = f'{base}.spk_emb.npy'
        if os.path.isfile(emb_path):
            spk_embs.append(np.load(emb_path).reshape(-1))

        wav = _find_wav(fdir, name, data_set_dir)
        if wav:
            shutil.copyfile(wav, os.path.join(output_dir,
                                              f'{out_name}.wav'))
            n_wavs += 1

    with open(os.path.join(output_dir, 'bank.prosody'), 'w',
              encoding='utf-8') as f:
        f.writelines(prosody_lines)
    if spk_embs:
        np.save(os.path.join(output_dir, 'spk_emb.npy'),
                np.mean(np.stack(spk_embs), axis=0).astype(np.float32))
    pitch = np.concatenate(all_pitch) if all_pitch else np.zeros(0)
    energy = np.concatenate(all_energy) if all_energy else np.zeros(0)
    if len(pitch) > 1 and len(energy) > 1:
        stats = {'pitch': {'mean': float(pitch.mean()),
                           'std': float(pitch.std())},
                 'energy': {'mean': float(energy.mean()),
                            'std': float(energy.std())}}
        with open(os.path.join(output_dir, 'speaker_stats.json'), 'w') as f:
            json.dump(stats, f, indent=2)
    print(f'{len(entries)} utterances → {output_dir} '
          f'({n_wavs} wavs, spk_emb={"yes" if spk_embs else "no"})')


def bank_from_wavs(data_set_dir, output_dir, nb_files=28, seed=1234):
    rng = random.Random(seed)
    wavs = []
    for root, _, files in os.walk(data_set_dir):
        wavs.extend(os.path.join(root, f) for f in files
                    if f.endswith('.wav'))
    if not wavs:
        sys.exit(f'no wavs under {data_set_dir}')
    os.makedirs(output_dir, exist_ok=True)
    picked = rng.sample(wavs, min(nb_files, len(wavs)))
    for src in picked:
        shutil.copyfile(src, os.path.join(output_dir,
                                          os.path.basename(src)))
    print(f'{len(picked)} wavs copied to {output_dir}')


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-dd', '--data_set_dir', type=str, default='',
                        help='formatted dataset root (wav sampling; also '
                             'the wav source for --features_dir mode)')
    parser.add_argument('-fd', '--features_dir', type=str, default='',
                        help='preprocessed features root: emits the full '
                             'demo bank (prosody + embeddings + stats)')
    parser.add_argument('-out', '--output_dir', type=str,
                        default=os.path.join(PROJECT_ROOT, 'scripts',
                                             'style_bank', 'english'))
    parser.add_argument('-n', '--nb_files', type=int, default=28)
    parser.add_argument('--seed', type=int, default=1234)
    add_device_flag(parser)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parse_args(parser, argv)
    if args.features_dir:
        bank_from_features(args.features_dir, args.output_dir,
                           args.nb_files, args.seed,
                           data_set_dir=args.data_set_dir or None)
    elif args.data_set_dir:
        bank_from_wavs(args.data_set_dir, args.output_dir, args.nb_files,
                       args.seed)
    else:
        parser.error('provide --features_dir (full demo bank) or '
                     '--data_set_dir (wavs only)')
    return args.output_dir


if __name__ == '__main__':
    main()

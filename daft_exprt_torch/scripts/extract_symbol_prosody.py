"""Extract symbol-level prosody tuples from audio + transcripts (the
port's ``scripts/extract_symbol_prosody.py``).

    python -m daft_exprt_torch.scripts.extract_symbol_prosody -m MANIFEST \
        -o OUT.prosody [--skip_mfa --work_dir W] [--output_format arrays]

Manifest lines ``audio|transcript[|phonemes]``, OOV-aware dictionary
augmentation through ``mfa g2p``, forced alignment through ``mfa align``
(or, with ``--skip_mfa``, ``<work_dir>/align/utt_%04d.markers`` and
``<work_dir>/corpus/speaker/wavs/utt_%04d.wav`` already there),
per-symbol integer durations / mean voiced pitch / mean energy (mel,
energy and pitch on ``--device``), in either output format (tuple list or
4 parallel arrays). The output feeds ``synthesize
--symbol_prosody_file``.
"""
import argparse
import logging
import os
import subprocess
import tempfile
from shutil import copyfile

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def parse_manifest(manifest):
    """audio|transcript[|custom phonemes] lines."""
    entries = []
    with open(manifest, 'r', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            parts = line.split('|')
            if len(parts) < 2:
                raise ValueError(f'malformed manifest line: {line}')
            entry = {'audio': parts[0].strip(),
                     'transcript': parts[1].strip(),
                     'phonemes': parts[2].strip() if len(parts) > 2 else None}
            entries.append(entry)
    return entries


def prepare_pronunciation_dictionary(entries, hparams, work_dir):
    """Augment the MFA dictionary with g2p transcriptions for OOV words."""
    import re
    from daft_exprt_torch.text.cleaners import text_cleaner
    from daft_exprt_torch.text.symbols import ascii_letters, punctuation

    with open(hparams.mfa_dictionary, 'r', encoding='utf-8') as f:
        known = {line.split()[0].lower() for line in f if line.strip()}
    all_chars = ascii_letters + punctuation
    oovs = set()
    for entry in entries:
        text = text_cleaner(entry['transcript'], hparams.language).lower()
        words = re.findall(rf"[\w']+|[{punctuation}]", text)
        words = [w for w in words
                 if len(re.sub(f'[^{all_chars}]', '', w)) != 0
                 and w not in punctuation]
        oovs.update(w for w in words if w not in known)
    dict_path = os.path.join(work_dir, 'dictionary.dict')
    copyfile(hparams.mfa_dictionary, dict_path)
    if oovs:
        oov_file = os.path.join(work_dir, 'oovs.txt')
        with open(oov_file, 'w', encoding='utf-8') as f:
            f.write('\n'.join(sorted(oovs)) + '\n')
        trans_file = os.path.join(work_dir, 'oov_trans.txt')
        subprocess.run(['mfa', 'g2p', hparams.mfa_g2p_model, oov_file,
                        trans_file, '-t', os.path.join(work_dir, 'g2p_tmp')],
                       check=False)
        if os.path.isfile(trans_file):
            with open(trans_file, 'r', encoding='utf-8') as f_in, \
                    open(dict_path, 'a', encoding='utf-8') as f_out:
                f_out.write(f_in.read())
    return dict_path


def run_forced_alignment(entries, hparams, work_dir, dict_path, n_jobs=4):
    """Build a one-speaker corpus and run mfa align → .markers."""
    from daft_exprt_torch.frontend.audio import load_wav, save_wav
    from daft_exprt_torch.frontend.mfa import extract_markers
    from daft_exprt_torch.text.cleaners import text_cleaner

    corpus = os.path.join(work_dir, 'corpus', 'speaker')
    wavs_dir = os.path.join(corpus, 'wavs')
    os.makedirs(wavs_dir, exist_ok=True)
    for idx, entry in enumerate(entries):
        name = f'utt_{idx:04d}'
        wav, _ = load_wav(entry['audio'], target_sr=hparams.sampling_rate)
        save_wav(os.path.join(wavs_dir, f'{name}.wav'), wav,
                 hparams.sampling_rate)
        cleaned = text_cleaner(entry['transcript'], hparams.language).strip()
        with open(os.path.join(wavs_dir, f'{name}.lab'), 'w',
                  encoding='utf-8') as f:
            f.write(cleaned)
        entry['name'] = name
        entry['cleaned'] = cleaned
    align_dir = os.path.join(work_dir, 'align')
    subprocess.run(['mfa', 'align', corpus, dict_path,
                    hparams.mfa_acoustic_model, align_dir,
                    '-t', os.path.join(work_dir, 'mfa_tmp'),
                    '-j', str(n_jobs), '-v', '-c'], check=False)
    grid_dir = os.path.join(align_dir, 'wavs')
    src = grid_dir if os.path.isdir(grid_dir) else align_dir
    extract_markers(src, n_jobs)
    return src, wavs_dir


def compute_symbol_prosody(name, cleaned, markers_file, wav_file, hparams,
                           pitch_method='auto', device=None):
    """One utterance → [(symbol, int_dur, pitch, energy), ...]; mel,
    energy and the pitch tracker on ``device`` (default cuda)."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.frontend.duration import duration_to_integer
    from daft_exprt_torch.frontend.extract_features import (
        get_symbols_energy, get_symbols_pitch)
    from daft_exprt_torch.frontend.markers import update_markers
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.ops.mel import MelExtractor, frame_energy

    with open(markers_file, 'r', encoding='utf-8') as f:
        lines = f.readlines()
    sent_begin = float(lines[0].strip().split('\t')[0])
    sent_end = float(lines[-1].strip().split('\t')[1])
    wav, fs = load_wav(wav_file, target_sr=hparams.sampling_rate)
    wav = wav[int(sent_begin * fs): int(sent_end * fs)]

    mel = MelExtractor(hparams, device=device)(wav)
    nb_frames = mel.shape[1]
    float_durations = [[float(x[0]) - sent_begin, float(x[1]) - sent_begin]
                       for x in (l.strip().split('\t') for l in lines)]
    int_durations = duration_to_integer(float_durations, hparams,
                                        nb_samples=len(wav))
    diff = nb_frames - sum(int_durations)
    if diff != 0 and int_durations[-1] + diff >= 0:
        int_durations[-1] += diff
    markers = update_markers(name, lines, cleaned, sent_begin, int_durations,
                             hparams)
    if markers is None:
        return None
    energy = np.asarray(frame_energy(mel, device=device))
    pitch = extract_pitch(wav, fs, hparams, method=pitch_method,
                          device=device)
    pitch = pitch[:nb_frames]
    if len(pitch) < nb_frames:
        pitch = np.append(pitch, [pitch[-1]] * (nb_frames - len(pitch)))
    sym_energy = [float(x) for x in get_symbols_energy(energy, markers)]
    sym_pitch = [float(x) for x in get_symbols_pitch(pitch, markers)]
    return [(m[3], int(m[2]), p, e)
            for m, p, e in zip(markers, sym_pitch, sym_energy)]


def run(args):
    """Extract the manifest's prosody into ``args.output_file``; returns
    the number of utterances written."""
    from daft_exprt_torch.hparams import HyperParams

    hparams = HyperParams(
        verbose=False, check_mfa=not args.skip_mfa,
        training_files='unused', validation_files='unused',
        output_directory=os.path.dirname(os.path.abspath(args.output_file)),
        language=args.language, speakers=['speaker'])
    entries = parse_manifest(args.manifest)
    work_dir = args.work_dir or tempfile.mkdtemp(prefix='symbol_prosody_')
    os.makedirs(work_dir, exist_ok=True)

    if args.skip_mfa:
        # alignments are pre-existing: <work_dir>/align/utt_%04d.markers
        markers_dir = os.path.join(work_dir, 'align')
        wavs_dir = os.path.join(work_dir, 'corpus', 'speaker', 'wavs')
        for idx, entry in enumerate(entries):
            entry['name'] = f'utt_{idx:04d}'
            from daft_exprt_torch.text.cleaners import text_cleaner
            entry['cleaned'] = text_cleaner(entry['transcript'],
                                            hparams.language).strip()
    else:
        dict_path = prepare_pronunciation_dictionary(entries, hparams,
                                                     work_dir)
        markers_dir, wavs_dir = run_forced_alignment(
            entries, hparams, work_dir, dict_path, n_jobs=args.nb_jobs)

    results = []
    for entry in entries:
        if entry['phonemes']:
            _logger.info(f"{entry['name']}: custom phoneme override given — "
                         f'alignment still uses the transcript')
        markers_file = os.path.join(markers_dir, f"{entry['name']}.markers")
        wav_file = os.path.join(wavs_dir, f"{entry['name']}.wav")
        if not os.path.isfile(markers_file):
            _logger.warning(f"{entry['name']}: no alignment, skipping")
            continue
        tuples = compute_symbol_prosody(entry['name'], entry['cleaned'],
                                        markers_file, wav_file, hparams,
                                        pitch_method=args.pitch_method,
                                        device=args.device)
        if tuples is None:
            _logger.warning(f"{entry['name']}: marker update failed")
            continue
        results.append((entry['audio'], tuples))

    with open(args.output_file, 'w', encoding='utf-8') as f:
        for audio, tuples in results:
            if args.output_format == 'arrays':
                symbols = [t[0] for t in tuples]
                durs = [t[1] for t in tuples]
                pitch = [round(t[2], 3) for t in tuples]
                energy = [round(t[3], 3) for t in tuples]
                f.write(f'{audio}|{[symbols, durs, pitch, energy]!r}\n')
            else:
                rounded = [(s, d, round(p, 3), round(e, 3))
                           for s, d, p, e in tuples]
                f.write(f'{audio}|{rounded!r}\n')
    _logger.info(f'{len(results)}/{len(entries)} utterances written to '
                 f'{args.output_file}')
    return len(results)


def build_parser():
    parser = argparse.ArgumentParser(
        description='extract per-symbol prosody tuples from audio')
    parser.add_argument('-m', '--manifest', type=str, required=True,
                        help='lines: audio|transcript[|phonemes]')
    parser.add_argument('-o', '--output_file', type=str, required=True)
    parser.add_argument('-l', '--language', type=str, default='english')
    parser.add_argument('-nj', '--nb_jobs', type=int, default=4)
    parser.add_argument('--work_dir', type=str, default='')
    parser.add_argument('--skip_mfa', action='store_true',
                        help='use pre-existing alignments in work_dir/align')
    parser.add_argument('--output_format', type=str, default='tuples',
                        choices=['tuples', 'arrays'])
    parser.add_argument('--pitch_method', type=str, default='auto',
                        choices=['auto', 'native', 'device'])
    add_device_flag(parser)
    return parser


def main(argv=None):
    return run(parse_args(build_parser(), argv))


if __name__ == '__main__':
    main()

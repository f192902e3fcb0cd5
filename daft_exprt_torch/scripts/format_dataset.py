"""Reformat public corpora into the ``<speaker>/{metadata.csv,wavs/}``
layout (the port's ``scripts/format_dataset.py``).

    python -m daft_exprt_torch.scripts.format_dataset -out DATASET \
        [--ljspeech_root LJ] [--esd_root ESD [--esd_emotion Neutral]]

LJSpeech (one speaker) and ESD's English speakers 0011-0020, the audio
symlinked rather than copied. Host work only; ``--device`` is checked like
every tool's.
"""
import argparse
import logging
import os

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)

ESD_ENGLISH_SPEAKERS = [f'00{i}' for i in range(11, 21)]


def format_ljspeech(ljspeech_root, output_dir):
    """LJSpeech-1.1: metadata.csv with file|raw|normalized columns."""
    spk_dir = os.path.join(output_dir, 'LJ')
    wavs_out = os.path.join(spk_dir, 'wavs')
    os.makedirs(wavs_out, exist_ok=True)
    src_meta = os.path.join(ljspeech_root, 'metadata.csv')
    src_wavs = os.path.join(ljspeech_root, 'wavs')
    lines_out = []
    with open(src_meta, 'r', encoding='utf-8') as f:
        for line in f:
            parts = line.strip().split('|')
            if len(parts) < 3:
                continue
            name, _raw, normalized = parts[0], parts[1], parts[2]
            src = os.path.join(src_wavs, f'{name}.wav')
            if not os.path.isfile(src):
                continue
            dst = os.path.join(wavs_out, f'{name}.wav')
            if not os.path.exists(dst):
                os.symlink(os.path.abspath(src), dst)
            lines_out.append(f'{name}|{normalized}\n')
    with open(os.path.join(spk_dir, 'metadata.csv'), 'w',
              encoding='utf-8') as f:
        f.writelines(lines_out)
    _logger.info(f'LJSpeech: {len(lines_out)} utterances -> {spk_dir}')


def format_esd(esd_root, output_dir, speakers=None, emotion='Neutral'):
    """ESD: per-speaker directories with <spk>.txt transcript files."""
    speakers = speakers or ESD_ENGLISH_SPEAKERS
    for spk in speakers:
        spk_src = os.path.join(esd_root, spk)
        if not os.path.isdir(spk_src):
            _logger.warning(f'missing ESD speaker {spk}')
            continue
        transcript = os.path.join(spk_src, f'{spk}.txt')
        texts = {}
        if os.path.isfile(transcript):
            with open(transcript, 'r', encoding='utf-8-sig',
                      errors='replace') as f:
                for line in f:
                    parts = line.strip().split('\t')
                    if len(parts) >= 2:
                        texts[parts[0]] = parts[1]
        spk_dir = os.path.join(output_dir, f'ESD_{spk}')
        wavs_out = os.path.join(spk_dir, 'wavs')
        os.makedirs(wavs_out, exist_ok=True)
        lines_out = []
        for root, _, files in os.walk(spk_src):
            if emotion and emotion not in root:
                continue
            for wav in sorted(f for f in files if f.endswith('.wav')):
                name = wav[:-4]
                if name not in texts:
                    continue
                dst = os.path.join(wavs_out, wav)
                if not os.path.exists(dst):
                    os.symlink(os.path.abspath(os.path.join(root, wav)), dst)
                lines_out.append(f'{name}|{texts[name]}\n')
        with open(os.path.join(spk_dir, 'metadata.csv'), 'w',
                  encoding='utf-8') as f:
            f.writelines(lines_out)
        _logger.info(f'ESD {spk}: {len(lines_out)} utterances -> {spk_dir}')


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--ljspeech_root', type=str, default='')
    parser.add_argument('--esd_root', type=str, default='')
    parser.add_argument('--esd_emotion', type=str, default='Neutral')
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    add_device_flag(parser)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parse_args(parser, argv)
    if args.ljspeech_root:
        format_ljspeech(args.ljspeech_root, args.output_dir)
    if args.esd_root:
        format_esd(args.esd_root, args.output_dir, emotion=args.esd_emotion)
    if not (args.ljspeech_root or args.esd_root):
        parser.error('provide --ljspeech_root and/or --esd_root')
    return args.output_dir


if __name__ == '__main__':
    main()

"""Montreal Forced Aligner orchestration (the port's own copy of
``daft_exprt_tpu/frontend/mfa.py``): .lab transcripts next to each wav, the
external ``mfa align`` command per speaker (same arguments), and the
TextGrid output converted to ``.markers`` files (silence merging, word and
phone gathering, leading and trailing silence trimming, timing checks)
through the port's TextGrid parser. Host code only.
"""
import logging
import os
import subprocess
from shutil import move, rmtree

from daft_exprt_torch.frontend.textgrid import read_textgrid
from daft_exprt_torch.text.cleaners import text_cleaner
from daft_exprt_torch.text.symbols import (
    MFA_SIL_PHONE_SYMBOLS, MFA_SIL_WORD_SYMBOL, MFA_UNK_PHONE_SYMBOL,
    MFA_UNK_WORD_SYMBOL, SIL_PHONE_SYMBOL, SIL_WORD_SYMBOL,
)

_logger = logging.getLogger(__name__)


def prepare_corpus(corpus_dir, language):
    """Create a .lab transcript next to each wav (reference: mfa.py:31-69)."""
    wavs_dir = os.path.join(corpus_dir, 'wavs')
    metadata = os.path.join(corpus_dir, 'metadata.csv')
    with open(metadata, 'r', encoding='utf-8') as f:
        lines = [x.strip().split('|') for x in f if x.strip()]
    for line in lines:
        if len(line) != 2:
            raise ValueError(f'{metadata}: malformed line {line}')
    text_by_name = {}
    for file_name, text in lines:
        text_by_name.setdefault(file_name.strip(), []).append(text.strip())
    for wav in (x for x in os.listdir(wavs_dir) if x.endswith('.wav')):
        name = wav[:-4].strip()
        texts = text_by_name.get(name, [])
        if len(texts) == 1:
            cleaned = text_cleaner(texts[0], language).strip()
            with open(os.path.join(wavs_dir, f'{name}.lab'), 'w',
                      encoding='utf-8') as f:
                f.write(cleaned)


def textgrid_to_markers(text_grid_file, logger=None):
    """TextGrid → markers lines [[begin, end, phone, word, word_idx], ...]
    or None on unknown-word/silence errors (reference: mfa.py:72-163)."""
    logger = logger or _logger
    tiers = read_textgrid(text_grid_file)
    words = [[s, e, t] for s, e, t in tiers['words']]
    phones = [[s, e, t] for s, e, t in tiers['phones']]

    for marker in words:
        if marker[2] == MFA_SIL_WORD_SYMBOL:
            marker[2] = SIL_WORD_SYMBOL
    for marker in phones:
        if marker[2] in MFA_SIL_PHONE_SYMBOLS:
            marker[2] = SIL_PHONE_SYMBOL

    # merge consecutive phone-level silences
    merged = [phones[0]]
    for marker in phones[1:]:
        if merged[-1][2] == marker[2] == SIL_PHONE_SYMBOL:
            merged[-1][1] = marker[1]
        else:
            merged.append(marker)
    phones = merged

    if (MFA_UNK_WORD_SYMBOL in (w for _, _, w in words)
            or MFA_UNK_PHONE_SYMBOL in (p for _, _, p in phones)):
        logger.warning(f'{text_grid_file}: unknown word/phone -- skipping')
        return None

    markers = []
    for word_idx, (begin_word, end_word, word) in enumerate(words):
        for begin_phone, end_phone, phone in phones:
            if begin_word <= begin_phone and end_phone <= end_word:
                if word == SIL_WORD_SYMBOL:
                    if not (phone == SIL_PHONE_SYMBOL
                            and begin_word == begin_phone
                            and end_word == end_phone):
                        raise AssertionError(
                            f'{text_grid_file}: silence mismatch at word '
                            f'{word_idx}')
                elif phone == SIL_PHONE_SYMBOL:
                    logger.warning(f'{text_grid_file}: silence within word '
                                   f'{word_idx} -- skipping')
                    return None
                markers.append([f'{begin_phone:.3f}', f'{end_phone:.3f}',
                                phone, word, str(word_idx)])
            elif not (end_phone <= begin_word or end_word <= begin_phone):
                raise AssertionError(
                    f'{text_grid_file}: word/phone overlap at word '
                    f'{word_idx}')

    # trim leading/tailing silences
    if markers and markers[0][2] == SIL_PHONE_SYMBOL:
        markers.pop(0)
    if markers and markers[-1][2] == SIL_PHONE_SYMBOL:
        markers.pop(-1)
    if not markers or markers[0][2] == SIL_PHONE_SYMBOL \
            or markers[-1][2] == SIL_PHONE_SYMBOL:
        raise AssertionError(f'{text_grid_file}: silence trimming failed')

    for cur, nxt in zip(markers[:-1], markers[1:]):
        if float(cur[1]) != float(nxt[0]) or float(cur[0]) >= float(cur[1]) \
                or float(nxt[0]) >= float(nxt[1]):
            raise AssertionError(f'{text_grid_file}: timing integrity error')
    return markers


def _extract_markers(text_grid_file, log_queue=None):
    markers = textgrid_to_markers(text_grid_file)
    if markers is None:
        return None
    out = text_grid_file.replace('.TextGrid', '.markers')
    with open(out, 'w', encoding='utf-8') as f:
        f.writelines('\t'.join(x) + '\n' for x in markers)
    return out


def extract_markers(text_grid_dir, n_jobs=1):
    grids = [os.path.join(text_grid_dir, x)
             for x in os.listdir(text_grid_dir) if x.endswith('.TextGrid')]
    todo = [x for x in grids
            if not os.path.isfile(x.replace('.TextGrid', '.markers'))]
    _logger.info(f'{text_grid_dir}: {len(grids) - len(todo)} done, '
                 f'{len(todo)} to process')
    for grid in todo:
        try:
            _extract_markers(grid)
        except AssertionError as e:
            _logger.warning(str(e))


def mfa(dataset_dir, hparams, n_jobs=1):
    """Align each speaker corpus with MFA and produce .markers + .lab in
    <speaker>/align (reference: mfa.py:179-255)."""
    for speaker in hparams.speakers:
        _logger.info(f'Speaker: "{speaker}"')
        corpus_dir = os.path.join(dataset_dir, speaker)
        align_out_dir = os.path.join(corpus_dir, 'align')
        wavs_dir = os.path.join(corpus_dir, 'wavs')
        if not os.path.isdir(align_out_dir):
            temp_dir = os.path.join(corpus_dir, 'tmp')
            prepare_corpus(corpus_dir, hparams.language)
            _logger.info('Performing forced alignment (mfa align)')
            subprocess.run(
                ['mfa', 'align', corpus_dir, hparams.mfa_dictionary,
                 hparams.mfa_acoustic_model, align_out_dir,
                 '-t', os.path.join(temp_dir, 'align'),
                 '-j', str(n_jobs), '-v', '-c'], check=False)
            grid_dir = os.path.join(align_out_dir, 'wavs')
            if os.path.isdir(grid_dir):
                for f in os.listdir(grid_dir):
                    move(os.path.join(grid_dir, f),
                         os.path.join(align_out_dir, f))
                rmtree(grid_dir, ignore_errors=True)
            extract_markers(align_out_dir, n_jobs)
            for lab in (x for x in os.listdir(wavs_dir)
                        if x.endswith('.lab')):
                move(os.path.join(wavs_dir, lab),
                     os.path.join(align_out_dir, lab))
            rmtree(temp_dir, ignore_errors=True)
        else:
            _logger.info('MFA alignment already performed')
            extract_markers(align_out_dir, n_jobs)
        wavs = [x for x in os.listdir(wavs_dir) if x.endswith('.wav')]
        marks = [x for x in os.listdir(align_out_dir)
                 if x.endswith('.markers')]
        if wavs:
            _logger.info(f'{len(marks) / len(wavs) * 100:.2f}% of the '
                         f'data set aligned')

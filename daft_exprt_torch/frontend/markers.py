"""Marker bookkeeping: word-boundary insertion + sentence<->markers
matching (copy of ``daft_exprt_tpu/frontend/markers.py``).

Rebase timings to 0, match the cleaned sentence's words against the
aligner's words (handling apostrophe splits), insert punctuation/whitespace
word-boundary symbols (attaching aligner silences to them), keep one
trailing punctuation mark, append EOS, and attach integer durations.
Returns None when the sentence and the alignment cannot be reconciled.
"""
import logging
import re

from daft_exprt_torch.text.symbols import (
    SIL_WORD_SYMBOL, ascii_letters, eos, punctuation, whitespace,
)

_logger = logging.getLogger(__name__)


def update_markers(file_name, lines, sentence, sent_begin, int_durations,
                   hparams, logger=None):
    """lines: raw .markers lines '[begin]\t[end]\t[phone]\t[word]\t[word_idx]';
    sentence: the .lab text; int_durations: per-line frame counts (consumed).
    Returns [[begin, end, int_dur, symbol, word, word_idx], ...] or None."""
    logger = logger or _logger
    if hparams.language == 'english':
        all_chars = ascii_letters + punctuation
    else:
        raise NotImplementedError(hparams.language)

    sent_words = re.findall(rf"[\w']+|[{punctuation}]",
                            sentence.lower().strip())
    sent_words = [x for x in sent_words
                  if len(re.sub(f'[^{all_chars}]', '', x)) != 0]
    while sent_words and sent_words[0] in punctuation:
        sent_words.pop(0)
    punctuation_end = None
    while sent_words and sent_words[-1] in punctuation:
        punctuation_end = sent_words.pop(-1)

    markers_old = [line.strip().split('\t') for line in lines]
    words_idx = [m[4] for m in markers_old]
    lines_idx = [words_idx.index(wi)
                 for wi in dict.fromkeys(words_idx).keys()]
    marker_words = [markers_old[li][3] for li in lines_idx]

    sent_words_copy = sent_words.copy()
    markers, word_idx = [], 0
    durations = list(int_durations)
    while len(sent_words) != 0:
        sent_word = sent_words.pop(0)
        marker_word, marker_word_idx = markers_old[0][3], markers_old[0][4]
        if marker_word != sent_word:
            # generally an apostrophe mismatch: example' vs example, or
            # that's vs [that, s]
            regex_word = re.findall(rf'[\w]+|[{punctuation}]', sent_word)
            if len(regex_word) == 1:
                sent_word = regex_word[0]
            else:
                sent_words = regex_word + sent_words
                sent_word = sent_words.pop(0)
            if marker_word != sent_word:
                logger.warning(
                    f'Correspondance issue between .lab sentence and '
                    f'.markers words -- File: {file_name} -- Sentence: '
                    f'{sent_words_copy} -- Markers: {marker_words} -- '
                    f'Problematic: {sent_word} vs {marker_word}')
                return None
        # consume all marker lines of this word
        while len(markers_old) != 0 and markers_old[0][4] == marker_word_idx:
            begin, end, phone, word, _ = markers_old.pop(0)
            begin = f'{float(begin) - sent_begin:.3f}'
            end = f'{float(end) - sent_begin:.3f}'
            markers.append([begin, end, str(durations.pop(0)), phone, word,
                            str(word_idx)])
        word_idx += 1
        # word boundary between consecutive words
        if len(sent_words) != 0:
            word_bound = sent_words.pop(0) if sent_words[0] in punctuation \
                else whitespace
            if markers_old[0][3] == SIL_WORD_SYMBOL:
                begin, end = markers_old[0][0], markers_old[0][1]
                markers_old.pop(0)
                begin = f'{float(begin) - sent_begin:.3f}'
                end = f'{float(end) - sent_begin:.3f}'
                markers.append([begin, end, str(durations.pop(0)),
                                word_bound, word_bound, str(word_idx)])
            else:
                end_prev = markers[-1][1]
                markers.append([end_prev, end_prev, '0', word_bound,
                                word_bound, str(word_idx)])
            word_idx += 1

    if punctuation_end is not None:
        end_prev = markers[-1][1]
        markers.append([end_prev, end_prev, '0', punctuation_end,
                        punctuation_end, str(word_idx)])
        word_idx += 1
    end_prev = markers[-1][1]
    markers.append([end_prev, end_prev, '0', eos, eos, str(word_idx)])

    if not (len(sent_words) == len(markers_old) == len(durations) == 0):
        logger.warning(
            f'File: {file_name} -- length mismatch: sent_words='
            f'{len(sent_words)}, markers={len(markers_old)}, '
            f'durations={len(durations)}')
        return None
    return markers

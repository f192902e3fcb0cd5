"""The port's text front end (daft_exprt_torch/text/{numbers,cleaners}.py,
generate.phonemize_sentence and prepare_sentences_for_inference,
utils/multiproc.py) against the JAX package's: tests/test_text.py's cases,
a seeded sweep of 0..10^6 through number_to_words and normalize_numbers
(equal strings), and a sentences file phonemized with an MFA dictionary
the test writes, at n_jobs 1 and 2 (identical output files; no ``mfa``
subprocess runs: every word is in the dictionary)."""
import os
import re

import numpy as np
import pytest

from daft_exprt_tpu import generate as jgen
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.text import cleaners as jcl
from daft_exprt_tpu.text import numbers as jnum
from daft_exprt_torch import generate as tgen
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.text import (
    collapse_whitespace, english_cleaners, text_cleaner,
)
from daft_exprt_torch.text.numbers import (
    normalize_numbers, number_to_words, ordinal_to_words,
)
from daft_exprt_torch.text.symbols import (
    arpabet_stressed, pad, punctuation, symbols_english,
)
from daft_exprt_torch.utils import get_nb_jobs, launch_multi_process

SENTENCES = [
    'Dr. Smith paid $5.50 for 3 cats on the 2nd of May, 1984!',
    'In 2005, the company (Co.) sold 1,234 items -- well-known; right?',
    '"Stop," he said: it cost £12 and 3.14 points... Really?!',
    'Mrs. Jones met Lt. Gray at 7 on the 21st.',
    '   ...leading dots and   café naïve résumé.    ',
]


def test_symbol_table():
    assert len(symbols_english) == 76
    assert symbols_english.index(pad) == 0
    assert symbols_english[1] == '~'
    assert symbols_english[2] == ' '
    assert symbols_english[3:7] == [',', '.', '!', '?']
    assert len(set(symbols_english)) == 76


def test_number_to_words():
    assert number_to_words(0) == 'zero'
    assert number_to_words(7) == 'seven'
    assert number_to_words(21) == 'twenty-one'
    assert number_to_words(100) == 'one hundred'
    assert number_to_words(105) == 'one hundred five'
    assert number_to_words(1234) == 'one thousand two hundred thirty-four'
    assert number_to_words(1000000) == 'one million'


def test_ordinals():
    assert ordinal_to_words(1) == 'first'
    assert ordinal_to_words(2) == 'second'
    assert ordinal_to_words(3) == 'third'
    assert ordinal_to_words(12) == 'twelfth'
    assert ordinal_to_words(21) == 'twenty-first'
    assert ordinal_to_words(30) == 'thirtieth'
    assert ordinal_to_words(100) == 'one hundredth'


def test_normalize_numbers():
    assert normalize_numbers('I have 3 cats') == 'I have three cats'
    assert normalize_numbers('in 1984 he left') == \
        'in nineteen eighty-four he left'
    assert normalize_numbers('in 2005') == 'in two thousand five'
    assert normalize_numbers('in 1900') == 'in nineteen hundred'
    assert normalize_numbers('in 1905') == 'in nineteen oh five'
    assert normalize_numbers('$5.50 please') == \
        'five dollars, fifty cents please'
    assert normalize_numbers('3.14 pie') == 'three point fourteen pie'
    assert normalize_numbers('the 2nd time') == 'the second time'
    assert normalize_numbers('1,234 items') == 'twelve thirty-four items'
    assert normalize_numbers('4,234 items') == ('four thousand two hundred '
                                                'thirty-four items')


def test_english_cleaners():
    assert english_cleaners('Hello,  World!') == 'hello, world!'
    assert english_cleaners('Dr. Smith lives on St. James') == \
        'doctor smith lives on saint james'
    assert english_cleaners('well-known fact') == 'well known fact'
    assert english_cleaners('he said: "stop"; then left') == \
        'he said, stop, then left'
    assert english_cleaners('what?!?') == 'what?'
    assert english_cleaners('...leading dots') == 'leading dots'
    assert english_cleaners('café naïve résumé') == 'cafe naive resume'
    assert text_cleaner('abc', 'french') == 'abc'
    assert collapse_whitespace('a \t\n b') == 'a b'


def test_numbers_sweep_matches_jax():
    """Every integer of a seeded draw over 0..10^6 (and the edges), as a
    cardinal, an ordinal, a year-like number, money and a decimal."""
    rng = np.random.RandomState(0)
    values = np.concatenate([np.arange(0, 130), [999, 1000, 1001, 2000,
                                                 2009, 2999, 3000, 10 ** 6],
                             rng.randint(0, 10 ** 6 + 1, 3000)])
    for n in (int(v) for v in values):
        assert number_to_words(n) == jnum.number_to_words(n), n
        assert ordinal_to_words(n) == jnum.ordinal_to_words(n), n
        text = (f'{n} and {n:,} on the {n}th, ${n}.{n % 100:02d}, '
                f'£{n}, {n}.{n % 7} and ${n % 100}')
        assert normalize_numbers(text) == jnum.normalize_numbers(text), text


def test_cleaners_match_jax():
    for s in SENTENCES + ['what?!?', 'a -- b – c—d … e', 'Ł ß ø æ']:
        assert english_cleaners(s) == jcl.english_cleaners(s), s
        assert text_cleaner(s, 'english') == jcl.text_cleaner(s, 'english')


def _dictionary(path):
    """One pronunciation for every word of SENTENCES after cleaning, made
    of ARPAbet phones of the symbol table."""
    rng = np.random.RandomState(1)
    words = sorted({w for s in SENTENCES for w in re.findall(
        rf"[\w']+", english_cleaners(s)) if re.search('[a-z]', w)})
    with open(path, 'w', encoding='utf-8') as f:
        for w in words:
            phones = rng.choice(arpabet_stressed, rng.randint(1, 6))
            f.write(f'{w}\t{" ".join(phones)}\n')
    return words


def _hp(cls, **kw):
    return cls(verbose=False, training_files='x', validation_files='x',
               output_directory='/nonexistent', language='english',
               speakers=['spk'], **kw)


@pytest.fixture
def mfa_home(tmp_path, monkeypatch):
    """A home whose MFA dictionary covers every word; a ``mfa`` on PATH that
    records any call (none may come)."""
    home = tmp_path / 'home'
    dict_dir = home / 'Documents' / 'MFA' / 'pretrained_models' / 'dictionary'
    dict_dir.mkdir(parents=True)
    words = _dictionary(dict_dir / 'english.dict')
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    calls = tmp_path / 'mfa_calls'
    (bin_dir / 'mfa').write_text(f'#!/bin/sh\necho "$@" >> {calls}\n')
    (bin_dir / 'mfa').chmod(0o755)
    monkeypatch.setenv('HOME', str(home))
    monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    return tmp_path, words, calls


def test_phonemize_sentence_matches_jax(mfa_home):
    _, words, calls = mfa_home
    hp, jhp = _hp(HyperParams), _hp(JaxHParams)
    assert hp.mfa_dictionary == jhp.mfa_dictionary
    for s in SENTENCES:
        got = tgen.phonemize_sentence(s, hp)
        assert got == jgen.phonemize_sentence(s, jhp), s
        assert '<unk>' not in got and got[-1] == '~'
        assert all(isinstance(x, list) or x in punctuation or x == ' '
                   for x in got[:-1])
    assert len(words) > 40 and not calls.exists()


def test_prepare_sentences_for_inference(mfa_home):
    root, _, calls = mfa_home
    text_file = root / 'sentences.txt'
    text_file.write_text('\n'.join(SENTENCES + ['', '  ']) + '\n')
    outs = {}
    for name, fn, cls in (('torch', tgen.prepare_sentences_for_inference,
                           HyperParams),
                          ('jax', jgen.prepare_sentences_for_inference,
                           JaxHParams)):
        for n_jobs in (1, 2):
            out_dir = root / f'{name}_{n_jobs}'
            (out_dir / 'stale').mkdir(parents=True)
            sentences, names = fn(str(text_file), str(out_dir), _hp(cls),
                                  n_jobs=n_jobs)
            assert os.listdir(out_dir) == ['sentences_to_generate.txt']
            outs[name, n_jobs] = ((out_dir / 'sentences_to_generate.txt')
                                  .read_text(), sentences, names)
    first = outs['torch', 1]
    assert all(v == first for v in outs.values())
    lines = first[0].splitlines()
    assert len(lines) == len(SENTENCES)
    assert lines[0].startswith('sentences.txt_line0|{')
    assert '<unk>' not in first[0] and not calls.exists()


def _square(x, scale, log_queue=None):
    log_queue.put(None)
    return (x * scale, os.getpid())


def test_launch_multi_process_order_and_jobs():
    assert get_nb_jobs('max') == (os.cpu_count() or 1)
    assert get_nb_jobs('1') == get_nb_jobs(0) == 1
    for n_jobs in (1, 2):
        res = launch_multi_process(range(7), _square, n_jobs, scale=3)
        assert [r[0] for r in res] == [3 * i for i in range(7)]
        if n_jobs == 1:
            assert {r[1] for r in res} == {os.getpid()}
        else:
            assert os.getpid() not in {r[1] for r in res}

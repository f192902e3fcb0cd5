"""English text normalisation for in-the-wild sentences (the port's own
copy of ``daft_exprt_tpu/text/cleaners.py``): ASCII transliteration,
lower-casing, number and abbreviation expansion, punctuation
canonicalisation, whitespace collapsing. Transliteration is self-contained
(no unidecode).
"""
import re
import unicodedata

from daft_exprt_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r'\s+')

_ABBREVIATIONS = [
    ('mrs', 'misess'), ('mr', 'mister'), ('dr', 'doctor'), ('st', 'saint'),
    ('co', 'company'), ('jr', 'junior'), ('maj', 'major'), ('gen', 'general'),
    ('drs', 'doctors'), ('rev', 'reverend'), ('lt', 'lieutenant'),
    ('hon', 'honorable'), ('sgt', 'sergeant'), ('capt', 'captain'),
    ('esq', 'esquire'), ('ltd', 'limited'), ('col', 'colonel'), ('ft', 'fort'),
]
_abbrev_res = [(re.compile(rf'\b{abbr}\.', re.IGNORECASE), full)
               for abbr, full in _ABBREVIATIONS]

# direct replacements applied before NFKD decomposition so typographic
# punctuation survives as its spoken-text equivalent
_TRANSLIT = {
    '‘': "'", '’': "'", '“': '"', '”': '"',
    '–': '-', '—': ' -- ', '…': '...', ' ': ' ',
    'æ': 'ae', 'œ': 'oe', 'ß': 'ss', 'ø': 'o',
    'Ø': 'O', 'ð': 'd', 'þ': 'th', 'ı': 'i',
    'ł': 'l', 'Ł': 'L',
}


def convert_to_ascii(text):
    for src, dst in _TRANSLIT.items():
        text = text.replace(src, dst)
    decomposed = unicodedata.normalize('NFKD', text)
    return ''.join(ch for ch in decomposed if ord(ch) < 128)


def expand_abbreviations(text):
    for regex, replacement in _abbrev_res:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return _whitespace_re.sub(' ', text)


def _canonicalize_punctuation(text):
    text = re.sub('–', ', ', text)
    text = re.sub(' -- ', ', ', text)
    text = re.sub('-', ' ', text)             # hyphens -> space
    text = re.sub('"', '', text)              # drop double quotes
    text = re.sub(';', ',', text)             # semicolon -> comma
    text = re.sub(':', ',', text)             # colon -> comma
    text = re.sub('…', '.', text)
    text = re.sub(r'[\s\.]*\.+[\s\.]*', '. ', text)   # collapse dot runs
    text = re.sub('’', "'", text)
    text = re.sub(r'\(|\)', '', text)         # drop parentheses
    text = re.sub(r'[\s,]*,+[\s,]*', ', ', text)      # collapse comma runs
    text = re.sub('_', ' ', text)
    return text


def _fix_multiple_punctuation(text):
    text = re.sub(r'[\s\.,?!]*\?+[\s\.,?!]*', '? ', text)
    text = re.sub(r'[\s\.,!]*\!+[\s\.,!]*', '! ', text)
    text = re.sub(r'[\s\.,]*\.+[\s\.,]*', '. ', text)
    return text


def _strip_leading_punctuation(text):
    while text.startswith((',', ' ', '.', '!', '?', '-')):
        text = text[1:]
    return text


def english_cleaners(text):
    """Full cleaning pipeline for English text."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = _canonicalize_punctuation(text)
    text = collapse_whitespace(text)
    text = _strip_leading_punctuation(text)
    text = _fix_multiple_punctuation(text)
    return text.strip()


def text_cleaner(text, lang='english'):
    if lang.lower() == 'english':
        return english_cleaners(text)
    return text

"""Symbol inventory for the TTS front end (the port's own copy of
``daft_exprt_tpu/text/symbols.py``).

Mirrors the reference inventory (reference: src/daft_exprt/symbols.py:1-36):
pad '_' at index 0, EOS '~', whitespace, the 4 punctuation marks ',.!?', then
the 69 stress-marked ARPAbet phones — 76 symbols total for English.
"""
import string

# silence/unknown word symbols emitted by the Montreal Forced Aligner in
# .TextGrid files (reference: src/daft_exprt/symbols.py:4-8)
MFA_SIL_WORD_SYMBOL = ''
MFA_SIL_PHONE_SYMBOLS = ['', 'sp', 'sil']
MFA_UNK_WORD_SYMBOL = '<unk>'
MFA_UNK_PHONE_SYMBOL = 'spn'

# canonical silence symbols used in .markers files
SIL_WORD_SYMBOL = '<sil>'
SIL_PHONE_SYMBOL = 'SIL'

pad = '_'
eos = '~'
whitespace = ' '
punctuation = ',.!?'

# stress-marked ARPAbet phone set (69 phones)
arpabet_stressed = [
    'AA0', 'AA1', 'AA2', 'AE0', 'AE1', 'AE2', 'AH0', 'AH1', 'AH2', 'AO0',
    'AO1', 'AO2', 'AW0', 'AW1', 'AW2', 'AY0', 'AY1', 'AY2', 'B', 'CH', 'D',
    'DH', 'EH0', 'EH1', 'EH2', 'ER0', 'ER1', 'ER2', 'EY0', 'EY1', 'EY2',
    'F', 'G', 'HH', 'IH0', 'IH1', 'IH2', 'IY0', 'IY1', 'IY2', 'JH', 'K',
    'L', 'M', 'N', 'NG', 'OW0', 'OW1', 'OW2', 'OY0', 'OY1', 'OY2', 'P',
    'R', 'S', 'SH', 'T', 'TH', 'UH0', 'UH1', 'UH2', 'UW0', 'UW1', 'UW2',
    'V', 'W', 'Y', 'Z', 'ZH',
]

ascii_letters = string.ascii_uppercase + string.ascii_lowercase

# full English symbol table; pad MUST stay at index 0 (zero padding relies on it)
symbols_english = list(pad + eos + whitespace + punctuation) + arpabet_stressed

"""English number -> words normalisation (the port's own copy of
``daft_exprt_tpu/text/numbers.py``): comma removal, currency, decimals,
ordinals, year-style reading for 1000-3000, cardinal expansion. No
third-party dependencies.
"""
import re

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen',
         'fifteen', 'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'),
           (10 ** 3, 'thousand'), (100, 'hundred')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _two_digits_to_words(n):
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f'{_TENS[tens]}-{_ONES[ones]}'


def number_to_words(n):
    """Cardinal words for a non-negative integer (no 'and', no commas)."""
    if n < 0:
        return 'minus ' + number_to_words(-n)
    if n < 100:
        return _two_digits_to_words(n)
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale)
            rem = n % scale
            if rem == 0:
                return f'{head} {name}'
            return f'{head} {name} {number_to_words(rem)}'
    return _two_digits_to_words(n)


def ordinal_to_words(n):
    """Ordinal words, e.g. 21 -> 'twenty-first'."""
    words = number_to_words(n)
    pieces = words.rsplit(' ', 1)
    last = pieces[-1]
    hyphen = last.rsplit('-', 1)
    final = hyphen[-1]
    if final in _ORDINAL_IRREGULAR:
        final_ord = _ORDINAL_IRREGULAR[final]
    elif final.endswith('y'):
        final_ord = final[:-1] + 'ieth'
    elif final.endswith('t'):  # e.g. 'eight' handled above; guard anyway
        final_ord = final + 'h'
    else:
        final_ord = final + 'th'
    hyphen[-1] = final_ord
    pieces[-1] = '-'.join(hyphen)
    return ' '.join(pieces)


def _year_to_words(n):
    """Read 1000 < n < 3000 the way years are spoken."""
    if n == 2000:
        return 'two thousand'
    if 2000 < n < 2010:
        return 'two thousand ' + number_to_words(n % 100)
    if n % 100 == 0:
        return number_to_words(n // 100) + ' hundred'
    century, rem = divmod(n, 100)
    if rem < 10:
        return f'{number_to_words(century)} oh {number_to_words(rem)}'
    return f'{number_to_words(century)} {_two_digits_to_words(rem)}'


_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'([0-9]+)(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return (f'{dollars} dollar{"s" if dollars != 1 else ""}, '
                f'{cents} cent{"s" if cents != 1 else ""}')
    if dollars:
        return f'{dollars} dollar{"s" if dollars != 1 else ""}'
    if cents:
        return f'{cents} cent{"s" if cents != 1 else ""}'
    return 'zero dollars'


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        return _year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text):
    text = _comma_number_re.sub(lambda m: m.group(1).replace(',', ''), text)
    text = _pounds_re.sub(r'\1 pounds', text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace('.', ' point '), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_number, text)
    return text

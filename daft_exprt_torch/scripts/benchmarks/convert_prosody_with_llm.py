"""LLM-based American -> Indian English prosody conversion benchmark (the
port's ``scripts/benchmarks/convert_prosody_with_llm.py``).

    python -m daft_exprt_torch.scripts.benchmarks.convert_prosody_with_llm \
        -spf PROSODY -o OUT [--model gpt-4] [--max_attempts 5] [--device cuda]

An in-context-learning prompt describing the accent transformation rules
with example pairs, structural validation of the model's output against the
input symbol sequence, and a bounded critique/repair retry loop. The OpenAI
client is a runtime dependency imported when the tool runs (any
chat-completions endpoint through ``OPENAI_BASE_URL``); nothing runs on the
device, but the tool resolves ``--device`` as every tool of the port does.
"""
import argparse
import ast
import logging
import tempfile

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)

SYSTEM_PROMPT = """\
You are a prosody-transformation engine converting American English prosody
to Indian English prosody at the phoneme level.

Input: a Python list of tuples (symbol, duration_frames, log_pitch, energy).
Symbols are ARPAbet phones plus '_' (pad), '~' (end of sentence), ' '
(word boundary) and punctuation ',.!?'. duration_frames is an integer mel
frame count; log_pitch is normalized log-F0 (0.0 = unvoiced); energy is a
per-symbol mel-energy mean (0.0 for non-acoustic symbols).

Transform the prosody per these Indian-English tendencies:
1. Syllable-timed rhythm: compress the duration ratio between stressed and
   unstressed vowels (lengthen reduced vowels ~10-20%, shorten very long
   stressed vowels ~10-15%).
2. Higher pitch range and more pitch movement within words: amplify
   within-word pitch deviations around the utterance mean by ~15-25%.
3. Phrase-final rises on non-final phrases: raise pitch slightly on the
   2-3 voiced symbols before ',' boundaries.
4. Retroflex-influenced consonants keep their durations.
5. Slightly increased energy on word-final syllables.
6. Never change the symbols, their order, or the list length; keep 0.0
   pitch entries at 0.0; keep durations positive integers.

Return ONLY the transformed Python list of tuples, no commentary."""

ICL_EXAMPLES = [
    (
        "[('DH', 3, 4.9, 12.1), ('AH0', 4, 4.95, 13.0), (' ', 2, 0.0, 0.0), "
        "('K', 3, 0.0, 10.2), ('AE1', 9, 5.1, 15.3), ('T', 4, 0.0, 9.8), "
        "('~', 0, 0.0, 0.0)]",
        "[('DH', 3, 4.95, 12.1), ('AH0', 5, 5.02, 13.2), (' ', 2, 0.0, 0.0), "
        "('K', 3, 0.0, 10.2), ('AE1', 8, 5.18, 15.5), ('T', 4, 0.0, 10.1), "
        "('~', 0, 0.0, 0.0)]",
    ),
]


def validate_output(original, transformed):
    """Structural checks of the model's output against the input tuples.
    Returns (ok, message)."""
    if not isinstance(transformed, (list, tuple)):
        return False, 'output is not a list'
    if len(transformed) != len(original):
        return False, (f'length changed: {len(transformed)} vs '
                       f'{len(original)}')
    for idx, (orig, new) in enumerate(zip(original, transformed)):
        if not (isinstance(new, (list, tuple)) and len(new) == 4):
            return False, f'entry {idx} is not a 4-tuple'
        if str(new[0]) != str(orig[0]):
            return False, f'symbol changed at {idx}: {new[0]} vs {orig[0]}'
        if int(new[1]) < 0:
            return False, f'negative duration at {idx}'
        if float(orig[2]) == 0.0 and float(new[2]) != 0.0:
            return False, f'unvoiced symbol got pitch at {idx}'
    return True, 'ok'


def convert_prosody(tuples, client, model='gpt-4', max_attempts=5):
    """In-context conversion with a critique/repair loop: each invalid or
    unparsable answer goes back to the model with the reason, up to
    ``max_attempts`` calls of ``client.chat.completions.create``."""
    messages = [{'role': 'system', 'content': SYSTEM_PROMPT}]
    for src, dst in ICL_EXAMPLES:
        messages.append({'role': 'user', 'content': src})
        messages.append({'role': 'assistant', 'content': dst})
    messages.append({'role': 'user', 'content': repr(tuples)})

    last_error = None
    for attempt in range(max_attempts):
        response = client.chat.completions.create(model=model,
                                                  messages=messages)
        text = response.choices[0].message.content.strip()
        if text.startswith('```'):
            text = text.strip('`')
            if text.startswith('python'):
                text = text[len('python'):]
        try:
            parsed = ast.literal_eval(text.strip())
        except (SyntaxError, ValueError) as exc:
            last_error = f'unparsable output: {exc}'
            parsed = None
        if parsed is not None:
            ok, msg = validate_output(tuples, parsed)
            if ok:
                return [(str(s), int(d), float(p), float(e))
                        for s, d, p, e in parsed]
            last_error = msg
        _logger.warning(f'attempt {attempt + 1} failed: {last_error}')
        messages.append({'role': 'assistant', 'content': text})
        messages.append({
            'role': 'user',
            'content': f'Your output was invalid: {last_error}. Return the '
                       f'corrected transformed list only.'})
    raise RuntimeError(f'conversion failed after {max_attempts} attempts: '
                       f'{last_error}')


def run(args, client):
    """Converts every utterance of the symbol-prosody file with ``client``
    and writes ``name|[(symbol, duration, pitch, energy), ...]`` lines;
    returns {name: converted tuples}."""
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.scripts.synthesize import parse_symbol_prosody_file

    with tempfile.TemporaryDirectory() as td:
        hparams = HyperParams(verbose=False, training_files='unused',
                              validation_files='unused',
                              output_directory=td, language='english',
                              speakers=['spk'])
    _, file_names, prosody = parse_symbol_prosody_file(
        args.symbol_prosody_file, hparams)

    out = {}
    with open(args.output_file, 'w', encoding='utf-8') as f:
        for name, entry in zip(file_names, prosody):
            tuples = list(zip(entry['symbols'], entry['durations_frames'],
                              entry['pitch'], entry['energy']))
            converted = convert_prosody(tuples, client, model=args.model,
                                        max_attempts=args.max_attempts)
            rounded = [(s, d, round(p, 3), round(e, 3))
                       for s, d, p, e in converted]
            f.write(f'{name}|{rounded!r}\n')
            out[name] = converted
            _logger.info(f'{name}: converted {len(tuples)} symbols')
    _logger.info(f'wrote {args.output_file}')
    return out


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-spf', '--symbol_prosody_file', type=str,
                        required=True)
    parser.add_argument('-o', '--output_file', type=str, required=True)
    parser.add_argument('--model', type=str, default='gpt-4')
    parser.add_argument('--max_attempts', type=int, default=5)
    add_device_flag(parser)
    return parser


def main(argv=None, client=None):
    """``client``: a chat-completions client (default ``openai.OpenAI()``,
    imported here)."""
    args = parse_args(build_parser(), argv)
    if client is None:
        try:
            from openai import OpenAI
        except ImportError as exc:
            raise ImportError('openai client required: pip install openai '
                              '(any chat-completions endpoint works via '
                              'OPENAI_BASE_URL)') from exc
        client = OpenAI()
    return run(args, client)


if __name__ == '__main__':
    main()

"""Minimal Praat TextGrid parser, long and short text formats (the port's
own copy of ``daft_exprt_tpu/frontend/textgrid.py``): interval tiers with
(start, end, text), empty intervals included, for reading the Montreal
Forced Aligner's output.
"""
import re
from typing import Dict, List, Tuple

Interval = Tuple[float, float, str]


def _unquote(s):
    s = s.strip()
    if s.startswith('"') and s.endswith('"'):
        s = s[1:-1]
    return s.replace('""', '"')


def read_textgrid(path) -> Dict[str, List[Interval]]:
    """Parse a TextGrid file → {tier_name: [(start, end, text), ...]}."""
    with open(path, 'r', encoding='utf-8-sig', errors='replace') as f:
        content = f.read()
    if 'IntervalTier' not in content:
        raise ValueError(f'{path}: no interval tiers found')
    if re.search(r'item\s*\[', content):
        return _parse_long(content)
    return _parse_short(content)


def _parse_long(content) -> Dict[str, List[Interval]]:
    tiers: Dict[str, List[Interval]] = {}
    # split on item [n]: blocks (skip the item [] header)
    blocks = re.split(r'item\s*\[\d+\]\s*:', content)[1:]
    for block in blocks:
        cls = re.search(r'class\s*=\s*"([^"]*)"', block)
        if not cls or cls.group(1) != 'IntervalTier':
            continue
        name = re.search(r'name\s*=\s*"([^"]*)"', block)
        tier_name = name.group(1) if name else ''
        intervals = []
        for m in re.finditer(
                r'intervals\s*\[\d+\]\s*:\s*'
                r'xmin\s*=\s*([\d.eE+-]+)\s*'
                r'xmax\s*=\s*([\d.eE+-]+)\s*'
                r'text\s*=\s*"((?:[^"]|"")*)"', block):
            intervals.append((float(m.group(1)), float(m.group(2)),
                              _unquote(f'"{m.group(3)}"')))
        tiers[tier_name] = intervals
    return tiers


def _parse_short(content) -> Dict[str, List[Interval]]:
    lines = [line.strip() for line in content.splitlines() if line.strip()]
    tiers: Dict[str, List[Interval]] = {}
    i = 0
    # skip header: file type, object class, xmin, xmax, <exists>, n_tiers
    while i < len(lines) and '"IntervalTier"' not in lines[i]:
        i += 1
    while i < len(lines):
        if '"IntervalTier"' not in lines[i]:
            i += 1
            continue
        name = _unquote(lines[i + 1])
        n = int(float(lines[i + 4]))
        i += 5
        intervals = []
        for _ in range(n):
            xmin = float(lines[i])
            xmax = float(lines[i + 1])
            text = _unquote(lines[i + 2])
            intervals.append((xmin, xmax, text))
            i += 3
        tiers[name] = intervals
    return tiers

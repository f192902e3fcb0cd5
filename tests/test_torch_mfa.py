"""The port's alignment front end (daft_exprt_torch/frontend/{textgrid,
mfa}.py) against the JAX package's: TextGrids in the long and the short
text format, ``textgrid_to_markers`` and ``extract_markers`` on them
(equal markers, the same refusals), and ``mfa()`` with a stand-in ``mfa``
executable on PATH that records its arguments and writes TextGrids where
the aligner writes them: both packages must give it the same arguments
and write the same ``.lab`` and ``.markers`` files."""
import logging
import os

import pytest

from daft_exprt_tpu.frontend import mfa as jmfa
from daft_exprt_tpu.frontend import textgrid as jtg
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_torch.frontend import mfa as tmfa
from daft_exprt_torch.frontend import textgrid as ttg
from daft_exprt_torch.hparams import HyperParams

# (start, end, text) per tier; '' is MFA's silent word, 'sp' and 'sil'
# its silent phones
WORDS = [(0.0, 0.21, ''), (0.21, 0.68, 'hello'), (0.68, 0.83, ''),
         (0.83, 1.29, 'world'), (1.29, 1.5, '')]
PHONES = [(0.0, 0.1, 'sil'), (0.1, 0.21, 'sp'), (0.21, 0.33, 'HH'),
          (0.33, 0.68, 'OW1'), (0.68, 0.83, 'sp'), (0.83, 0.97, 'W'),
          (0.97, 1.12, 'ER1'), (1.12, 1.2, 'L'), (1.2, 1.29, 'D'),
          (1.29, 1.5, 'sil')]


def long_textgrid(tiers, xmax=1.5):
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', '',
           'xmin = 0', f'xmax = {xmax}', 'tiers? <exists>',
           f'size = {len(tiers)}', 'item []:']
    for i, (name, intervals) in enumerate(tiers, 1):
        out += [f'    item [{i}]:', '        class = "IntervalTier"',
                f'        name = "{name}"', '        xmin = 0',
                f'        xmax = {xmax}',
                f'        intervals: size = {len(intervals)}']
        for j, (s, e, t) in enumerate(intervals, 1):
            t = t.replace('"', '""')
            out += [f'        intervals [{j}]:', f'            xmin = {s}',
                    f'            xmax = {e}', f'            text = "{t}"']
    return '\n'.join(out) + '\n'


def short_textgrid(tiers, xmax=1.5):
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', '', '0',
           str(xmax), '<exists>', str(len(tiers))]
    for name, intervals in tiers:
        out += ['"IntervalTier"', f'"{name}"', '0', str(xmax),
                str(len(intervals))]
        for s, e, t in intervals:
            out += [str(s), str(e), '"' + t.replace('"', '""') + '"']
    return '\n'.join(out) + '\n'


GRIDS = {
    'long': long_textgrid([('words', WORDS), ('phones', PHONES)]),
    'short': short_textgrid([('words', WORDS), ('phones', PHONES)]),
    # a quoted word and a point tier the parser skips
    'quoted': long_textgrid([('words', WORDS[:1] + [(0.21, 0.68,
                                                     'say "hi"')]
                              + WORDS[2:]), ('phones', PHONES)]).replace(
        'item [2]:', 'item [2]:\n        class = "TextTier"\n'
        'item [3]:', 1),
    # unknown word: skipped
    'unk': long_textgrid([('words', WORDS[:3] + [(0.83, 1.29, '<unk>')]
                           + WORDS[4:]), ('phones', PHONES)]),
    # a silence inside a word: skipped
    'sil_in_word': short_textgrid([
        ('words', WORDS), ('phones', PHONES[:6] + [(0.97, 1.12, 'sp')]
                           + PHONES[7:])]),
    # a phone across a word boundary: refused
    'overlap': short_textgrid([
        ('words', WORDS), ('phones', PHONES[:4] + [(0.68, 0.9, 'sp'),
                                                   (0.9, 0.97, 'W')]
                           + PHONES[6:])]),
}


@pytest.fixture
def grid_dir(tmp_path):
    for name, text in GRIDS.items():
        (tmp_path / f'{name}.TextGrid').write_text(text)
    return tmp_path


def test_read_textgrid_matches_jax(grid_dir):
    for name in GRIDS:
        path = str(grid_dir / f'{name}.TextGrid')
        got = ttg.read_textgrid(path)
        assert got == jtg.read_textgrid(path), name
        assert [t for _, _, t in got['phones']][:3] == ['sil', 'sp', 'HH']
    assert ttg.read_textgrid(str(grid_dir / 'long.TextGrid')) == \
        ttg.read_textgrid(str(grid_dir / 'short.TextGrid'))
    bad = grid_dir / 'bad.txt'
    bad.write_text('no tiers')
    with pytest.raises(ValueError):
        ttg.read_textgrid(str(bad))


def test_textgrid_to_markers_matches_jax(grid_dir):
    quiet = logging.getLogger('quiet')
    for name in ('long', 'short', 'quoted', 'unk', 'sil_in_word'):
        path = str(grid_dir / f'{name}.TextGrid')
        got = tmfa.textgrid_to_markers(path, quiet)
        assert got == jmfa.textgrid_to_markers(path, quiet), name
    long = tmfa.textgrid_to_markers(str(grid_dir / 'long.TextGrid'))
    assert long[0] == ['0.210', '0.330', 'HH', 'hello', '1']
    assert [m[2] for m in long] == ['HH', 'OW1', 'SIL', 'W', 'ER1', 'L', 'D']
    assert tmfa.textgrid_to_markers(str(grid_dir / 'unk.TextGrid'),
                                    quiet) is None
    for mod in (tmfa, jmfa):
        with pytest.raises(AssertionError, match='overlap'):
            mod.textgrid_to_markers(str(grid_dir / 'overlap.TextGrid'))


def test_extract_markers_matches_jax(tmp_path):
    files = {}
    for side, mod in (('torch', tmfa), ('jax', jmfa)):
        d = tmp_path / side
        d.mkdir()
        for name, text in GRIDS.items():
            (d / f'{name}.TextGrid').write_text(text)
        mod.extract_markers(str(d), n_jobs=2)
        files[side] = {f: (d / f).read_text() for f in sorted(os.listdir(d))
                       if f.endswith('.markers')}
    assert files['torch'] == files['jax']
    assert sorted(files['torch']) == ['long.markers', 'quoted.markers',
                                      'short.markers']
    # a second call leaves done files alone
    (tmp_path / 'torch' / 'long.markers').write_text('kept')
    tmfa.extract_markers(str(tmp_path / 'torch'))
    assert (tmp_path / 'torch' / 'long.markers').read_text() == 'kept'


STUB = '''#!/usr/bin/env python3
"""A stand-in for the aligner: records argv, then writes a TextGrid per
.lab of the corpus into <out>/wavs, as the aligner does."""
import os, sys
with open(os.environ['MFA_STUB_LOG'], 'a') as f:
    f.write(' '.join(sys.argv[1:]) + '\\n')
corpus, out = sys.argv[2], sys.argv[5]
grid = open(os.environ['MFA_STUB_GRID']).read()
os.makedirs(os.path.join(out, 'wavs'), exist_ok=True)
for lab in os.listdir(os.path.join(corpus, 'wavs')):
    if lab.endswith('.lab'):
        with open(os.path.join(out, 'wavs', lab[:-4] + '.TextGrid'),
                  'w') as f:
            f.write(grid)
'''


def _corpus(root, speakers):
    for spk in speakers:
        wavs = root / spk / 'wavs'
        wavs.mkdir(parents=True)
        for i in range(3):
            (wavs / f'utt_{i}.wav').write_bytes(b'')
        (root / spk / 'metadata.csv').write_text(
            'utt_0|Hello, Dr. World!\nutt_1|Hello world 2\n'
            'utt_2|hello\nutt_2|twice\n')


def test_mfa_with_a_stub_aligner(tmp_path, monkeypatch):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    (bin_dir / 'mfa').write_text(STUB)
    (bin_dir / 'mfa').chmod(0o755)
    grid = tmp_path / 'grid.TextGrid'
    grid.write_text(GRIDS['long'])
    monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setenv('MFA_STUB_GRID', str(grid))
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    speakers = ['spk_a', 'spk_b']
    out = {}
    for side, mod, cls in (('torch', tmfa, HyperParams),
                           ('jax', jmfa, JaxHParams)):
        root = tmp_path / side
        _corpus(root, speakers)
        log = tmp_path / f'{side}.argv'
        monkeypatch.setenv('MFA_STUB_LOG', str(log))
        hp = cls(verbose=False, training_files='x', validation_files='x',
                 output_directory='/nonexistent', language='english',
                 speakers=speakers)
        mod.mfa(str(root), hp, n_jobs=3)
        files = {os.path.relpath(os.path.join(d, f), root):
                 open(os.path.join(d, f)).read()
                 for d, _, fs in os.walk(root) for f in fs
                 if f.endswith(('.markers', '.lab', '.TextGrid'))}
        out[side] = (log.read_text().replace(str(root), '<root>'), files)
        # already aligned: no second call, markers kept
        mod.mfa(str(root), hp, n_jobs=3)
        assert log.read_text().count('\n') == len(speakers)
    assert out['torch'] == out['jax']
    argv, files = out['torch']
    home = str(tmp_path / 'home')
    assert argv.splitlines()[0] == (
        f'align <root>/spk_a {home}/Documents/MFA/pretrained_models/'
        f'dictionary/english.dict {home}/Documents/MFA/pretrained_models/'
        f'acoustic/english.zip <root>/spk_a/align -t <root>/spk_a/tmp/align '
        f'-j 3 -v -c')
    assert files['spk_a/align/utt_0.lab'] == 'hello, doctor world!'
    # utt_2 has two transcripts: no .lab, so no alignment
    assert 'spk_a/align/utt_2.lab' not in files
    assert sorted(f for f in files if f.endswith('.markers')) == [
        f'{s}/align/utt_{i}.markers' for s in speakers for i in range(2)]

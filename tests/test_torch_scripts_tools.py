"""The port's command-line tools (daft_exprt_torch/scripts) against the
top-level scripts (the JAX package's) on the CPU: every tool's flags, the
symbol-prosody parser and the small host tools.

- Flags: each tool's parser holds the JAX script's arguments (names,
  defaults, types, choices, sub-commands) plus ``--device`` (default
  cuda), read from the parsers and their --help text. The differences by
  design: ``precompute_ECAPA_spk_embeddings``' ``--device`` (the
  encoder's) defaults to cuda, not cpu; ``qualify_int8`` adds
  ``--ptc_min_batch`` (default 1), which stands for the JAX script's
  ``DAFT_PTC_MIN_BATCH=1``; ``verify_pitch_predictor_shape`` has no parser
  in JAX (the port's takes ``--device`` only).
- The prosody parser: the same sentences, names and prosody as JAX's on
  both line forms and the committed bank, the same errors.
- ``make_style_bank``, ``compute_spk_stats_from_prosody``,
  ``format_dataset`` and ``precompute_ECAPA_spk_embeddings`` (a seeded
  stand-in encoder) write identical files; ``extract_symbol_prosody
  --skip_mfa`` the same tuples (pitch and energy within one step of their
  3-decimal rounding).
"""
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest

from daft_exprt_tpu.frontend import ecapa as jax_ecapa
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.hparams import HyperParams

from tests.synth_data import build_synthetic_dataset
from tests.torch_port_utils import max_abs, one_torch_thread
from tests.torch_scripts_utils import (
    HP_KW, REPO, help_text, jax_parser, port_tool, prosody_lines, tone_wav,
)

TOOLS = ('synthesize', 'training', 'adapt_speaker', 'adapt_accent',
         'train_pitch_predictor', 'make_style_bank',
         'compute_spk_stats_from_prosody', 'precompute_ECAPA_spk_embeddings',
         'extract_symbol_prosody', 'format_dataset', 'grid_search_accent',
         'qualify_int8', 'evaluation/compute_wer_and_accent_metrics',
         'evaluation/compare_pitch_curves', 'hifigan_sanity_check',
         'verify_mel_spec', 'generate_augmentation_examples',
         'visualize_pitch_prediction', 'verify_pitch_predictor_shape',
         'analyze_embedding_manifold',
         'benchmarks/convert_prosody_with_llm')


def _actions(parser):
    """{dest: its flags, default, type, choices, nargs, required, const},
    sub-commands as {dest: {command: their actions}}."""
    out = {}
    for a in parser._actions:
        if a.dest == 'help':
            continue
        if a.choices is not None and isinstance(a.choices, dict):
            out[a.dest] = {k: _actions(v) for k, v in a.choices.items()}
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.type,
                       a.choices, a.nargs, a.required, a.const)
    return out


def _flags(text):
    return set(re.findall(r'(?<![\w-])(--?[A-Za-z][\w]*)', text))


@pytest.mark.parametrize('name', TOOLS)
def test_flags_are_the_jax_scripts_plus_device(name):
    tp = port_tool(name).build_parser()
    got = _actions(tp)
    device = got.pop('device')
    assert device[:2] == (('--device',), 'cuda'), device
    if name == 'verify_pitch_predictor_shape':     # no parser in JAX
        assert got == {}
        assert _flags(help_text(port_tool(name).main)) == {'--device', '-h',
                                                           '--help'}
        return
    jp = jax_parser(name)
    want = _actions(jp)
    if name == 'precompute_ECAPA_spk_embeddings':
        assert want.pop('device')[:2] == (('--device',), 'cpu')
    if name == 'qualify_int8':                     # DAFT_PTC_MIN_BATCH=1
        assert got.pop('ptc_min_batch')[:3] == (('--ptc_min_batch',), 1, int)
    assert got == want
    # --help: the JAX script's flags and --device on the top-level parser
    # (precompute_ECAPA_spk_embeddings has its own), the JAX script's on
    # each sub-command's
    own = name == 'precompute_ECAPA_spk_embeddings'
    extra = {'--ptc_min_batch'} if name == 'qualify_int8' else set()
    texts = [(help_text(jp.parse_args), help_text(port_tool(name).main),
              set() if own else {'--device'} | extra)]
    for cmd in (want.get('command') or {}):
        argv = ('--data_set_dir', 'x', '-en', 'y', cmd, '--help')
        texts.append((help_text(jp.parse_args, argv),
                      help_text(port_tool(name).main, argv), set()))
    for j_text, t_text, extra in texts:
        assert _flags(t_text) == _flags(j_text) | extra, name


def test_symbol_prosody_parser_matches_jax(tmp_path):
    from scripts.synthesize import parse_symbol_prosody_file as jparse
    parse = port_tool('synthesize').parse_symbol_prosody_file
    hp, jhp = HyperParams(**HP_KW), JaxHParams(**HP_KW)
    f = tmp_path / 'p.prosody'
    f.write_text(''.join(prosody_lines(hp, np.random.RandomState(0), 4)))
    bank = os.path.join(REPO, 'scripts', 'style_bank', 'english',
                        'bank.prosody')
    for path in (str(f), bank):
        assert parse(path, hp) == jparse(path, jhp)
    f.write_text("[('XX', 3, 5.1, 12.0)]\n")
    for p, h in ((parse, hp), (jparse, jhp)):
        with pytest.raises(ValueError, match='XX'):
            p(str(f), h)
    f.write_text("[['HH'], [3, 4], [5.1], [12.0]]\n")
    with pytest.raises(ValueError, match='4 parallel arrays'):
        parse(str(f), hp)


def test_style_bank_and_stats_match_jax(tmp_path):
    """make_style_bank --features_dir (wavs found under --data_set_dir),
    then compute_spk_stats_from_prosody on the bank's prosody: the same
    files as the JAX scripts'."""
    _, _, features = build_synthetic_dataset(str(tmp_path / 'ds'),
                                             files_per_speaker=3)
    dataset = tmp_path / 'dataset'
    for spk in ('speaker_0', 'speaker_1'):
        (dataset / spk / 'wavs').mkdir(parents=True)
        for i in range(3):
            save_wav(str(dataset / spk / 'wavs' / f'utt_{i:03d}.wav'),
                     tone_wav(120.0 + 30 * i, 0.3, seed=i), 22050)
    outs = {}
    for which in ('jax', 'port'):
        bank = str(tmp_path / f'bank_{which}')
        argv = ['-fd', features, '-dd', str(dataset), '-out', bank, '-n',
                '4', '--seed', '3']
        stats = str(tmp_path / f'stats_{which}.json')
        argv2 = ['-spf', os.path.join(bank, 'bank.prosody'), '-o', stats]
        if which == 'jax':
            for script, args in (('make_style_bank', argv),
                                 ('compute_spk_stats_from_prosody', argv2)):
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(sys, 'argv', [script] + args)
                    runpy.run_path(os.path.join(REPO, 'scripts',
                                                f'{script}.py'),
                                   run_name='__main__')
        else:
            port_tool('make_style_bank').main(argv + ['--device', 'cpu'])
            port_tool('compute_spk_stats_from_prosody').main(
                argv2 + ['--device', 'cpu'])
        outs[which] = (bank, stats)
    (jb, js_), (tb, ts_) = outs['jax'], outs['port']
    assert sorted(os.listdir(tb)) == sorted(os.listdir(jb))
    assert sum(f.endswith('.wav') for f in os.listdir(tb)) == 4
    for f in os.listdir(jb):
        with open(os.path.join(jb, f), 'rb') as a, \
                open(os.path.join(tb, f), 'rb') as b:
            assert a.read() == b.read(), f
    with open(js_) as a, open(ts_) as b:
        assert json.load(a) == json.load(b)


def test_format_dataset_matches_jax(tmp_path):
    lj = tmp_path / 'LJSpeech-1.1'
    (lj / 'wavs').mkdir(parents=True)
    rows = []
    for i in range(3):
        save_wav(str(lj / 'wavs' / f'LJ001-{i:04d}.wav'),
                 tone_wav(150.0, 0.1), 22050)
        rows.append(f'LJ001-{i:04d}|Raw {i}.|Normalized {i}.\n')
    rows.append('LJ001-0099|missing|missing\n')
    (lj / 'metadata.csv').write_text(''.join(rows))
    esd = tmp_path / 'ESD'
    for spk in ('0011', '0012'):
        for emo in ('Neutral', 'Happy'):
            d = esd / spk / emo
            d.mkdir(parents=True)
            for i in range(2):
                save_wav(str(d / f'{spk}_{emo}_{i}.wav'),
                         tone_wav(130.0, 0.1), 22050)
        (esd / spk / f'{spk}.txt').write_text(''.join(
            f'{spk}_{emo}_{i}\ttext {i}\tNeutral\n'
            for emo in ('Neutral', 'Happy') for i in range(2)))
    for which in ('jax', 'port'):
        argv = ['--ljspeech_root', str(lj), '--esd_root', str(esd), '-out',
                str(tmp_path / which)]
        if which == 'jax':
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sys, 'argv', ['format_dataset'] + argv)
                runpy.run_path(os.path.join(REPO, 'scripts',
                                            'format_dataset.py'),
                               run_name='__main__')
        else:
            port_tool('format_dataset').main(argv + ['--device', 'cpu'])

    def tree(root):
        out = {}
        for dirpath, _, files in os.walk(root):
            for f in files:
                p = os.path.join(dirpath, f)
                rel = os.path.relpath(p, root)
                out[rel] = os.readlink(p) if os.path.islink(p) else \
                    open(p).read()
        return out
    got, want = tree(tmp_path / 'port'), tree(tmp_path / 'jax')
    assert got == want and len(got) == 3 + 4 + 3


def test_precompute_ecapa_matches_jax(tmp_path):
    """The tool over a file list with a seeded stand-in encoder: the same
    .spk_emb.npy files as the JAX package's precompute; existing files
    kept unless --overwrite."""
    rng = np.random.RandomState(0)
    proj = rng.randn(64, 192).astype(np.float32)

    def embed(wav):
        frames = np.asarray(wav[:64 * (len(wav) // 64)]).reshape(-1, 64)
        return np.tanh(np.abs(frames).mean(0) @ proj)

    lists = {}
    for which in ('jax', 'port'):
        feats = tmp_path / which / 'features' / 'spk'
        feats.mkdir(parents=True)
        wavs = tmp_path / which / 'dataset' / 'spk' / 'wavs'
        wavs.mkdir(parents=True)
        for i in range(3):
            save_wav(str(wavs / f'u{i}.wav'), tone_wav(120.0 + 40 * i, 0.5,
                                                       seed=i), 22050)
        lst = tmp_path / which / 'train.txt'
        lst.write_text(''.join(f'{feats}|u{i}|0\n' for i in range(3)))
        lists[which] = (feats, lst)
    n_j = jax_ecapa.compute_ecapa_for_file_lists(
        [str(lists['jax'][1])], dataset_dir=str(tmp_path / 'jax' / 'dataset'),
        embed_fn=embed)
    tool = port_tool('precompute_ECAPA_spk_embeddings')
    argv = ['-tf', str(lists['port'][1]), '-dd',
            str(tmp_path / 'port' / 'dataset'), '--device', 'cpu']
    assert tool.main(argv, embed_fn=embed) == n_j == 3
    for i in range(3):
        a = np.load(lists['jax'][0] / f'u{i}.spk_emb.npy')
        b = np.load(lists['port'][0] / f'u{i}.spk_emb.npy')
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tool.main(argv, embed_fn=embed) == 0
    assert tool.main(argv + ['--overwrite'], embed_fn=embed) == 3


def test_extract_symbol_prosody_skip_mfa_matches_jax(tmp_path):
    """--skip_mfa on alignments already in the work directory, both
    output formats."""
    import scripts.extract_symbol_prosody as jesp
    from tests.test_torch_frontend import PHONES, voice
    work = tmp_path / 'work'
    (work / 'align').mkdir(parents=True)
    wavs = work / 'corpus' / 'speaker' / 'wavs'
    wavs.mkdir(parents=True)
    manifest = []
    for i, f0 in enumerate((140, 210)):
        save_wav(str(wavs / f'utt_{i:04d}.wav'), voice(f0), 22050)
        with open(work / 'align' / f'utt_{i:04d}.markers', 'w') as f:
            f.writelines(f'{b:.3f}\t{e:.3f}\t{p}\t{w}\t{wi}\n'
                         for b, e, p, w, wi in PHONES)
        manifest.append(f'/audio/utt{i}.wav|hello, world')
    (tmp_path / 'manifest.txt').write_text('\n'.join(manifest) + '\n')
    for fmt in ('tuples', 'arrays'):
        outs = {}
        for which in ('jax', 'port'):
            out = str(tmp_path / f'{which}_{fmt}.prosody')
            argv = ['-m', str(tmp_path / 'manifest.txt'), '-o', out,
                    '--skip_mfa', '--work_dir', str(work),
                    '--output_format', fmt, '--pitch_method', 'device']
            if which == 'jax':
                jesp.main(jax_parser('extract_symbol_prosody').parse_args(
                    argv))
            else:
                with one_torch_thread():
                    assert port_tool('extract_symbol_prosody').main(
                        argv + ['--device', 'cpu']) == 2
            outs[which] = out
        hp = HyperParams(**HP_KW)
        parse = port_tool('synthesize').parse_symbol_prosody_file
        (_, jn, jp), (_, tn, tp) = (parse(outs[w], hp)
                                    for w in ('jax', 'port'))
        assert tn == jn == ['utt0', 'utt1']
        for a, b in zip(tp, jp):
            assert a['symbols'] == b['symbols']
            assert a['durations_frames'] == b['durations_frames']
            for k in ('pitch', 'energy'):
                assert max_abs(a[k], b[k]) <= 1.01e-3, k


def test_generator_state_dict_round_trips():
    """The vocoder checkpoint the CLI reads (``--vocoder_checkpoint``): the
    port's params written as a reference generator state dict and read
    back by ``load_torch_generator`` are the same params."""
    import torch
    from daft_exprt_torch.models import hifigan as th
    from tests.test_torch_generate import VOC_CFG
    params = th.init_generator_params(3, VOC_CFG, device='cpu')
    sd = th.generator_state_dict(params, VOC_CFG)
    assert all(k.endswith(('.weight', '.bias')) for k in sd)
    back = th.convert_torch_generator(sd, VOC_CFG)

    def leaves(tree, prefix=''):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f'{prefix}{k}/')
            else:
                yield f'{prefix}{k}', v
    got, want = dict(leaves(back)), dict(leaves(params))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

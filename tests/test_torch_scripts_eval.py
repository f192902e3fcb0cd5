"""The port's evaluation and diagnostic tools (daft_exprt_torch/scripts/
evaluation/*, hifigan_sanity_check, verify_mel_spec,
generate_augmentation_examples, visualize_pitch_prediction,
verify_pitch_predictor_shape, analyze_embedding_manifold,
benchmarks/convert_prosody_with_llm) against the top-level scripts on the
CPU:

- the numpy helpers (WER, nPVI, DTW, the pitch-curve correlation, the mel
  augmentations, the LLM output's validation) equal to JAX's;
- ``evaluate`` prosody-only and with a checkpoint (the accent-embedding
  distance): the same rows, the prosody metrics within rel 1e-3 (the grid
  search's band), the distance within 1e-4, with both packages' pitch
  tracker given one F0 track (the port's tracker on the CPU). The trackers
  are held to each other by test_torch_pitch.py on >= 99% of a corpus's
  lines; on these short stand-in recordings they part on the last two or
  three frames of some files (the window reaches past the end), and one
  such frame moves a file's pitch std by semitones and the accent distance
  by ~4%. The port's evaluate also runs once on its own tracker, its
  energy nPVI (which no tracker moves) held to JAX's;
- the vocoder tools over test_torch_generate's small float32 HiFi-GAN
  served by both packages: wavs within rel-L2 2e-3 (its vocoder band);
- the pitch views over one reference-format predictor, the manifold
  figures over one bridged checkpoint (as printed);
- the LLM repair loop with a stand-in client (no call leaves the host);
- ``python -m`` of the nested tools.
"""
import json
import logging
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from daft_exprt_torch.frontend.audio import save_wav

from tests.torch_port_utils import one_torch_thread, rel_l2
from tests.torch_scripts_utils import (
    jax_parser, port_tool, save_both_checkpoints, small_config,
    small_vocoders, tone_wav,
)

ev = port_tool('evaluation.compute_wer_and_accent_metrics')


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope='module')
def wavs(tmp_path_factory):
    """Three voiced stand-in recordings and a manifest of them, the last
    two rows with a reference wav."""
    root = tmp_path_factory.mktemp('scripts_eval')
    paths = []
    for i, f0 in enumerate((140.0, 180.0, 230.0)):
        p = root / f'utt{i}.wav'
        save_wav(str(p), tone_wav(f0, 0.8, seed=i), 22050)
        paths.append(str(p))
    manifest = root / 'manifest.txt'
    manifest.write_text(f'{paths[0]}|hello world\n'
                        f'{paths[1]}|good morning|{paths[0]}\n'
                        f'{paths[2]}|bye now|{paths[0]}\n')
    return root, paths, str(manifest)


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """One seeded small checkpoint in both packages' formats (read only):
    (jax path, port path, numpy params)."""
    return save_both_checkpoints(str(tmp_path_factory.mktemp('scripts_ck')),
                                 small_config())


def test_native_metrics_match_jax():
    import scripts.evaluation.compute_wer_and_accent_metrics as jev
    import scripts.evaluation.compare_pitch_curves as jcp
    cp = port_tool('evaluation.compare_pitch_curves')
    for ref, hyp in (('Hello, world!', 'hello word'), ('', ''), ('', 'a'),
                     ("It's a test -- of WER.", 'its a a test of were')):
        assert ev.word_error_rate(ref, hyp) == jev.word_error_rate(ref, hyp)
    rng = np.random.RandomState(0)
    for v in (rng.rand(20) * 5, [0.0, 1.0], [0.0, 2.0, 3.0, 0.0, 5.0]):
        assert ev.npvi(v) == jev.npvi(v)
    a, b = rng.randn(17, 6), rng.randn(23, 6)
    assert ev.dtw_distance(a, b) == jev.dtw_distance(a, b)
    pa = np.where(rng.rand(40) > 0.3, 5 + rng.rand(40), 0)
    pb = np.where(rng.rand(31) > 0.3, 5 + rng.rand(31), 0)
    for x, y in ((pa, pb), (pa, np.zeros(5)), (np.full(5, 2.0), pb)):
        assert cp.pitch_curve_correlation(x, y) == \
            jcp.pitch_curve_correlation(x, y)
    assert ev.COMMON_ACCENT_LABELS == jev.COMMON_ACCENT_LABELS


def test_augmentations_match_jax():
    import scripts.generate_augmentation_examples as jga
    ga = port_tool('generate_augmentation_examples')
    mel = np.random.RandomState(1).randn(80, 37).astype(np.float32)
    for n in (-3, 0, 2):
        assert np.array_equal(ga.pitch_shift_mel(mel, n),
                              jga.pitch_shift_mel(mel, n))
    for f in (0.8, 1.2, 0.01):
        assert np.array_equal(ga.time_stretch_mel(mel, f),
                              jga.time_stretch_mel(mel, f))
    for f in (0.7, 1.3):
        assert np.array_equal(ga.energy_scale_mel(mel, f),
                              jga.energy_scale_mel(mel, f))


def one_f0_track(monkeypatch):
    """Both packages' ``extract_pitch`` give the port's CPU tracker's
    track."""
    import daft_exprt_tpu.frontend.pitch as jpitch
    import daft_exprt_torch.frontend.pitch as tpitch
    real = tpitch.extract_pitch

    def track(wav, fs, hparams, method='auto', device=None):
        return real(wav, fs, hparams, method='device', device='cpu')
    monkeypatch.setattr(jpitch, 'extract_pitch', track)
    monkeypatch.setattr(tpitch, 'extract_pitch', track)


def _evaluate_both(argv, tmp_path):
    import scripts.evaluation.compute_wer_and_accent_metrics as jev
    name = 'evaluation/compute_wer_and_accent_metrics'
    j = jev.evaluate(jax_parser(name).parse_args(
        argv + ['-out', str(tmp_path / 'jax')]))
    t = ev.main(argv + ['-out', str(tmp_path / 'port'), '--device', 'cpu'])
    return j, t


def _same_report(t, j):
    assert t['n_utterances'] == j['n_utterances']
    for a, b in zip(t['per_utterance'], j['per_utterance']):
        assert set(a) == set(b) and a['file'] == b['file']
        for k in ('pitch_std_semitones', 'energy_npvi', 'duration_npvi'):
            assert a[k] == pytest.approx(b[k], rel=1e-3), k
    assert set(t) == set(j)


def test_evaluate_prosody_only_matches_jax(wavs, tmp_path, caplog,
                                           monkeypatch):
    _, _, manifest = wavs
    own = ev.main(['-m', manifest, '--pitch_method', 'device', '-out',
                   str(tmp_path / 'own'), '--device', 'cpu'])
    assert own['n_utterances'] == 3 and all(
        np.isfinite(r['energy_npvi']) for r in own['per_utterance'])
    one_f0_track(monkeypatch)
    with caplog.at_level(logging.WARNING):
        j, t = _evaluate_both(['-m', manifest, '--pitch_method', 'device',
                               '--wer', '--nisqa'], tmp_path)
    _same_report(t, j)
    for a, b in zip(own['per_utterance'], j['per_utterance']):
        assert a['energy_npvi'] == pytest.approx(b['energy_npvi'], rel=1e-3)
    assert t['wer'] is None and t['nisqa_mos'] is None
    assert t['accent_emb_cosine_dist'] is None
    # the absent externals are skipped with a warning, not loaded
    assert sum('whisper not installed' in r.message
               for r in caplog.records) == 2
    with open(tmp_path / 'port' / 'evaluation_report.json') as f:
        assert json.load(f)['n_utterances'] == 3


def test_evaluate_with_checkpoint_matches_jax(wavs, checkpoints, tmp_path,
                                              monkeypatch):
    _, paths, _ = wavs
    one_f0_track(monkeypatch)
    manifest = tmp_path / 'manifest.txt'
    manifest.write_text(f'{paths[0]}|hello\n{paths[2]}|bye|{paths[1]}\n')
    manifest = str(manifest)
    jax_ck, port_ck, _ = checkpoints
    rows = {}
    for which, ck in (('jax', jax_ck), ('port', port_ck)):
        argv = ['-m', manifest, '-chk', ck, '--pitch_method', 'device',
                '-out', str(tmp_path / which)]
        if which == 'jax':
            import scripts.evaluation.compute_wer_and_accent_metrics as jev
            rows[which] = jev.evaluate(jax_parser(
                'evaluation/compute_wer_and_accent_metrics').parse_args(argv))
        else:
            rows[which] = ev.main(argv + ['--device', 'cpu'])
    j, t = rows['jax'], rows['port']
    _same_report(t, j)
    dists = [(a.get('accent_emb_cosine_dist'), b.get('accent_emb_cosine_dist'))
             for a, b in zip(t['per_utterance'], j['per_utterance'])]
    assert dists[0] == (None, None)
    a, b = dists[1]
    assert abs(a - b) <= 1e-4 and a > 0


def _vocoder_tool_both(name, argv, monkeypatch):
    """The JAX script's __main__ and the port's main on ``argv`` with the
    small vocoder served to both."""
    small_vocoders(monkeypatch)
    monkeypatch.setattr(sys, 'argv', [name] + argv(which='jax'))
    runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'scripts', f'{name}.py'),
        run_name='__main__')
    return port_tool(name).main(argv(which='port') + ['--device', 'cpu'])


def _wav(path):
    return wavfile.read(path)[1].astype(np.float64)


def test_vocoder_tools_match_jax(wavs, tmp_path, monkeypatch):
    _, paths, _ = wavs
    out = tmp_path
    _vocoder_tool_both('hifigan_sanity_check', lambda which: [
        '-w', paths[1], '-out', str(out / which), '--vocoder_checkpoint',
        'unused'], monkeypatch)
    for suffix in ('copy_synthesis', 'original_trimmed'):
        a = _wav(out / 'port' / f'utt1_{suffix}.wav')
        b = _wav(out / 'jax' / f'utt1_{suffix}.wav')
        assert a.shape == b.shape and rel_l2(a, b) <= 2e-3, suffix
    mel = np.random.RandomState(2).randn(80, 24).astype(np.float32) - 5
    np.savez(out / 'mel.npz', mel_spec=mel)
    _vocoder_tool_both('verify_mel_spec', lambda which: [
        '-m', str(out / 'mel.npz'), '-out', str(out / f'{which}.wav'),
        '--vocoder_checkpoint', 'unused'], monkeypatch)
    a, b = _wav(out / 'port.wav'), _wav(out / 'jax.wav')
    assert a.shape == b.shape == (24 * 4,) and rel_l2(a, b) <= 2e-3
    got = _vocoder_tool_both('generate_augmentation_examples', lambda which: [
        '-w', paths[0], '-out', str(out / f'aug_{which}'),
        '--vocoder_checkpoint', 'unused', '--stretches', '1.5'], monkeypatch)
    names = sorted(os.listdir(out / 'aug_jax'))
    assert sorted(os.listdir(out / 'aug_port')) == names and len(names) == 6
    assert sorted(got) == sorted(n[5:-4] for n in names)
    for n in names:
        a, b = _wav(out / 'aug_port' / n), _wav(out / 'aug_jax' / n)
        assert a.shape == b.shape and rel_l2(a, b) <= 2e-3, n


def _reference_pitch_predictor(path, seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for ci, bi in ((0, 2), (4, 6), (8, 10)):
        c_in = 80 if ci == 0 else 256
        sd[f'conv_layers.{ci}.conv.weight_v'] = rng.randn(256, c_in, 3)
        sd[f'conv_layers.{ci}.conv.weight_g'] = rng.rand(256, 1, 1) + .5
        sd[f'conv_layers.{ci}.conv.bias'] = rng.randn(256) * 0.1
        for n in ('weight', 'bias', 'running_mean'):
            sd[f'conv_layers.{bi}.{n}'] = rng.randn(256) * 0.1
        sd[f'conv_layers.{bi}.running_var'] = rng.rand(256) + 0.5
    sd['conv_layers.12.conv.weight_v'] = rng.randn(1, 256, 3)
    sd['conv_layers.12.conv.weight_g'] = rng.rand(1, 1, 1) + 0.5
    sd['conv_layers.12.conv.bias'] = rng.randn(1)
    torch.save({'module.' + k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in sd.items()}, path)


def test_pitch_views_match_jax(tmp_path, caplog, capsys):
    import scripts.visualize_pitch_prediction as jvp
    feats = tmp_path / 'feats' / 'spk'
    feats.mkdir(parents=True)
    rng = np.random.RandomState(4)
    for i in range(3):
        np.save(feats / f'u{i}.npy', rng.randn(80, 30 + i).astype(np.float32))
        f0 = np.where(rng.rand(30 + i) > 0.4, 5 + rng.rand(30 + i), 0.0)
        (feats / f'u{i}.frames_f0').write_text(
            ''.join(f'{v}\n' for v in f0))
    ck = str(tmp_path / 'pp.pt')
    _reference_pitch_predictor(ck)
    argv = ['-chk', ck, '-fd', str(tmp_path / 'feats'), '--nb_files', '2']
    with caplog.at_level(logging.INFO):
        jvp.main(jax_parser('visualize_pitch_prediction').parse_args(
            argv + ['-out', str(tmp_path / 'jax')]))
    want = [float(m) for m in re.findall(r'voiced MSE ([\d.]+)', caplog.text)]
    got = port_tool('visualize_pitch_prediction').main(
        argv + ['-out', str(tmp_path / 'port'), '--device', 'cpu'])
    assert [os.path.basename(k) for k in sorted(got)] == ['u0', 'u1']
    assert len(want) == 2
    for g, w in zip((got[k] for k in sorted(got)), want):
        assert abs(g - w) <= 1e-5 * max(1.0, w)
    assert sorted(os.listdir(tmp_path / 'port')) == \
        sorted(os.listdir(tmp_path / 'jax')) == ['u0_pitch.png',
                                                 'u1_pitch.png']
    shape = port_tool('verify_pitch_predictor_shape')
    assert shape.main(['--device', 'cpu']) == 0
    assert 'output shape: (2, 123) -- SUCCESS' in capsys.readouterr().out


def test_manifold_matches_jax(checkpoints, tmp_path, capsys):
    import scripts.analyze_embedding_manifold as jam
    jax_ck, port_ck, params = checkpoints
    feats = tmp_path / 'feats'
    feats.mkdir()
    rng = np.random.RandomState(8)
    for i in range(4):
        np.save(feats / f'u{i}.spk_emb.npy',
                rng.randn(192).astype(np.float32))
    argv = ['-fd', str(feats)]
    jam.main(jax_parser('analyze_embedding_manifold').parse_args(
        ['-chk', jax_ck] + argv))
    want = capsys.readouterr().out
    got = port_tool('analyze_embedding_manifold').main(
        ['-chk', port_ck, '--device', 'cpu'] + argv)
    assert capsys.readouterr().out == want
    W = np.asarray(params['spk_projection']['linear_layer']['kernel'])
    model = port_tool('synthesize').load_model_for_synthesis(
        port_ck, device='cpu')[0]
    W_t, _ = port_tool('analyze_embedding_manifold').projection(model)
    assert W_t.shape == W.shape and np.allclose(W_t, W)
    assert len(got['cosines']) == 12 and len(got['norms']) == 4


class _Client:
    """A stand-in chat-completions client: answers in turn, records each
    call's messages."""

    def __init__(self, answers):
        self.answers, self.calls = list(answers), []
        self.chat = self
        self.completions = self

    def create(self, model, messages):
        self.calls.append([dict(m) for m in messages])
        text = self.answers.pop(0)

        class R:
            class choice:
                class message:
                    content = text
            choices = [choice]
        return R


def test_llm_repair_loop_matches_jax(tmp_path):
    import scripts.benchmarks.convert_prosody_with_llm as jllm
    llm = port_tool('benchmarks.convert_prosody_with_llm')
    assert llm.SYSTEM_PROMPT == jllm.SYSTEM_PROMPT
    assert llm.ICL_EXAMPLES == jllm.ICL_EXAMPLES
    tuples = [('HH', 3, 5.0, 10.0), (' ', 2, 0.0, 0.0), ('AY1', 7, 5.2, 12.0)]
    cases = [tuples, tuples[:2], 'x', [('HH', 3, 5.0, 10.0), (' ', 2, 1.0, 0),
                                      ('AY1', 7, 5.2, 12.0)],
             [('HH', -1, 5.0, 10.0)] + tuples[1:],
             [('K', 3, 5.0, 10.0)] + tuples[1:], [(1, 2)] * 3]
    for c in cases:
        assert llm.validate_output(tuples, c) == \
            jllm.validate_output(tuples, c)
    good = "```python\n[('HH', 4, 5.1, 10.5), (' ', 2, 0.0, 0.0), " \
        "('AY1', 6, 5.3, 12.2)]\n```"
    answers = ['not a list (', repr(tuples[:2]), good]
    runs = []
    for mod in (jllm, llm):
        client = _Client(answers)
        runs.append((mod.convert_prosody(tuples, client, max_attempts=3),
                     client.calls))
    assert runs[0] == runs[1]
    out, calls = runs[1]
    assert out == [('HH', 4, 5.1, 10.5), (' ', 2, 0.0, 0.0),
                   ('AY1', 6, 5.3, 12.2)]
    assert len(calls) == 3 and 'length changed' in calls[2][-1]['content']
    with pytest.raises(RuntimeError, match='after 2 attempts'):
        llm.convert_prosody(tuples, _Client(answers), max_attempts=2)
    # the tool over a prosody file, with the client given to main
    pf = tmp_path / 'p.prosody'
    pf.write_text(f'a.wav|{tuples!r}\n')
    res = llm.main(['-spf', str(pf), '-o', str(tmp_path / 'o.txt'),
                    '--device', 'cpu'], client=_Client([good]))
    assert res == {'a': out}
    assert (tmp_path / 'o.txt').read_text() == f'a|{out!r}\n'


@pytest.mark.parametrize('name', [
    'evaluation.compute_wer_and_accent_metrics',
    'evaluation.compare_pitch_curves',
    'benchmarks.convert_prosody_with_llm'])
def test_nested_tools_run_as_modules(name, monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', [name, '--help'])
    monkeypatch.delitem(sys.modules, f'daft_exprt_torch.scripts.{name}')
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f'daft_exprt_torch.scripts.{name}',
                         run_name='__main__')
    assert e.value.code == 0 and '--device' in capsys.readouterr().out

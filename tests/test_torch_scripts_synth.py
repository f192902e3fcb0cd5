"""The port's synthesis CLI (daft_exprt_torch/scripts/synthesize.py) and
grid search against the top-level scripts on the CPU: a small acoustic
model in float32 through both packages' checkpoints, test_torch_generate's
small float32 HiFi-GAN served by both packages' ``load_hifigan_vocoder``.

- On the committed style bank (the zero-argument demo, ``--int8_vocoder``:
  static calibration mels from the bank's wavs) and on a prosody file with
  ``--use_griffin_lim``: the same prediction keys and host prosody tracks
  (integer durations exactly), ``.npz`` mels max-abs 1e-3
  (test_torch_generate's mel band), waveforms rel-L2 2e-3 (its band for
  the float32 vocoder); ``stats_from_wav_dir`` and the accent embedding
  rel-L2 1e-5.
- Checkpoints told apart by content; ``extra`` round-trips.
- ``grid_search_accent``: the same grid and scores (rel 1e-3) on a
  two-point grid, with both packages' Griffin-Lim (whose initial phase is
  each package's own draw) replaced by one deterministic stand-in.
"""
import json
import os

import numpy as np
import pytest
from scipy.io import wavfile

from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.hparams import HyperParams

from tests.torch_port_utils import max_abs, one_torch_thread, rel_l2
from tests.torch_scripts_utils import (
    HP_KW, jax_parser, port_tool, prosody_lines, save_both_checkpoints,
    small_config, small_vocoders, tone_wav,
)


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp('scripts_synth')
    jax_ck, port_ck, _ = save_both_checkpoints(str(root), small_config())
    return root, jax_ck, port_ck


def _synthesize_both(argv_of, root):
    """Both CLIs on ``argv_of(out_dir, which)``; returns their
    predictions and output directories."""
    import scripts.synthesize as js
    j_dir, t_dir = str(root / 'jax'), str(root / 'port')
    j = js.synthesize(jax_parser('synthesize').parse_args(
        argv_of(j_dir, 'jax')))
    with one_torch_thread():
        t = port_tool('synthesize').main(argv_of(t_dir, 'port')
                                     + ['--device', 'cpu'])
    return j, t, j_dir, t_dir


def _same_predictions(j, t, j_dir, t_dir, wav_band=None):
    assert sorted(j) == sorted(t) and j
    for key in j:
        for a, b in zip(t[key][:4], j[key][:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b), key
        assert t[key][4].shape == j[key][4].shape
        assert max_abs(t[key][4], j[key][4]) < 1e-3, key
        jm = np.load(os.path.join(j_dir, f'{key}.npz'))['mel_spec']
        tm = np.load(os.path.join(t_dir, f'{key}.npz'))['mel_spec']
        assert max_abs(tm, jm) < 1e-3, key
        _, jw = wavfile.read(os.path.join(j_dir, f'{key}.wav'))
        _, tw = wavfile.read(os.path.join(t_dir, f'{key}.wav'))
        assert tw.shape == jw.shape and np.abs(tw).max() > 0, key
        if wav_band is not None:
            assert rel_l2(tw, jw) <= wav_band, key
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))


def test_synthesize_committed_bank_matches_jax(ckpts, tmp_path,
                                               monkeypatch):
    """The zero-argument demo with --int8_vocoder: prosody, speaker
    embedding, accent references and the int8 calibration mels all from
    the committed style bank."""
    _, jax_ck, port_ck = ckpts
    asked = small_vocoders(monkeypatch)
    j, t, j_dir, t_dir = _synthesize_both(lambda out, which: [
        '-out', out, '-chk', jax_ck if which == 'jax' else port_ck,
        '--int8_vocoder', '--vocoder_checkpoint', 'unused', '-bs', '4'],
        tmp_path)
    assert asked == [('jax', 'int8', True), ('port', 'int8', True)]
    assert len(j) == 6
    _same_predictions(j, t, j_dir, t_dir, wav_band=2e-3)


def test_synthesize_griffin_lim_prosody_file_matches_jax(ckpts, tmp_path):
    """A prosody file in both forms, new-speaker stats and accent
    references from a wav directory, a speaker embedding file, the
    control demo's factors and an exaggerated pitch, Griffin-Lim
    waveforms."""
    import scripts.synthesize as js
    _, jax_ck, port_ck = ckpts
    refs = tmp_path / 'refs'
    refs.mkdir()
    for i, f0 in enumerate((140.0, 210.0)):
        save_wav(str(refs / f'r{i}.wav'), tone_wav(f0, 0.8, seed=i), 22050)
    hp = HyperParams(**HP_KW)
    pf = tmp_path / 'p.prosody'
    pf.write_text(''.join(prosody_lines(hp, np.random.RandomState(3))))
    emb = tmp_path / 'spk.npy'
    np.save(emb, np.random.RandomState(4).randn(192).astype(np.float32))
    j, t, j_dir, t_dir = _synthesize_both(lambda out, which: [
        '-out', out, '-chk', jax_ck if which == 'jax' else port_ck,
        '-spf', str(pf), '-sb', '', '--use_griffin_lim',
        '--new_speaker_stats', str(refs), '--accent_emb_audios_dir',
        str(refs), '--spk_emb_file', str(emb), '--alpha_pitch', '1.2',
        '-bs', '2'], tmp_path)
    assert len(j) == 3
    _same_predictions(j, t, j_dir, t_dir)

    # the stats and the accent embedding behind the run, directly
    port = port_tool('synthesize')
    jmodel, jparams, jhp, _ = js.load_model_for_synthesis(jax_ck)
    tmodel, thp, _ = port.load_model_for_synthesis(port_ck, device='cpu')
    with one_torch_thread():
        got_stats = port.stats_from_wav_dir(str(refs), thp, device='cpu')
        got_acc = port.accent_embedding_from_wav_dir(tmodel, str(refs), thp)
    want_stats = js.stats_from_wav_dir(str(refs), jhp)
    want_acc = js.accent_embedding_from_wav_dir(jmodel, jparams, str(refs),
                                                jhp)
    for k in ('pitch', 'energy'):
        for s in ('mean', 'std'):
            assert got_stats[k][s] == pytest.approx(want_stats[k][s],
                                                    rel=1e-5)
    assert rel_l2(got_acc, want_acc) <= 1e-5


def test_load_model_tells_checkpoints_apart_by_content(ckpts, tmp_path):
    """A port checkpoint named like a reference file and a reference state
    dict named like a port checkpoint give the same model; ``extra``
    round-trips."""
    import torch
    from daft_exprt_torch import checkpoint as ckpt
    _, _, port_ck = ckpts
    port = port_tool('synthesize')
    model, hp, extra = port.load_model_for_synthesis(port_ck, device='cpu')
    assert extra == {} and hp.phoneme_encoder['hidden_embed_dim'] == 16
    state = model.state_dict()
    named_pt = str(tmp_path / 'port_named.pt')
    emb = np.arange(4, dtype=np.float32)
    ckpt.save_checkpoint(named_pt, state, config_params=small_config(),
                         extra={'memorized_spk_emb': emb, 'note': 'x'})
    ref = str(tmp_path / 'reference_state')
    torch.save({'state_dict': {f'module.{r}': state[p] for p, r in
                               ckpt._reference_names(state, 1, 1, 1)},
                'config_params': small_config()}, ref)
    for path, want_extra in ((named_pt, {'note': 'x'}), (ref, {})):
        m2, hp2, extra2 = port.load_model_for_synthesis(path, device='cpu')
        assert hp2.stats == hp.stats
        assert extra2.pop('memorized_spk_emb', torch.from_numpy(
            emb)).equal(torch.from_numpy(emb)) and extra2 == want_extra
        for k, v in state.items():
            assert torch.equal(m2.state_dict()[k], v), (path, k)
    with pytest.raises(ValueError, match='neither a port checkpoint'):
        torch.save({'something': 'else'}, ref)
        ckpt.load_acoustic_checkpoint(ref)


def _stand_in_vocoding(mel, hparams, *a, **kw):
    """A deterministic mel -> waveform map in Griffin-Lim's place: a
    harmonic tone whose frequency (130-190 Hz) and amplitude (never near
    silence, where float32 and float64 pitch scores part ways) follow each
    frame's mean log-mel."""
    mel = np.asarray(mel, np.float64)
    hop = hparams.hop_length
    m = np.repeat(mel.mean(0), hop)
    z = np.tanh(2.0 * (m - m.mean()))
    phase = 2 * np.pi * np.cumsum(160.0 + 30.0 * z) / hparams.sampling_rate
    amp = 0.6 + 0.3 * z
    return (0.3 * amp * (np.sin(phase) + 0.3 * np.sin(2 * phase))).astype(
        np.float32)


def test_grid_search_accent_matches_jax(ckpts, tmp_path, monkeypatch):
    import scripts.grid_search_accent as jgs
    from daft_exprt_tpu.frontend import griffin_lim as jgl
    from daft_exprt_torch.frontend import griffin_lim as tgl
    _, jax_ck, port_ck = ckpts
    for mod in (jgl, tgl):
        monkeypatch.setattr(mod, 'griffin_lim_reconstruction_from_mel_spec',
                            _stand_in_vocoding)
    hp = HyperParams(**HP_KW)
    pf = tmp_path / 'p.prosody'
    pf.write_text(''.join(prosody_lines(hp, np.random.RandomState(5), 2,
                                         k_max=14, d_max=12)))
    rng = np.random.RandomState(6)
    np.save(tmp_path / 'spk.npy', rng.randn(192).astype(np.float32))
    np.save(tmp_path / 'acc.npy', rng.randn(16).astype(np.float32))
    target = tmp_path / 'target.json'
    target.write_text(json.dumps({'pitch_std_semitones': 1.0,
                                  'energy_npvi': 20.0,
                                  'duration_npvi': 30.0}))
    rows = {}
    for which in ('jax', 'port'):
        argv = ['-out', str(tmp_path / which), '-chk',
                jax_ck if which == 'jax' else port_ck, '-spf', str(pf),
                '--use_griffin_lim', '--spk_emb_file',
                str(tmp_path / 'spk.npy'), '--accent_emb_file',
                str(tmp_path / 'acc.npy'), '--alpha_dur', '0.8', '1.3',
                '--alpha_pitch', '1.0', '--alpha_energy', '1.0',
                '--target_metrics', str(target), '--pitch_method', 'device']
        if which == 'jax':
            jgs.main(jax_parser('grid_search_accent').parse_args(argv))
        else:
            with one_torch_thread():
                port_tool('grid_search_accent').main(argv + ['--device', 'cpu'])
        with open(tmp_path / which / 'grid_results.json') as f:
            rows[which] = json.load(f)
    assert len(rows['jax']) == len(rows['port']) == 2
    for a, b in zip(rows['port'], rows['jax']):
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-3), k
            else:
                assert a[k] == v, k
    assert rows['port'][0]['target_distance'] != \
        rows['port'][1]['target_distance']

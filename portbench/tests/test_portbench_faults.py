"""The check catches a broken timed path: each cell's run, with the
harness's look for a card skipped (CPU, tiny sizes, the configurations'
own limits), reads ``correct`` false under each fault the cell can have.
Synthesis: half of the batch left out (the mean of the rest in its
place), an answer altered where it is produced. Training and fine-tuning:
a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced. One chip: no exchange between chips to
leave out."""
import numpy as np
import pytest
import torch

from tinybench import harness, tiny_root

SEED = 2 ** 31 + 4051


def _run(tmp_path, cell):
    root = tiny_root(tmp_path)
    return harness(root).run_cell(root, cell, SEED, 0.5, 0, device='cpu')


def test_sound_runs_are_correct(tmp_path):
    assert _run(tmp_path, 'tiny.synth')['correct'] is True


def _half_batch_synth(orig):
    def infer(self, symbols, *args, **kw):
        mel, w, lens = orig(self, symbols, *args, **kw)
        h = (len(mel) + 1) // 2
        mel = mel.copy()
        mel[h:] = mel[:h].mean(axis=0)
        return mel, w, lens
    return infer


def _altered_answer_synth(orig):
    def infer(self, mel):
        wav = orig(self, mel).copy()
        wav[[0, 1]] = wav[[1, 0]]
        return wav
    return infer


@pytest.mark.parametrize('fault', ['half_batch', 'altered_answer'])
def test_synthesis_faults_fail(tmp_path, monkeypatch, fault):
    from daft_exprt_torch import generate
    from daft_exprt_torch.models import hifigan
    if fault == 'half_batch':
        monkeypatch.setattr(generate.Synthesizer, 'infer',
                            _half_batch_synth(generate.Synthesizer.infer))
    else:
        monkeypatch.setattr(hifigan.HiFiGanVocoder, 'infer',
                            _altered_answer_synth(
                                hifigan.HiFiGanVocoder.infer))
    out = _run(tmp_path, 'tiny.synth')
    assert out['correct'] is False, out['checks']


def _gan_fault(fault, make):
    def make_gan_steps(*a, **kw):
        d_step, g_step, opts, loss_mel = make(*a, **kw)
        if fault == 'unchanged':
            def keep(step, params_of):
                def run(*args):
                    params = params_of(*args)
                    before = [p.detach().clone() for p in params]
                    out = step(*args)
                    with torch.no_grad():
                        for p, b in zip(params, before):
                            p.copy_(b)
                    return out
                return run
            d_step = keep(d_step, lambda mpd, msd, *_: list(
                mpd.parameters()) + list(msd.parameters()))
            from daft_exprt_torch.vocoder_finetune import param_leaves
            g_step = keep(g_step, lambda g_wn, *_: param_leaves(g_wn))
        elif fault == 'half_batch':
            d0, g0 = d_step, g_step

            def d_step(mpd, msd, opt, g_wn, mel, y):
                h = len(y) // 2
                return d0(mpd, msd, opt, g_wn, mel[:h], y[:h])

            def g_step(g_wn, opt, mpd, msd, mel, y, y_mel):
                h = len(y) // 2
                return g0(g_wn, opt, mpd, msd, mel[:h], y[:h], y_mel[:h])
        return d_step, g_step, opts, loss_mel
    return make_gan_steps


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch',
                                   'altered_answer'])
def test_finetuning_faults_fail(tmp_path, monkeypatch, fault):
    from daft_exprt_torch import vocoder_finetune as vf
    if fault == 'altered_answer':
        orig = vf.generator_forward

        def generator_forward(*a, **kw):
            wav = orig(*a, **kw)
            scale = torch.ones(len(wav), 1, 1, dtype=wav.dtype)
            scale[0] = 0.5
            return wav * scale
        monkeypatch.setattr(vf, 'generator_forward', generator_forward)
    else:
        monkeypatch.setattr(vf, 'make_gan_steps',
                            _gan_fault(fault, vf.make_gan_steps))
    out = _run(tmp_path, 'tiny.gan')
    assert out['correct'] is False, out['checks']
    assert all(np.isfinite(c['value']) for c in out['checks'].values())


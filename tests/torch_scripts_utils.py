"""Helpers for the tests that hold ``daft_exprt_torch/scripts`` to the
top-level ``scripts`` (the JAX package's tools): their argument parsers,
a small acoustic model saved as both packages' checkpoints, and a small
float32 HiFi-GAN served by both packages from the same weights."""
import argparse
import contextlib
import importlib
import io
import os
import runpy
import sys

import numpy as np

from tests.test_torch_generate import VOC_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL0 = {'nb_blocks': 1, 'hidden_embed_dim': 16, 'attn_nb_heads': 2,
          'attn_dropout': 0.0, 'conv_kernel': 3, 'conv_channels': 24,
          'conv_dropout': 0.0}
HP_KW = dict(verbose=False, training_files='x', validation_files='x',
             output_directory='/nonexistent', language='english',
             speakers=['spk'])
STATS = {'spk 0': {'pitch': {'mean': 5.0, 'std': 0.2},
                   'energy': {'mean': 8.0, 'std': 5.0}},
         'spk 1': {'pitch': {'mean': 4.8, 'std': 0.3},
                   'energy': {'mean': 7.0, 'std': 4.0}}}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__('parser captured')
        self.parser = parser


def jax_parser(name):
    """The argparse parser the JAX script ``scripts/<name>.py`` builds in
    its ``__main__`` block, captured at its ``parse_args`` call."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = capture
    try:
        runpy.run_path(os.path.join(REPO, 'scripts', f'{name}.py'),
                       run_name='__main__')
    except _Parsed as p:
        return p.parser
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f'scripts/{name}.py built no parser')


def help_text(parse, argv=('--help',)):
    """What ``parse(argv)`` prints for --help (it must exit 0), with the
    program named 'tool' (a parser built now takes its name from
    sys.argv[0], which is '-c' in a pytest-xdist worker)."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ['tool']
    try:
        with contextlib.redirect_stdout(buf):
            try:
                parse(list(argv))
            except SystemExit as e:
                assert e.code == 0, e.code
    finally:
        sys.argv = saved
    return buf.getvalue()


def small_config(**kw):
    config = dict(language='english', speakers=['speaker_0', 'speaker_1'],
                  phoneme_encoder=dict(SMALL0), accent_encoder=dict(SMALL0),
                  frame_decoder=dict(SMALL0), length_buckets=[16, 32],
                  frame_buckets=[64, 128, 256], stats=STATS,
                  compute_dtype='float32')
    config.update(kw)
    return config


def save_both_checkpoints(root, config, seed=0):
    """JAX's initial parameters of ``config`` plus seeded noise, saved as
    a JAX checkpoint and, through the bridge, as a port checkpoint.
    Returns (jax path, port path, numpy params)."""
    import jax

    from daft_exprt_tpu import checkpoint as jax_ckpt
    from daft_exprt_tpu.hparams import HyperParams as JaxHParams
    from daft_exprt_tpu.train import init_model_and_state
    from daft_exprt_torch import checkpoint as ckpt
    from daft_exprt_torch.bridge import acoustic_state_from_jax

    hp = JaxHParams(verbose=False, training_files='unused',
                    validation_files='unused',
                    output_directory=os.path.join(root, 'init'), **config)
    # traced whole: one compile, not one for each operation of the init
    params = jax.jit(lambda: init_model_and_state(hp, rng_seed=seed)[1])()
    rng = np.random.RandomState(seed + 7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    jax_path = os.path.join(root, 'jax_ckpt')
    port_path = os.path.join(root, 'port_ckpt')
    jax_ckpt.save_checkpoint(jax_path, params, config_params=config)
    ckpt.save_checkpoint(port_path, acoustic_state_from_jax(params),
                         config_params=config)
    return jax_path, port_path, params


def small_vocoders(monkeypatch, seed=5):
    """Both packages' ``load_hifigan_vocoder`` serve test_torch_generate's
    small float32 HiFi-GAN from one set of seeded weights, whatever
    checkpoint or tier they are asked for (for the test's duration);
    returns the list the loaders record each request in."""
    import jax

    from daft_exprt_tpu.models import hifigan as jh
    from daft_exprt_torch.bridge import generator_from_jax
    from daft_exprt_torch.models import hifigan as th

    from tests.torch_port_utils import to_numpy

    jvp = jh.init_generator_params(jax.random.PRNGKey(seed), VOC_CFG,
                                   std=0.1)
    asked = []

    def jax_loader(checkpoint_path=None, fast=None,
                   int8_calibration_mels=None, **kw):
        asked.append(('jax', fast, int8_calibration_mels is not None))
        return jh.HiFiGanVocoder(params=jvp, config=VOC_CFG, fast=False)

    def port_loader(checkpoint_path=None, fast=False,
                    int8_calibration_mels=None, device=None, **kw):
        asked.append(('port', fast, int8_calibration_mels is not None))
        return th.HiFiGanVocoder(generator_from_jax(to_numpy(jvp)), VOC_CFG,
                                 fast=False, device=device)

    monkeypatch.setattr(jh, 'load_hifigan_vocoder', jax_loader)
    monkeypatch.setattr(th, 'load_hifigan_vocoder', port_loader)
    return asked


def tone_wav(f0, seconds=1.0, sr=22050, seed=0):
    """A voiced stand-in recording: a harmonic tone at ``f0`` with a slow
    amplitude envelope and a little noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t)) + 0.01 * rng.randn(
        len(t))
    return (0.25 * x / np.abs(x).max()).astype(np.float32)


def port_tool(name):
    """The port's tool module ``daft_exprt_torch.scripts.<name>`` (a name
    under a sub-directory of ``scripts`` with '/' or '.')."""
    return importlib.import_module(
        f'daft_exprt_torch.scripts.{name.replace("/", ".")}')


def prosody_lines(hp, rng, n=3, k_max=9, d_max=8):
    """``n`` utterances of symbol prosody (tuple and array forms in turn)
    of 5 to ``k_max`` - 1 symbols of 0 to ``d_max`` - 1 frames."""
    phones = [s for s in hp.symbols if s[0].isalpha()]
    lines = ['# a comment line\n']
    for i in range(n):
        k = rng.randint(5, k_max)
        syms = [phones[j] for j in rng.randint(0, len(phones), k)]
        durs = [int(d) for d in rng.randint(0, d_max, k)]
        pitch = [round(float(p), 3) if rng.rand() > 0.3 else 0.0
                 for p in 5.0 + 0.2 * rng.randn(k)]
        energy = [round(float(e), 3) for e in 8.0 + 3.0 * rng.rand(k)]
        if i % 2:
            lines.append(f'{[syms, durs, pitch, energy]!r}\n')
        else:
            lines.append(f'audio/utt{i}.wav|'
                         f'{list(zip(syms, durs, pitch, energy))!r}\n')
    return lines

"""The port stands alone: no JAX, flax, optax or daft_exprt_tpu import in
daft_exprt_torch/ or chip_smoke.py; the package imports with JAX blocked
(every module of the audio front end, the GAN fine-tuning and the text and
alignment front end, and of scale-out and the host tools too); entry points
default to CUDA and raise without it unless given 'cpu' (the feature
extractors, the pitch tracker, Griffin-Lim, extract_reference_parameters,
the GAN steps, finetune and fine_tuning too, before they touch a file; and
init_distributed, make_mesh, make_sharded_vocoder on a default mesh,
dryrun_multichip, entry and train with a mesh)."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'daft_exprt_tpu')


def _port_files():
    return sorted((ROOT / 'daft_exprt_torch').rglob('*.py')) + \
        [ROOT / 'chip_smoke.py']


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_imports_in_the_port():
    files = _port_files()
    assert len(files) > 10 and all(f.is_file() for f in files)
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f) if m.split('.')[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        f'        if name.split(".")[0] in {FORBIDDEN!r}:\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import daft_exprt_torch.generate, daft_exprt_torch.bridge\n'
        'import daft_exprt_torch.models.daft_exprt\n'
        'import daft_exprt_torch.models.hifigan\n'
        'import daft_exprt_torch.hparams\n'
        'import daft_exprt_torch.train, daft_exprt_torch.loss\n'
        'import daft_exprt_torch.data, daft_exprt_torch.checkpoint\n'
        'import daft_exprt_torch.parallel.train_step\n'
        'import daft_exprt_torch.models.pitch_predictor\n'
        'import daft_exprt_torch.utils.logger, daft_exprt_torch.ops.grl\n'
        'import daft_exprt_torch.ops.mel, daft_exprt_torch.ops.pitch\n'
        'import daft_exprt_torch.frontend.audio\n'
        'import daft_exprt_torch.frontend.duration\n'
        'import daft_exprt_torch.frontend.markers\n'
        'import daft_exprt_torch.frontend.pitch\n'
        'import daft_exprt_torch.frontend.extract_features\n'
        'import daft_exprt_torch.frontend.griffin_lim\n'
        'import daft_exprt_torch.data.sets\n'
        'import daft_exprt_torch.models.discriminators\n'
        'import daft_exprt_torch.vocoder_finetune\n'
        'import daft_exprt_torch.fine_tune\n'
        'import daft_exprt_torch.text, daft_exprt_torch.text.numbers\n'
        'import daft_exprt_torch.text.cleaners\n'
        'import daft_exprt_torch.utils.multiproc, daft_exprt_torch.utils\n'
        'import daft_exprt_torch.frontend.textgrid\n'
        'import daft_exprt_torch.frontend.mfa\n'
        'import daft_exprt_torch.parallel.mesh\n'
        'import daft_exprt_torch.parallel.launch\n'
        'import daft_exprt_torch.parallel.vocoder_sharding\n'
        'import daft_exprt_torch.parallel.dryrun\n'
        'import daft_exprt_torch.utils.profiling\n'
        'import daft_exprt_torch.frontend.ecapa\n'
        'from daft_exprt_torch.utils.plots import plot_1d_overlay\n'
        'from daft_exprt_torch.train import launch_training\n'
        'from daft_exprt_torch.generate import (\n'
        '    phonemize_sentence, prepare_sentences_for_inference)\n'
        'from daft_exprt_torch.bridge import discriminators_from_jax\n'
        'from daft_exprt_torch.utils.misc import (\n'
        '    Timer, estimate_required_time)\n'
        'assert not any(m.split(".")[0] in %r for m in sys.modules)\n'
        'print("ok")\n' % (FORBIDDEN,))
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'ok'


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    from daft_exprt_torch.device import resolve_device
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.daft_exprt import DaftExprt
    from daft_exprt_torch.models.hifigan import (
        HiFiGanVocoder, init_generator_params,
    )
    from daft_exprt_torch.frontend.extract_features import extract_features
    from daft_exprt_torch.frontend.griffin_lim import (
        griffin_lim_reconstruction_from_mel_spec,
    )
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.generate import extract_reference_parameters
    from daft_exprt_torch.ops.mel import MelExtractor, frame_energy
    from daft_exprt_torch.ops.pitch import PitchTracker
    from daft_exprt_torch.train import train
    from daft_exprt_torch.fine_tune import fine_tuning
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    from daft_exprt_torch.vocoder_finetune import (
        finetune, make_gan_steps, make_loss_mel_fn,
    )
    from daft_exprt_torch.parallel.dryrun import dryrun_multichip, entry
    from daft_exprt_torch.parallel.mesh import init_distributed, make_mesh
    from daft_exprt_torch.parallel.vocoder_sharding import (
        make_sharded_vocoder,
    )
    hp = HyperParams(verbose=False, training_files='x', validation_files='x',
                     output_directory='/nonexistent', language='english',
                     speakers=['a'])
    for call in (lambda: resolve_device(),
                 lambda: resolve_device('cuda'),
                 lambda: DaftExprt.from_hparams(hp),
                 lambda: train(hp),
                 lambda: init_generator_params(0),
                 lambda: HiFiGanVocoder({}, fast='bf16'),
                 lambda: MelExtractor(hp),
                 lambda: frame_energy(np.zeros((80, 4), np.float32)),
                 lambda: PitchTracker(hp),
                 lambda: extract_pitch(np.zeros(4000, np.float32), 22050, hp,
                                       method='device'),
                 lambda: extract_features('/nonexistent', '/nonexistent', hp),
                 lambda: extract_reference_parameters(
                     '/nonexistent/ref.wav', '/nonexistent', hp),
                 lambda: griffin_lim_reconstruction_from_mel_spec(
                     np.zeros((80, 4), np.float32), hp),
                 lambda: make_gan_steps(),
                 lambda: make_loss_mel_fn(),
                 lambda: init_mpd_params(0),
                 lambda: init_msd_params(0),
                 lambda: finetune('/nonexistent', '/nonexistent/out', {}),
                 lambda: fine_tuning(hp, '/nonexistent'),
                 lambda: init_distributed(0, 1, 'file:///nonexistent/store'),
                 lambda: make_mesh(),
                 lambda: make_sharded_vocoder(make_mesh()),
                 lambda: dryrun_multichip(1),
                 lambda: entry(),
                 lambda: train(hp, mesh=make_mesh())):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('mps')

"""The port's fine-tuning dataset generation (daft_exprt_torch/fine_tune.py)
against the JAX package's ``fine_tuning`` on a corpus the test writes: two
speakers x four utterances (features, markers, wavs), batch 4, a small
acoustic model with the same parameters on both sides
(``bridge.acoustic_state_from_jax``), ``compute_dtype='float32'`` and the
plain attention. One utterance's marker crop is under a second and one's
feature mel is two frames longer than the mel of its crop, so both skip
branches run.

Bands: the same files written, each ``.wav`` bit-equal, each ``.npy``
within rel-L2 1e-4 of JAX's."""
import os

import jax
import numpy as np
import pytest

from daft_exprt_tpu.data import prepare_data_iterators as jax_iterators
from daft_exprt_tpu.fine_tune import fine_tuning as jax_fine_tuning
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.parallel.train_step import MODEL_INPUT_KEYS
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.fine_tune import fine_tuning
from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.text.symbols import symbols_english

from tests.torch_port_utils import rel_l2

SR, HOP = 22050, 256
SPEAKERS = ['speaker_0', 'speaker_1']
SMALL = {'nb_blocks': 1, 'hidden_embed_dim': 16, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 24,
         'conv_dropout': 0.1}
SHORT, MISMATCH = ('speaker_0', 'utt_2'), ('speaker_1', 'utt_1')


def write_corpus(root, seed=0):
    """wavs under root/dataset/<speaker>/wavs, features under
    root/features/<speaker>, train and validation lists. A feature mel has
    the frame count of its marker crop's mel, n // 256 for n samples (two
    more for MISMATCH)."""
    rng = np.random.RandomState(seed)
    lines = []
    for s, spk in enumerate(SPEAKERS):
        wav_dir = os.path.join(root, 'dataset', spk, 'wavs')
        feat_dir = os.path.join(root, 'features', spk)
        os.makedirs(wav_dir)
        os.makedirs(feat_dir)
        for u in range(4):
            name = f'utt_{u}'
            begin = round(rng.uniform(0.05, 0.3), 3)
            span = 0.8 if (spk, name) == SHORT else rng.uniform(1.1, 1.5)
            end = round(begin + span, 3)
            total = end + rng.uniform(0.05, 0.3)
            wav = (0.2 * rng.randn(int(total * SR))).astype(np.float32)
            save_wav(os.path.join(wav_dir, f'{name}.wav'), wav, SR)
            T = (int(end * SR) - int(begin * SR)) // HOP
            T += 2 if (spk, name) == MISMATCH else 0
            L = rng.randint(8, 14)
            dur = np.full(L, T // L)
            dur[rng.choice(L, T - dur.sum(), replace=False)] += 1
            cum = np.concatenate([[0], np.cumsum(dur)]) / T
            t = [begin + (end - begin) * c for c in cum]
            ids = rng.randint(7, len(symbols_english), size=L)
            base = os.path.join(feat_dir, name)
            with open(f'{base}.markers', 'w') as f:
                f.writelines(
                    f'{t[j]:.3f}\t{t[j + 1]:.3f}\t{dur[j]}\t'
                    f'{symbols_english[ids[j]]}\tword\t{j}\n'
                    for j in range(L))
            np.save(f'{base}.npy', (rng.randn(80, T) - 4.0).astype(
                np.float32))
            for ext, n in (('frames', T), ('symbols', L)):
                with open(f'{base}.{ext}_nrg', 'w') as f:
                    f.writelines(f'{v:.3f}\n' for v in
                                 np.abs(rng.randn(n)) * 5 + 8)
                with open(f'{base}.{ext}_f0', 'w') as f:
                    f.writelines(f'{v:.3f}\n' for v in np.where(
                        rng.rand(n) < 0.8, rng.randn(n) * 0.2 + 5.0, 0.0))
            np.save(f'{base}.spk_emb.npy', rng.randn(192).astype(np.float32))
            lines.append(f'{feat_dir}|{name}|{s}\n')
    lists = os.path.join(root, 'lists')
    os.makedirs(lists)
    for split in ('train', 'val'):
        with open(os.path.join(lists, f'{split}.txt'), 'w') as f:
            f.writelines(lines)
    return os.path.join(root, 'dataset')


def _kw(root):
    lists = os.path.join(root, 'lists')
    return dict(verbose=False, language='english', speakers=SPEAKERS,
                training_files=os.path.join(lists, 'train.txt'),
                validation_files=os.path.join(lists, 'val.txt'),
                output_directory=os.path.join(root, 'out'),
                phoneme_encoder=dict(SMALL), accent_encoder=dict(SMALL),
                frame_decoder=dict(SMALL), length_buckets=[16, 32],
                frame_buckets=[128, 256], batch_size=4,
                compute_dtype='float32', fused_attention=False,
                dynamic_stats_subset_size=3)


@pytest.fixture(scope='module')
def written(tmp_path_factory):
    roots = {}
    for side in ('jax', 'torch'):
        root = str(tmp_path_factory.mktemp(f'ft_{side}'))
        roots[side] = (root, write_corpus(root))
    root, dataset = roots['jax']
    jhp = JaxHParams(**_kw(root))
    model = JaxDaftExprt.from_hparams(jhp)
    batch, _, _ = next(iter(jax_iterators(jhp, bucket=True)[0]))
    params = model.init({'params': jax.random.PRNGKey(0),
                         'dropout': jax.random.PRNGKey(1)},
                        **{k: batch[k] for k in MODEL_INPUT_KEYS})['params']
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    j_out = jax_fine_tuning(jhp, dataset, params=params)
    root, dataset = roots['torch']
    t_out = fine_tuning(HyperParams(**_kw(root)), dataset,
                        params=acoustic_state_from_jax(params), device='cpu')
    return j_out, t_out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_files_written(written):
    j_out, t_out = written
    assert os.path.basename(t_out) == 'fine_tuning_dataset'
    files = _files(t_out)
    assert files == _files(j_out)
    names = {(f.split(os.sep)[0], f.split(os.sep)[1][:-4]) for f in files}
    assert len(files) == 12 and len(names) == 6
    assert SHORT not in names and MISMATCH not in names
    assert fine_tuning.counts == {'written': 6, 'shape_mismatch': 1,
                                  'too_short': 1}


def test_wavs_bit_equal(written):
    j_out, t_out = written
    for f in _files(t_out):
        if f.endswith('.wav'):
            with open(os.path.join(t_out, f), 'rb') as a, \
                    open(os.path.join(j_out, f), 'rb') as b:
                assert a.read() == b.read(), f


def test_mels_match_jax(written):
    j_out, t_out = written
    n = 0
    for f in _files(t_out):
        if f.endswith('.npy'):
            a, b = np.load(os.path.join(t_out, f)), np.load(
                os.path.join(j_out, f))
            assert a.shape == b.shape and a.dtype == np.float32
            assert rel_l2(a, b) <= 1e-4, (f, rel_l2(a, b))
            n += 1
    assert n == 6


def test_needs_params_or_checkpoint(tmp_path):
    root = str(tmp_path)
    write_corpus(root, seed=1)
    with pytest.raises(ValueError, match='no checkpoint'):
        fine_tuning(HyperParams(**_kw(root)), os.path.join(root, 'dataset'),
                    device='cpu')

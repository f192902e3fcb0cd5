"""The port's reference acoustic-checkpoint loader
(daft_exprt_torch/checkpoint.py ``convert_torch_state_dict``,
``load_torch_checkpoint``) against the JAX package's converter followed by
``bridge.acoustic_state_from_jax``, without the reference model.

A state dict in the reference implementation's layout is made from a
random JAX DaftExprt tree (tests/test_torch_acoustic.py's small model) by
inverting the JAX converter's key map, checked by converting it back, and
saved. Both routes must give the same tensors, leaf for leaf and bit for
bit (the layouts only move: a transpose there and back).
"""
import re

import numpy as np
import pytest
import torch

from daft_exprt_tpu import checkpoint as jckpt
from daft_exprt_torch import checkpoint as tckpt
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.models.daft_exprt import DaftExprt

from tests.test_torch_acoustic import HP_KW, _jax_model

# flax path (dots) -> the reference's module path, first match wins
_RULES = [
    (r'^(\w+)\.block_(\d+)\.attention\.in_proj$',
     r'\1.blocks.\2.attention.multi_head_attention.in_proj'),
    (r'^(\w+)\.block_(\d+)\.attention\.out_proj$',
     r'\1.blocks.\2.attention.multi_head_attention.out_proj'),
    (r'^(\w+)\.block_(\d+)\.feed_forward\.conv1\.conv$',
     r'\1.blocks.\2.feed_forward.convs.0.conv'),
    (r'^(\w+)\.block_(\d+)\.feed_forward\.conv2\.conv$',
     r'\1.blocks.\2.feed_forward.convs.2.conv'),
    (r'^(\w+)\.block_(\d+)\.', r'\1.blocks.\2.'),
    (r'^accent_encoder\.conv_(\d)\.conv$',
     lambda m: f'accent_encoder.convs.{4 * int(m.group(1))}.conv'),
    (r'^accent_encoder\.ln_(\d)$',
     lambda m: f'accent_encoder.convs.{4 * int(m.group(1)) + 2}'),
    (r'^speaker_classifier\.fc(\d)\.',
     lambda m: f'speaker_classifier.classifier.{2 * int(m.group(1)) - 1}.'),
    (r'^gaussian_upsampling\.range_projection\.',
     'gaussian_upsampling.projection.0.'),
]


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def reference_state_dict(params):
    """A flax DaftExprt tree in the reference implementation's names and
    torch layouts (the JAX converter's key map inverted)."""
    sd = {}
    for path, arr in _flat(params):
        module, leaf = '.'.join(path[:-1]), path[-1]
        for pat, rep in _RULES:
            module, n = re.subn(pat, rep, module)
            if n:
                break
        if leaf == 'kernel':
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        if module.endswith('.in_proj'):
            key = f'{module}_{"weight" if leaf == "kernel" else leaf}'
        elif leaf == 'post_multipliers':
            key = f'{module}.{leaf}'
        else:
            key = f'{module}.{"bias" if leaf == "bias" else "weight"}'
        assert key not in sd, key
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


class Refusable:
    """Not a tensor container: loading it needs full unpickling."""


@pytest.fixture(scope='module')
def reference():
    _, _, params = _jax_model('float32', True)
    sd = reference_state_dict(params)
    # the inverse is right: JAX's converter gives the tree back exactly
    back = dict(_flat(jckpt.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})))
    assert set(back) == set(dict(_flat(params)))
    for path, arr in _flat(params):
        assert np.array_equal(back[path], arr), path
    return params, sd


def _port_model():
    return DaftExprt.from_hparams(HyperParams(**HP_KW), device='cpu')


@pytest.mark.parametrize('layout', ['checkpoint', 'bare', 'ddp'])
def test_loader_matches_jax_converter_and_bridge(tmp_path, reference, layout):
    params, sd = reference
    assert 'accent_encoder.convs.10.weight' in sd
    assert 'speaker_classifier.classifier.5.linear_layer.bias' in sd
    assert 'phoneme_encoder.blocks.1.attention.multi_head_attention.' \
        'in_proj_weight' in sd
    if layout == 'ddp':
        sd = {f'module.{k}': v for k, v in sd.items()}
    payload = {'state_dict': sd, 'config_params': {'batch_size': 16},
               'iteration': 1200, 'learning_rate': 1e-4,
               'best_val_loss': 0.5} if layout == 'checkpoint' else sd
    path = str(tmp_path / 'DaftExprt.pt')
    torch.save(payload, path)

    model = _port_model()
    state, config_params, meta = tckpt.load_torch_checkpoint(path,
                                                             model=model)
    jparams, jconfig, jmeta = jckpt.load_torch_checkpoint(path)
    want = acoustic_state_from_jax(jax_to_numpy(jparams))
    assert sorted(state) == sorted(want)
    assert len(state) == len(list(_flat(params)))
    for k in want:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], want[k]), k
    assert config_params == jconfig and meta == jmeta
    if layout == 'checkpoint':
        assert meta == {'iteration': 1200, 'learning_rate': 1e-4,
                        'best_val_loss': 0.5}
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def jax_to_numpy(tree):
    return {k: jax_to_numpy(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def test_strip_ddp_prefix_matches_jax():
    sd = {'module.a.weight': 1, 'b.bias': 2, 'x.module.c': 3}
    assert tckpt.strip_ddp_prefix(sd) == jckpt.strip_ddp_prefix(sd) == {
        'a.weight': 1, 'b.bias': 2, 'x.module.c': 3}


def test_loader_refuses_pickles_and_missing_keys(tmp_path, reference):
    _, sd = reference
    path = str(tmp_path / 'pickled.pt')
    torch.save({'state_dict': sd, 'extra': Refusable()}, path)
    with pytest.raises(ValueError, match='refusing to unpickle'):
        tckpt.load_torch_checkpoint(path)
    for key in ('accent_encoder.convs.6.bias',
                'frame_decoder.blocks.0.feed_forward.convs.2.conv.weight',
                'gaussian_upsampling.projection.0.linear_layer.weight'):
        path = str(tmp_path / 'missing.pt')
        torch.save({k: v for k, v in sd.items() if k != key}, path)
        with pytest.raises(KeyError):
            tckpt.load_torch_checkpoint(path, model=_port_model())
    # an optional key the model needs, or a block the model lacks, fails
    # the strict load
    state = tckpt.convert_torch_state_dict(
        {k: v for k, v in sd.items() if k != 'style_adapter.post_multipliers'})
    with pytest.raises(RuntimeError, match='post_multipliers'):
        _port_model().load_state_dict(state, strict=True)
    extra = dict(sd, **{k.replace('blocks.1.', 'blocks.2.'): v
                        for k, v in sd.items()
                        if k.startswith('frame_decoder.blocks.1.')})
    path = str(tmp_path / 'deeper.pt')
    torch.save(extra, path)
    with pytest.raises(RuntimeError, match='block_2'):
        tckpt.load_torch_checkpoint(path, model=_port_model())
    state = tckpt.convert_torch_state_dict(extra, nb_fd_blocks=2)
    _port_model().load_state_dict(state, strict=True)

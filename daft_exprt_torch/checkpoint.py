"""Torch-native checkpoints of the training state.

A checkpoint holds the model's state dict and the optimizer's, written by
``torch.save`` (tensors, numbers and strings only), and a JSON sidecar
``<path>.json`` with the iteration, learning rate, best validation loss and
config, as the JAX package's ``checkpoint.py`` writes it. Every load goes
through ``torch.load(weights_only=True)``: a file that would need
unpickling of other objects is refused, never executed.

``convert_reference_pitch_predictor`` maps the reference implementation's
pitch-predictor state dict onto the port's module.
"""
import json
import os
import pickle

import torch


def save_checkpoint(path, model_state, optimizer_state=None, iteration=0,
                    learning_rate=0.0, best_val_loss=float('inf'),
                    config_params=None):
    """Write ``path`` (the state dicts) and ``path + '.json'`` (metadata),
    each through a temporary file, so a reader never sees half a file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save({'model': model_state, 'optimizer': optimizer_state}, tmp)
    os.replace(tmp, path)
    meta = {
        'iteration': int(iteration),
        'learning_rate': float(learning_rate),
        'best_val_loss': float(best_val_loss),
        'config_params': config_params or {},
    }
    with open(tmp, 'w') as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(tmp, path + '.json')


def torch_load_guarded(path):
    """``torch.load(path, map_location='cpu', weights_only=True)``; a file
    that needs full unpickling raises ``ValueError``."""
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f'{path} is not loadable with torch.load('
                         f'weights_only=True): refusing to unpickle it '
                         f'({e})') from e


def load_checkpoint(path):
    """Returns (payload, meta): payload {'model': state dict, 'optimizer':
    state dict or None} on the CPU; meta the sidecar's dict ({} if
    absent)."""
    payload = torch_load_guarded(path)
    meta = {}
    if os.path.isfile(path + '.json'):
        with open(path + '.json') as f:
            meta = json.load(f)
    return payload, meta


def convert_reference_pitch_predictor(sd):
    """The reference PitchPredictor's state dict (``conv_layers.*``,
    weight-normed convs, 'module.' prefix stripped) in the port's
    ``PitchPredictor`` names, weight norm folded: the counterpart of the
    JAX package's ``convert_torch_pitch_predictor``."""
    out = {}

    def conv(prefix, name):
        v = sd[f'{prefix}.weight_v'].float()
        g = sd[f'{prefix}.weight_g'].float()
        norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        out[f'{name}.weight'] = g * v / norm.clamp(min=1e-12)
        out[f'{name}.bias'] = sd[f'{prefix}.bias'].float()

    for j, (ci, bi) in enumerate(((0, 2), (4, 6), (8, 10))):
        conv(f'conv_layers.{ci}.conv', f'conv_{j}')
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            out[f'bn_{j}.{leaf}'] = sd[f'conv_layers.{bi}.{leaf}'].float()
    conv('conv_layers.12.conv', 'conv_out')
    return out

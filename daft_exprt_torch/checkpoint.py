"""Torch-native checkpoints of the training state.

A checkpoint holds the model's state dict and the optimizer's, written by
``torch.save`` (tensors, numbers and strings only), and a JSON sidecar
``<path>.json`` with the iteration, learning rate, best validation loss and
config, as the JAX package's ``checkpoint.py`` writes it. Every load goes
through ``torch.load(weights_only=True)``: a file that would need
unpickling of other objects is refused, never executed.

``convert_torch_state_dict`` / ``load_torch_checkpoint`` read the
reference implementation's DaftExprt ``.pt`` checkpoints, and
``convert_reference_pitch_predictor`` its pitch-predictor state dict, onto
the port's modules.
"""
import json
import os
import pickle

import numpy as np
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


# ----------------------------------------------------------------------
# reference DaftExprt checkpoints
# ----------------------------------------------------------------------

def strip_ddp_prefix(state_dict):
    """Drop DistributedDataParallel's 'module.' key prefix."""
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in state_dict.items()}


def _count_blocks(sd, module):
    idxs = set()
    prefix = f'{module}.blocks.'
    for key in sd:
        if key.startswith(prefix):
            idxs.add(int(key[len(prefix):].split('.', 1)[0]))
    return (max(idxs) + 1) if idxs else 0


def _reference_names(sd, nb_pe_blocks, nb_ae_blocks, nb_fd_blocks):
    """(port key, reference key) for every parameter of the port's
    ``DaftExprt``. The layouts agree (torch's on both sides): only the
    names differ."""
    pairs = []

    def same(*prefixes):
        for p in prefixes:
            pairs.extend((f'{p}.{leaf}', f'{p}.{leaf}')
                         for leaf in ('weight', 'bias'))

    def moved(port, ref):
        pairs.extend((f'{port}.{leaf}', f'{ref}.{leaf}')
                     for leaf in ('weight', 'bias'))

    def fft_block(module, i):
        port, ref = f'{module}.block_{i}', f'{module}.blocks.{i}'
        mha = f'{ref}.attention.multi_head_attention'
        pairs.extend([(f'{port}.attention.in_proj.weight',
                       f'{mha}.in_proj_weight'),
                      (f'{port}.attention.in_proj.bias',
                       f'{mha}.in_proj_bias')])
        moved(f'{port}.attention.out_proj', f'{mha}.out_proj')
        moved(f'{port}.attention.layer_norm', f'{ref}.attention.layer_norm')
        moved(f'{port}.feed_forward.conv1.conv',
              f'{ref}.feed_forward.convs.0.conv')
        moved(f'{port}.feed_forward.conv2.conv',
              f'{ref}.feed_forward.convs.2.conv')
        moved(f'{port}.feed_forward.layer_norm',
              f'{ref}.feed_forward.layer_norm')

    same('spk_projection.linear_layer')
    pairs.append(('phoneme_encoder.symbols_embedding.weight',
                  'phoneme_encoder.symbols_embedding.weight'))
    for i in range(nb_pe_blocks):
        fft_block('phoneme_encoder', i)
    same('accent_encoder.energy_embedding.conv',
         'accent_encoder.pitch_embedding.conv')
    # the reference's Sequential: convs at 0/4/8, LayerNorms at 2/6/10
    for j, (conv_idx, ln_idx) in enumerate(((0, 2), (4, 6), (8, 10))):
        moved(f'accent_encoder.conv_{j}.conv',
              f'accent_encoder.convs.{conv_idx}.conv')
        moved(f'accent_encoder.ln_{j}', f'accent_encoder.convs.{ln_idx}')
    for i in range(nb_ae_blocks):
        fft_block('accent_encoder', i)
    for j, idx in enumerate((1, 3, 5), start=1):
        moved(f'speaker_classifier.fc{j}.linear_layer',
              f'speaker_classifier.classifier.{idx}.linear_layer')
    same('style_adapter.gammas_predictor.linear_layer',
         'style_adapter.betas_predictor.linear_layer')
    if 'style_adapter.post_multipliers' in sd:
        pairs.append(('style_adapter.post_multipliers',
                      'style_adapter.post_multipliers'))
    same('gaussian_upsampling.duration_projection.conv',
         'gaussian_upsampling.energy_projection.conv',
         'gaussian_upsampling.pitch_projection.conv')
    moved('gaussian_upsampling.range_projection.linear_layer',
          'gaussian_upsampling.projection.0.linear_layer')
    same('frame_decoder.projection.linear_layer')
    for i in range(nb_fd_blocks):
        fft_block('frame_decoder', i)
    return pairs


def convert_torch_state_dict(state_dict, nb_pe_blocks=None,
                             nb_ae_blocks=None, nb_fd_blocks=None):
    """The reference implementation's DaftExprt state dict ('module.'
    prefixes stripped) -> the port's ``DaftExprt`` state dict, float32.
    Block counts are inferred from the state dict unless given; a missing
    reference key raises ``KeyError``, keys the port has no place for are
    ignored (as in the JAX package's converter)."""
    sd = strip_ddp_prefix(dict(state_dict))
    if nb_pe_blocks is None:
        nb_pe_blocks = _count_blocks(sd, 'phoneme_encoder')
    if nb_ae_blocks is None:
        nb_ae_blocks = _count_blocks(sd, 'accent_encoder')
    if nb_fd_blocks is None:
        nb_fd_blocks = _count_blocks(sd, 'frame_decoder')
    out = {}
    for port_key, ref_key in _reference_names(sd, nb_pe_blocks,
                                              nb_ae_blocks, nb_fd_blocks):
        v = sd[ref_key]
        v = v.detach() if isinstance(v, torch.Tensor) \
            else torch.tensor(np.asarray(v))
        out[port_key] = v.to(torch.float32).contiguous()
    return out


def load_torch_checkpoint(path, model=None):
    """Read a reference ``.pt`` checkpoint through ``torch_load_guarded``
    (a file that needs unpickling is refused) and convert it. Returns
    (state dict, config_params, meta); meta carries iteration,
    learning_rate and best_val_loss when present. With ``model`` (the
    port's ``DaftExprt``) the state dict is loaded into it with
    ``strict=True``: a missing or unexpected parameter raises."""
    ckpt = torch_load_guarded(path)
    if isinstance(ckpt, dict) and 'state_dict' in ckpt:
        sd = ckpt['state_dict']
        config_params = ckpt.get('config_params', {})
        meta = {k: ckpt.get(k) for k in
                ('iteration', 'learning_rate', 'best_val_loss')}
    else:
        sd, config_params, meta = ckpt, {}, {}
    state = convert_torch_state_dict(sd)
    if model is not None:
        model.load_state_dict(state, strict=True)
    return state, config_params, meta

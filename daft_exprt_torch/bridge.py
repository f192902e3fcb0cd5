"""Carry JAX parameter trees (as numpy) into the port.

``acoustic_state_from_jax`` is the inverse of
``daft_exprt_tpu/checkpoint.py::convert_torch_state_dict``, but onto the
port's own module names, which mirror the flax paths: the state-dict key
of a leaf is its flax path joined by dots, with the leaf renamed and laid
out torch's way:

- Dense ``kernel`` (in, out)      -> ``weight`` (out, in)
- Conv ``kernel`` (k, in, out)    -> ``weight`` (out, in, k)
- LayerNorm ``scale``             -> ``weight``
- Embed ``embedding``             -> ``weight``
- ``bias``, ``post_multipliers``  -> as they are

Any other leaf raises: nothing is left unmapped silently.

``pitch_predictor_from_jax`` maps the frozen pitch predictor's params the
same way and its flax BatchNorm statistics (``batch_stats``: ``mean``,
``var``) onto ``running_mean`` / ``running_var``.

``generator_from_jax`` is a copy: the JAX vocoder keeps its kernels in
torch layout already ((out, in, k), and (in, out, k) for the transposed
convs).

``discriminators_from_jax`` maps the JAX MPD and MSD trees (weight norm
``g``/``v``/``b``, spectral norm ``w``/``b``, torch layout) and the
spectral norm's ``sn_state`` onto the state dicts of the port's
``MultiPeriodDiscriminator`` and ``MultiScaleDiscriminator``, whose module
names are the JAX tree's keys; ``u`` becomes the buffer of its conv.
"""
import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _leaf(path, value):
    name = path[-1]
    arr = np.asarray(value, dtype=np.float32)
    if name == 'kernel':
        if arr.ndim == 2:
            return 'weight', arr.T
        if arr.ndim == 3:
            return 'weight', arr.transpose(2, 1, 0)
        raise ValueError(f'{"/".join(path)}: kernel of rank {arr.ndim}')
    if name in ('scale', 'embedding'):
        return 'weight', arr
    if name in ('bias', 'post_multipliers'):
        return name, arr
    raise KeyError(f'bridge has no mapping for leaf {"/".join(path)}')


def acoustic_state_from_jax(np_params):
    """Flax DaftExprt params (nested dicts of arrays) -> torch state dict.
    Load it with ``DaftExprt.load_bridged``."""
    state = {}
    for path, value in _flatten(np_params):
        name, arr = _leaf(path, value)
        key = '.'.join(path[:-1] + (name,))
        if key in state:
            raise KeyError(f'two leaves map to {key}')
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def pitch_predictor_from_jax(params, batch_stats):
    """Flax PitchPredictor variables -> the port's ``PitchPredictor`` state
    dict (load it with ``load_state_dict(..., strict=True)``)."""
    state = acoustic_state_from_jax(params)
    names = {'mean': 'running_mean', 'var': 'running_var'}
    for path, value in _flatten(batch_stats):
        if path[-1] not in names:
            raise KeyError(f'bridge has no mapping for batch stat '
                           f'{"/".join(path)}')
        key = '.'.join(path[:-1] + (names[path[-1]],))
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32,
                                               copy=True))
    return state


def generator_from_jax(np_params):
    """JAX HiFi-GAN params -> the port's params (same nesting, torch
    tensors). Every leaf must be a 'w' or 'b' of a conv."""
    out = {}
    for name, sub in np_params.items():
        if not isinstance(sub, dict):
            raise KeyError(f'bridge: generator leaf {name} is not a layer')
        if name.startswith('resblock_'):
            out[name] = generator_from_jax(sub)
            continue
        if set(sub) != {'w', 'b'}:
            raise KeyError(f'bridge: layer {name} has leaves {sorted(sub)}')
        out[name] = {k: torch.from_numpy(
            np.array(v, dtype=np.float32, copy=True)) for k, v in sub.items()}
    return out


_DISC_LEAVES = ('g', 'v', 'b', 'w')


def _disc_state(tree, what):
    state = {}
    for path, value in _flatten(tree):
        if len(path) != 3 or path[-1] not in _DISC_LEAVES:
            raise KeyError(f'bridge has no mapping for {what} leaf '
                           f'{"/".join(path)}')
        state['.'.join(path)] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))
    return state


def discriminators_from_jax(mpd, msd, sn_state):
    """JAX ``init_mpd_params`` / ``init_msd_params`` trees (as numpy) ->
    {'mpd': state dict, 'msd': state dict with the ``u`` buffers of
    ``sn_state``}; load each with ``load_state_dict(..., strict=True)``.
    A leaf that is not a conv's g, v, b or w, or a state vector without
    its conv, raises."""
    msd_state = _disc_state(msd, 'MSD')
    for path, value in _flatten(sn_state):
        conv = '.'.join(path)
        if len(path) != 2 or f'{conv}.w' not in msd_state:
            raise KeyError(f'bridge: sn_state leaf {"/".join(path)} has no '
                           'spectral-norm conv')
        msd_state[f'{conv}.u'] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))
    return {'mpd': _disc_state(mpd, 'MPD'), 'msd': msd_state}

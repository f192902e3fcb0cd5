"""Tensor-parallel sharding of the HiFi-GAN generator (PyTorch port of
``daft_exprt_tpu/parallel/vocoder_sharding.py``).

The generator's channels (512 -> 256 -> 128 -> 64 -> 32 in V1) shard over
the mesh's model axis: conv kernels on their output-channel axis (axis
0 of a conv's (out, in, k), axis 1 of a transposed conv's (in, out, k)),
biases likewise, each only where the width divides by the axis and is
above 1; everything else (conv_post, one output channel) is replicated.
The batch splits over the data axis: each rank passes its rows.

The JAX version leaves the collectives to XLA's partitioner. Here each
sharded conv computes its slice of the output channels and all-gathers it
over the model group before the next op, so every op between two convs
sees every channel, as in :func:`models.hifigan.generator_forward`'s plain
per-conv route, which this one follows op for op (the JAX version runs
``generator_forward`` without Pallas).
"""
import torch
import torch.nn.functional as F

from daft_exprt_torch.models.hifigan import DEFAULT_CONFIG, _lrelu
from daft_exprt_torch.parallel.mesh import all_gather_cat


def _map_with_path(fn, tree, path=()):
    return {k: (_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def generator_param_specs(params, mesh):
    """The axis each generator leaf shards on over the mesh's model axis
    (an int), or None where it is replicated: JAX's
    ``generator_param_specs`` rule, leaf for leaf."""
    n_shard = mesh.n_model

    def spec_for(path, w):
        if path[-1] == 'b':
            return 0 if w.shape[0] % n_shard == 0 and \
                w.shape[0] >= n_shard else None
        if w.ndim == 3:
            out_axis = 1 if str(path[0]).startswith('ups') else 0
            if w.shape[out_axis] % n_shard == 0 and \
                    w.shape[out_axis] >= n_shard and w.shape[out_axis] > 1:
                return out_axis
        return None

    return _map_with_path(spec_for, params)


def shard_generator_params(params, mesh):
    """This rank's slice of every sharded leaf (its model coordinate's
    block of the axis), the replicated leaves whole; on the mesh's
    device."""
    specs = generator_param_specs(params, mesh)
    n, m = mesh.n_model, mesh.model_rank

    def take(path, w):
        spec = specs
        for k in path:
            spec = spec[k]
        w = w.to(mesh.device)
        if spec is None:
            return w
        size = w.shape[spec] // n
        return w.narrow(spec, m * size, size).contiguous()

    return _map_with_path(take, params)


def make_sharded_vocoder(mesh, config=None):
    """Returns ``vocoder(params, mel) -> wav``: ``params`` from
    :func:`shard_generator_params` on this rank, ``mel`` this rank's rows
    (B_local, n_mels, T), the same on the ranks of one model group; the
    result is their (B_local, 1, T * hop) waveform, computed with this
    rank's channel slices, on the mesh's device."""
    cfg = config or DEFAULT_CONFIG
    mgroup = mesh.model_group
    c0 = cfg['upsample_initial_channel']
    n_kernels = len(cfg['resblock_kernel_sizes'])

    def gather(y, local_out, full_out):
        return y if local_out == full_out else all_gather_cat(y, mgroup, 1)

    def conv(x, leaf, full_out, dilation=1):
        w = leaf['w']
        y = F.conv1d(x, w, padding=dilation * (w.shape[-1] - 1) // 2,
                     dilation=dilation) + leaf['b'][None, :, None]
        return gather(y, w.shape[0], full_out)

    def conv_t(x, leaf, full_out, stride, padding):
        w = leaf['w']
        y = F.conv_transpose1d(x, w, stride=stride, padding=padding) + \
            leaf['b'][None, :, None]
        return gather(y, w.shape[1], full_out)

    def resblock(p, x, dils, C):
        for i, d in enumerate(dils):
            if cfg['resblock'] == '1':
                xt = conv(_lrelu(x), p[f'convs1_{i}'], C, dilation=d)
                xt = conv(_lrelu(xt), p[f'convs2_{i}'], C)
            else:
                xt = conv(_lrelu(x), p[f'convs_{i}'], C, dilation=d)
            x = xt + x
        return x

    def vocoder(params, mel):
        mel = torch.as_tensor(mel).to(mesh.device)
        x = conv(mel, params['conv_pre'], c0)
        for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                       cfg['upsample_kernel_sizes'])):
            C = c0 // 2 ** (i + 1)
            x = conv_t(_lrelu(x), params[f'ups_{i}'], C, u, (k - u) // 2)
            xs = None
            for j, dils in enumerate(cfg['resblock_dilation_sizes']):
                y = resblock(params[f'resblock_{i}_{j}'], x, dils, C)
                xs = y if xs is None else xs + y
            x = xs / n_kernels
        x = conv(_lrelu(x), params['conv_post'], 1)
        return torch.tanh(x)

    return vocoder

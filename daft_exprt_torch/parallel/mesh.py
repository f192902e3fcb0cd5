"""Process groups and the (data, model) grid (PyTorch port of
``daft_exprt_tpu/parallel/mesh.py``).

One process per rank; each rank holds one device (two ranks may share a
card). :func:`init_distributed` sets up the default process group with
``torch.distributed``: NCCL for CUDA tensors and gloo for CPU tensors,
chosen by the device, unless the caller names a backend (two ranks sharing
one card pass ``backend='gloo'`` with CUDA tensors). Nothing falls back on
its own: a missing card raises, and so does a backend that does not come up.

:func:`make_mesh` lays the world out as the JAX mesh lays out its devices:
rank = d * n_model + m, with a sub-group along each axis. Every entry point
that takes a mesh takes this rank's *local* rows, the JAX multi-process
meaning (the global batch is local x n_data), and returns this rank's rows:
:func:`shard_batch` moves them to the device, and a caller that holds the
global batch takes its rows with :func:`data_rows` once.
"""
import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from daft_exprt_torch.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(rank, world_size, init_method, backend=None,
                     timeout=DEFAULT_TIMEOUT, device=None):
    """Join the default process group as ``rank`` of ``world_size``.

    ``init_method``: a rendezvous URL (``tcp://localhost:<port>`` or
    ``file://<path>``). ``device``: this rank's device (default cuda; a
    cuda device without an index takes card ``rank % device_count``);
    raises without CUDA unless given 'cpu'. ``backend``: default 'nccl'
    for a CUDA device and 'gloo' for the CPU. ``timeout``: a timedelta or
    seconds, for every collective of the group. Returns the device."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', rank % torch.cuda.device_count())
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend or ('nccl' if dev.type == 'cuda'
                                        else 'gloo'),
                            init_method=init_method, rank=int(rank),
                            world_size=int(world_size), timeout=timeout)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data`` x ``n_model`` grid of ranks
    (rank = d * n_model + m) and the sub-groups along each axis: the data
    group holds the ranks of this rank's model coordinate, the model group
    those of its data coordinate."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: object
    model_group: object

    @property
    def size(self):
        return self.n_data * self.n_model

    @property
    def data_rank(self):
        """This rank's coordinate along the data axis."""
        return self.rank // self.n_model

    @property
    def model_rank(self):
        """This rank's coordinate along the model axis."""
        return self.rank % self.n_model


def mesh_device(mesh, device=None):
    """The device of an entry point given ``mesh`` and ``device``: the
    mesh's where there is one (``device``, if also given, must be of its
    type), else ``resolve_device(device)``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f'device {device} is not the mesh\'s '
                         f'{mesh.device}')
    return mesh.device


def grid_coords(rank, n_data, n_model):
    """(d, m) of ``rank`` in an n_data x n_model grid, or None outside."""
    if rank >= n_data * n_model:
        return None
    return rank // n_model, rank % n_model


def make_mesh(n_data=None, n_model=1, device=None):
    """The (data, model) grid over the default process group's ranks.

    ``n_data`` defaults to world // n_model; a grid larger than the world
    raises ``ValueError``. Every rank of the world must call it (the
    sub-groups are made collectively); a rank outside a smaller grid gets
    None. ``device``: this rank's device (default cuda, the current card;
    raises without CUDA unless given 'cpu')."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError('no process group: call init_distributed first')
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f'mesh {n_data}x{n_model} exceeds {world} ranks')

    def groups(rank_lists):
        mine = None
        for ranks in rank_lists:
            g = dist.group.WORLD if len(ranks) == world else \
                dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data_group = groups([[d * n_model + m for d in range(n_data)]
                         for m in range(n_model)])
    model_group = groups([[d * n_model + m for m in range(n_model)]
                          for d in range(n_data)])
    if grid_coords(rank, n_data, n_model) is None:
        return None
    return Mesh(n_data, n_model, rank, dev, data_group, model_group)


def data_rows(n_global, mesh):
    """(lo, hi): the rows of a global batch of ``n_global`` that this rank's
    data coordinate holds, for a caller that has the global batch (every
    mesh entry point takes this rank's rows); raises JAX's error where they
    do not divide."""
    if n_global % mesh.n_data != 0:
        raise ValueError(f"global batch {n_global} does not divide the mesh "
                         f"'data' axis ({mesh.n_data} shards)")
    b = n_global // mesh.n_data
    lo = mesh.data_rank * b
    return lo, lo + b


def shard_batch(batch, mesh):
    """This process's *local* rows, a flat dict of host arrays (JAX's
    multi-process meaning: the global batch is local x n_data, the rows the
    sampler shard ``host_id::num_hosts`` gives each process) -> tensors on
    the mesh's device; every leaf must have the same leading size."""
    sizes = {int(np.shape(v)[0]) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f'batch leaves disagree on the batch size: {sizes}')
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True)
            for k, v in batch.items()}


def all_gather_cat(t, group, dim):
    """Concatenate every rank's ``t`` (equal shapes) along ``dim``, in rank
    order of ``group``. gloo gathers host tensors only, so a CUDA tensor on
    a gloo group goes through an all-reduce of a zero-padded buffer (exact:
    each element is one rank's value plus zeros)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    if t.is_cuda and dist.get_backend(group) == 'gloo':
        r = dist.get_rank(group)
        shape = list(t.shape)
        shape[dim] *= n
        full = t.new_zeros(shape)
        full.narrow(dim, r * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(full, group=group)
        return full
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_grads(params, extras, group, divide_by=None):
    """One all-reduce (sum) of every parameter's gradient and the
    ``extras`` (1-D float32 tensors, e.g. loss values) over one flat
    buffer; the gradients become views of the result. A parameter without
    a gradient counts as a zero one. ``divide_by`` divides the sum (the
    group size averages). Returns the reduced extras."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    extras = [e.reshape(-1).float() for e in extras]
    flat = torch.cat([g.reshape(-1) for g in grads] + extras)
    dist.all_reduce(flat, group=group)
    if divide_by is not None:
        flat.div_(divide_by)
    parts = torch.split(flat, [g.numel() for g in grads]
                        + [e.numel() for e in extras])
    for p, g in zip(params, parts):
        p.grad = g.view_as(p)
    return list(parts[len(grads):])

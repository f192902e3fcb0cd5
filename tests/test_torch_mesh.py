"""The port's process groups and mesh (``daft_exprt_torch/parallel/mesh.py``)
on four gloo ranks against the JAX package's mesh: the (2, 2) grid and its
coordinates and axis groups, the errors, and a rank's rows (``data_rows``
of the global batch, then ``shard_batch``) against
the rows that JAX's multi-process rehearsal feeds each process
(``scripts/rehearse_multihost.py``: rows ``pid * B_local`` to ``(pid + 1) *
B_local`` of the global batch, for the process's data coordinate). Then
``dryrun_multichip(4)`` on four ranks (its print lines are the JAX dry
run's) and ``entry()``'s forward on the CPU."""
import re

import jax
import numpy as np
import pytest
import torch

from daft_exprt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_exprt_torch.parallel.launch import run_ranks

from tests import torch_dist_workers as workers

N_GLOBAL = 8


@pytest.fixture(scope='module')
def layouts():
    return run_ranks(workers.mesh_layout, 4, args=(N_GLOBAL,), device='cpu',
                     timeout=300, threads=1)


def test_grid_and_groups_match_the_jax_mesh(layouts):
    jmesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices('cpu')[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    first = ids.min()
    for rank, out in enumerate(layouts):
        d, m = out['coords']
        assert out['grid_coords'] == (d, m)
        assert ids[d, m] - first == rank          # rank = d * n_model + m
        assert out['shape'] == jmesh.devices.shape
        assert out['data_ranks'] == sorted(ids[:, m] - first)
        assert out['model_ranks'] == sorted(ids[d, :] - first)


def test_errors_match_jax(layouts):
    with pytest.raises(ValueError, match='exceeds'):
        jax_make_mesh(n_data=3, n_model=2, devices=jax.devices('cpu')[:4])
    for out in layouts:
        assert 'mesh 3x2 exceeds 4 ranks' in out['too_large']
        assert out['not_dividing'] == (
            f"global batch {N_GLOBAL + 1} does not divide the mesh 'data' "
            'axis (2 shards)')
        assert 'disagree' in out['ragged']
    # a (1, 2) grid over four ranks leaves ranks 2 and 3 outside it
    assert [out['small'] for out in layouts] == [True, True, False, False]


def test_shard_batch_rows_are_the_rehearsal_rows(layouts):
    glob = {'x': np.arange(N_GLOBAL * 3, dtype=np.float32).reshape(
        N_GLOBAL, 3), 'ids': np.arange(N_GLOBAL, dtype=np.int64)}
    b_local = N_GLOBAL // 2
    for out in layouts:
        pid = out['coords'][0]                    # the data coordinate
        want = {k: v[pid * b_local:(pid + 1) * b_local]
                for k, v in glob.items()}
        got = out['rows']
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


def test_dryrun_multichip_four_ranks(layouts):
    printed = [out['dryrun'] for out in layouts]
    assert printed[1:] == ['', '', '']            # rank 0 prints
    lines = printed[0].splitlines()
    assert len(lines) == 3
    assert re.fullmatch(r'dryrun_multichip\(4\): loss=\d+\.\d{4} '
                        r'grad_norm=\d+\.\d{4}', lines[0]), lines[0]
    assert lines[1] == 'dryrun_multichip(4): 2D mesh (2x2) TP vocoder ok'
    assert re.fullmatch(r'dryrun_multichip\(4\): DP GAN steps ok '
                        r'\(d_loss=-?\d+\.\d{3} g_loss=-?\d+\.\d{3}\)',
                        lines[2]), lines[2]


def test_entry_forward_on_the_cpu():
    from daft_exprt_torch.parallel.dryrun import entry
    fn, (params, batch) = entry(device='cpu')
    mel = fn(params, batch)
    assert mel.shape == (2, 80, 512) and torch.isfinite(mel).all()
    assert torch.equal(mel, fn(params, batch))    # deterministic

"""The port's tensor-parallel vocoder (``parallel/vocoder_sharding.py``) on a
(2, 2) mesh of four gloo ranks against the JAX package's: the same leaves
shard on the same axes (``generator_param_specs``), each rank keeps its
model coordinate's slice, and the waveform of each rank's rows, data over
2 and channels over 2, matches JAX's unsharded ``generator_forward`` on
``tests/test_vocoder_sharding.py``'s ``SMALL_CONFIG`` at atol 2e-5, as the
JAX sharding test holds its own."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from daft_exprt_tpu.models.hifigan import (
    generator_forward, init_generator_params,
)
from daft_exprt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_exprt_tpu.parallel.vocoder_sharding import (
    generator_param_specs as jax_specs,
)
from daft_exprt_torch.parallel.launch import run_ranks

from tests import torch_dist_workers as workers
from tests.test_vocoder_sharding import SMALL_CONFIG


@pytest.fixture(scope='module')
def setup():
    params = jax.tree_util.tree_map(
        np.asarray, init_generator_params(jax.random.PRNGKey(0),
                                          SMALL_CONFIG))
    mel = np.random.RandomState(0).randn(4, 80, 16).astype(np.float32)
    out = run_ranks(workers.tp_vocoder, 4, args=(params, SMALL_CONFIG, mel),
                    device='cpu', timeout=120, threads=1)
    return params, mel, out


def _axis(spec):
    """A JAX PartitionSpec -> the index of its 'model' entry, or None."""
    return next((i for i, a in enumerate(spec) if a == 'model'), None)


def test_specs_and_slices_match_jax(setup):
    params, _, out = setup
    mesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices('cpu')[:4])
    want = jax.tree_util.tree_map(_axis, jax_specs(params, mesh),
                                  is_leaf=lambda x: isinstance(x, P))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    n_sharded = 0
    for rank, res in enumerate(out):
        assert res['specs'] == want
        for path, leaf in flat.items():
            key = '/'.join(p.key for p in path)
            axis = want
            for p in path:
                axis = axis[p.key]
            shape = list(leaf.shape)
            if axis is not None:
                shape[axis] //= 2
                n_sharded += rank == 0
            assert res['shapes'][key] == tuple(shape), key
    assert want['conv_pre']['w'] == 0 and want['ups_0']['w'] == 1
    assert want['conv_post']['w'] is None and n_sharded > 10


def test_tp_waveform_matches_jax(setup):
    params, mel, out = setup
    ref = np.asarray(generator_forward(params, mel, SMALL_CONFIG))
    # rank = d * 2 + m: ranks 0, 1 hold rows 0-1, ranks 2, 3 rows 2-3
    assert [res['rows'] for res in out] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    for res in out:
        lo, hi = res['rows']
        assert res['wav'].shape == ref[lo:hi].shape
        np.testing.assert_allclose(res['wav'], ref[lo:hi], atol=2e-5)
    assert np.array_equal(out[0]['wav'], out[1]['wav'])
    assert np.array_equal(out[2]['wav'], out[3]['wav'])

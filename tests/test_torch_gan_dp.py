"""The port's data-parallel GAN steps (``make_gan_steps(mesh=...)``) on two
gloo ranks, each on its row of a global batch of 2 x 1024 samples, against
JAX's ``make_gan_steps(mesh=...)`` over a 2-device data mesh at the same
global batch and weights (the port's seeded ones, carried over leaf for
leaf), and against the port's single-process steps, on SMALL_CFG with
full-width MPD + MSD. Bands, ``tests/test_vocoder_sharding.py``'s GAN
bands: d_loss and mel L1 relative 1e-4, g_loss 1e-3; against JAX the
parameters within 1e-2 * lr where |g| > 1e-6 (a first Adam step is ~lr *
sign(g), as ``test_torch_vocoder_finetune.py`` holds them) and the new
spectral state max-abs 1e-5; against one process the parameters atol 1e-5.
The spectral state is the same on every rank, and ``finetune`` at a global
batch that does not divide the data axis raises JAX's error. Then
``finetune(mesh=...)`` against one process's ``finetune``. JAX's steps
compile while the ranks run."""
import concurrent.futures
import os

import jax
import numpy as np
import pytest

import daft_exprt_tpu.vocoder_finetune as jv
from daft_exprt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.models.discriminators import (
    init_mpd_params, init_msd_params,
)
from daft_exprt_torch.models.hifigan import init_generator_params
from daft_exprt_torch.parallel.launch import run_ranks

from tests import torch_dist_workers as workers
from tests.torch_port_utils import one_torch_thread

SMALL_CFG = {'sampling_rate': 22050, 'upsample_rates': [8, 2],
             'upsample_kernel_sizes': [16, 4],
             'upsample_initial_channel': 16, 'resblock': '1',
             'resblock_kernel_sizes': [3],
             'resblock_dilation_sizes': [[1, 3]], 'model_in_dim': 80}
# finetune's data are at hop 256: V1's upsampling at a small width
FT_CFG = dict(SMALL_CFG, upsample_rates=[8, 8, 2, 2],
              upsample_kernel_sizes=[16, 16, 4, 4],
              upsample_initial_channel=32)
B, T, SEED, LR = 2, 1024, 0, 1e-4


def _pairs(root, n=4, frames=40):
    """(predicted-mel, wav) pairs for ``finetune``: {name}.npy and
    {name}.wav at 22.05 kHz, seeded."""
    rng = np.random.RandomState(1)
    for i in range(n):
        np.save(os.path.join(root, f'p{i}.npy'),
                (rng.randn(80, frames) - 4).astype(np.float32))
        save_wav(os.path.join(root, f'p{i}.wav'),
                 0.1 * rng.randn(frames * 256), 22050)


def _nest(state):
    """A flat state dict 'a.b.c' -> {'a': {'b': {'c': array}}}."""
    tree = {}
    for key, value in state.items():
        *path, leaf = key.split('.')
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.detach().numpy().copy()
    return tree


def _jax_steps(mel, y):
    """JAX's d_step then g_step over a 2-device data mesh from the ranks'
    seeded weights: (losses, new generator, new discriminators, new
    spectral state) as numpy trees."""
    g_wn = jv.generator_to_weight_norm(workers._numpy(init_generator_params(
        SEED, SMALL_CFG, device='cpu')))
    mpd = _nest(init_mpd_params(SEED + 1, 'cpu').state_dict())
    msd = _nest(init_msd_params(SEED + 1, 'cpu').state_dict())
    sn = {s: {c: leaf.pop('u') for c, leaf in convs.items() if 'u' in leaf}
          for s, convs in msd.items()}
    sn = {s: convs for s, convs in sn.items() if convs}
    mesh = jax_make_mesh(n_data=2, devices=jax.devices('cpu')[:2])
    d_step, g_step, (og, od), loss_mel = jv.make_gan_steps(SMALL_CFG, LR,
                                                           mesh=mesh)
    dp = {'mpd': mpd, 'msd': msd}
    dp2, _, sn2, d_loss = d_step(dp, od.init(dp), sn, g_wn, mel, y)
    g2, _, g_loss, mel_l1 = g_step(g_wn, og.init(g_wn), dp2, sn2, mel, y,
                                   loss_mel(y[:, 0]))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ((float(d_loss), float(g_loss), float(mel_l1)), to_np(g2),
            to_np(dp2), to_np(sn2))


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    rng = np.random.RandomState(0)
    mel = rng.randn(B, 80, T // 16).astype(np.float32)
    y = (0.1 * rng.randn(B, 1, T)).astype(np.float32)
    ft_dir = str(tmp_path_factory.mktemp('gan_dp'))
    _pairs(ft_dir)
    def one_process():
        out = workers.gan_steps(SMALL_CFG, SEED, mel, y)
        out['finetune'] = workers.finetune_run(FT_CFG, SEED, ft_dir,
                                               'single')
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool, \
            one_torch_thread():
        ranks = pool.submit(run_ranks, workers.gan_dp, 2, args=(
            SMALL_CFG, SEED, mel, y, FT_CFG, ft_dir), device='cpu',
            timeout=240, threads=1)
        single = pool.submit(one_process)
        jax_out = _jax_steps(mel, y)
        return single.result(), ranks.result(), ft_dir, jax_out


def _losses_match(got, want):
    (d, g, m), (wd, wg, wm) = got, want
    assert abs(wd - d) < 1e-4 * max(1.0, abs(wd)), (got, want)
    assert abs(wg - g) < 1e-3 * max(1.0, abs(wg)), (got, want)
    assert abs(wm - m) < 1e-4 * max(1.0, abs(wm)), (got, want)


def test_dp_gan_steps_match_single_process(results):
    s, ranks = results[:2]
    for p in ranks:
        _losses_match(p['losses'], s['losses'])
        for part in ('g', 'd'):
            assert set(p[part]) == set(s[part])
            for k, v in p[part].items():
                np.testing.assert_allclose(v, s[part][k], atol=1e-5,
                                           err_msg=str(k))
        np.testing.assert_allclose(p['u'], s['u'], atol=1e-6)
    r0, r1 = ranks
    assert r0['losses'] == r1['losses']
    for part in ('g', 'd'):
        assert all(np.array_equal(v, r1[part][k])
                   for k, v in r0[part].items())
    assert np.array_equal(r0['u'], r1['u'])


def test_dp_gan_steps_match_the_jax_mesh_steps(results):
    """Each rank against JAX's data-parallel steps over the same global
    batch: the three losses, every compared parameter that has a gradient
    above 1e-6 (all of the generator's, the first and last of each
    sub-discriminator), and the spectral state the D step wrote."""
    _, ranks, _, (losses, j_g, j_d, j_sn) = results
    j_g = dict(workers._paths(j_g))
    j_d = dict(workers._paths(j_d))
    for p in ranks:
        _losses_match(p['losses'], losses)
        n_moved = 0
        for part, want in (('g', j_g), ('d', j_d)):
            for k, v in p[part].items():
                mask = np.abs(p[part + '_grad'][k]) > 1e-6
                if mask.any():
                    d = float(np.abs(v - want[k])[mask].max())
                    assert d <= 1e-2 * LR, (k, d)
                    n_moved += 1
        assert n_moved >= 20, n_moved
        assert float(np.abs(p['u'] - j_sn['scale_0']['conv_0']).max()) \
            <= 1e-5


def test_finetune_over_the_mesh_matches_one_process(results):
    """``finetune(mesh=...)``: both ranks end with the same generator,
    within the bands of one process's run (a step at batch 2, split 1 +
    1), and the checkpoints are written (by rank 0)."""
    s, ranks, ft_dir, _ = results
    r0, r1 = (r['finetune'] for r in ranks)
    assert all(np.array_equal(a, b) for a, b in zip(r0, r1))
    for a, b in zip(r0, s['finetune']):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for name in ('dp', 'single'):
        files = sorted(os.listdir(os.path.join(ft_dir, name)))
        assert 'g_00000001' in files and 'do_00000001' in files, files


def test_non_dividing_global_batch_raises(results):
    for p in results[1]:
        assert p['error'] == (f"global batch {B + 1} does not divide the mesh "
                              "'data' axis (2 shards)")

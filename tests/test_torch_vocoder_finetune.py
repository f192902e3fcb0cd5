"""The port's vocoder GAN fine-tuning (daft_exprt_torch/vocoder_finetune.py)
against the JAX package's, on the tiny generators of
tests/test_vocoder_training.py (ResBlock2 x256 and ResBlock1 x16, 16
initial channels) and full-width MPD + MSD (seeded numpy trees, carried
over by ``bridge.discriminators_from_jax``).

The JAX GAN steps are compiled once for the module (B = 2 x 8192 samples,
float32): the one-iteration test and ``finetune`` (batch 2, its 8192-sample
crops) share them through a memo of ``make_gan_steps``.

Bands: the weight-norm round trip rtol 1e-6; the loss mel max-abs 1e-4;
dataset crops and batch order bit-equal; one float32 iteration's three
losses rel 1e-4, its new spectral state max-abs 1e-5, parameter updates
within 1e-2 * lr where |g| > 1e-6 (a first Adam step is ~lr * sign(g): a
gradient that is 0 in exact arithmetic takes a noise-signed update); a
bf16 iteration's losses rel 2e-2 of the JAX float32 iteration's, its
parameters and optimizer states float32; ``finetune`` end to end: the same
checkpoint names and the returned generator within rel-L2 1e-4."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import daft_exprt_tpu.vocoder_finetune as jv
import daft_exprt_torch.vocoder_finetune as tv
from daft_exprt_tpu.models.hifigan import init_generator_params
from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.frontend.audio import save_wav
from daft_exprt_torch.models import discriminators as td

from tests.torch_port_utils import (
    disc_trees, load_discs, one_torch_thread, rel_l2,
)

CFG_RB2 = {
    'sampling_rate': 22050, 'upsample_rates': [8, 8, 2, 2],
    'upsample_kernel_sizes': [16, 16, 4, 4],
    'upsample_initial_channel': 16, 'resblock': '2',
    'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1, 3]],
    'model_in_dim': 80,
}
CFG_RB1 = {
    'sampling_rate': 22050, 'upsample_rates': [8, 2],
    'upsample_kernel_sizes': [16, 4],
    'upsample_initial_channel': 16, 'resblock': '1',
    'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1, 3]],
    'model_in_dim': 80,
}
LR = 1e-4
B, SEG = 2, jv.SEGMENT_SIZE


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """torch on one thread: beside other test workers, the convs' thread
    pool otherwise waits more than it computes (no check depends on the
    thread count)."""
    with one_torch_thread():
        yield


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _gen_params(cfg, seed):
    """Generator params in the layout of JAX's ``init_generator_params``
    (its shapes, by ``jax.eval_shape``), drawn from seeded numpy: weights
    normal(0, 0.01) like JAX's init, biases normal(0, 0.01), not 0."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: init_generator_params(
        jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map(
        lambda s: (0.01 * rng.randn(*s.shape)).astype(np.float32), shapes)


@pytest.fixture(scope='module')
def jax_steps():
    """make_gan_steps(CFG_RB2, LR) compiled once; later calls with the same
    arguments (finetune's) get the same jitted steps."""
    built = jv.make_gan_steps(CFG_RB2, LR)

    def memo(config=None, lr=2e-4, compute_dtype='float32', mesh=None,
             **kw):
        assert (config, lr, compute_dtype, mesh, kw) == (CFG_RB2, LR,
                                                         'float32', None, {})
        return built
    return built, memo


@pytest.fixture(scope='module')
def iteration(jax_steps):
    """One float32 d_step + g_step on both sides, from the same state."""
    (d_step, g_step, (og, od), loss_mel), _ = jax_steps
    rng = np.random.RandomState(0)
    mpd, msd, sn_state = disc_trees(rng)
    gp = _gen_params(CFG_RB2, 0)
    mel = rng.randn(B, 80, SEG // 256).astype(np.float32)
    y = (0.1 * rng.randn(B, 1, SEG)).astype(np.float32)
    g_wn = jv.generator_to_weight_norm(gp)
    dp = {'mpd': mpd, 'msd': msd}
    y_mel = loss_mel(y[:, 0])
    dp2, _, sn2, d_loss = d_step(dp, od.init(dp), sn_state, g_wn, mel, y)
    g2, _, g_loss, mel_l1 = g_step(g_wn, og.init(g_wn), dp2, sn2, mel, y,
                                   y_mel)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(trees=(mpd, msd, sn_state), gp=gp, mel=mel, y=y,
                jax=dict(d=to_np(dp2), sn=to_np(sn2), g=to_np(g2),
                         losses=(float(d_loss), float(g_loss),
                                 float(mel_l1))))


def _torch_iteration(it, compute_dtype):
    d_step, g_step, (optim_g, optim_d), loss_mel = tv.make_gan_steps(
        CFG_RB2, LR, compute_dtype=compute_dtype, device='cpu')
    t_mpd, t_msd = load_discs(*it['trees'])
    g_wn = tv.generator_to_weight_norm(generator_from_jax(it['gp']))
    g_opt, d_opt = optim_g(g_wn), optim_d(t_mpd, t_msd)
    mel, y = torch.from_numpy(it['mel']), torch.from_numpy(it['y'])
    with torch.no_grad():
        y_mel = loss_mel(y[:, 0])
    d_loss = d_step(t_mpd, t_msd, d_opt, g_wn, mel, y)
    g_loss, mel_l1 = g_step(g_wn, g_opt, t_mpd, t_msd, mel, y, y_mel)
    return dict(modules=(t_mpd, t_msd), g_wn=g_wn, opts=(g_opt, d_opt),
                losses=(float(d_loss), float(g_loss), float(mel_l1)))


@pytest.mark.parametrize('cfg', [CFG_RB2, CFG_RB1], ids=['rb2', 'rb1'])
def test_weight_norm_round_trip(cfg):
    gp = _gen_params(cfg, 1)
    j_wn = dict(_flat(jax.tree_util.tree_map(
        np.asarray, jv.generator_to_weight_norm(gp))))
    t_wn = tv.generator_to_weight_norm(generator_from_jax(gp))
    t_flat = dict(_flat(t_wn))
    assert set(t_flat) == set(j_wn)
    for path, v in t_flat.items():
        np.testing.assert_allclose(v.numpy(), j_wn[path], rtol=1e-6,
                                   atol=0)
    # ups_* kernels are (in, out, k): normed over (out, k)
    assert t_wn['ups_0']['g'].shape == (cfg['upsample_initial_channel'], 1,
                                        1)
    back = dict(_flat(tv.generator_from_weight_norm(t_wn)))
    for path, w in _flat(gp):
        np.testing.assert_allclose(back[path].numpy(), w, rtol=1e-6,
                                   atol=1e-9)


def test_loss_mel_fn():
    rng = np.random.RandomState(2)
    wav = (0.3 * rng.randn(B, SEG)).astype(np.float32)
    ref = np.asarray(jv.make_loss_mel_fn()(wav))
    out = tv.make_loss_mel_fn(device='cpu')(torch.from_numpy(wav))
    assert out.shape == ref.shape == (B, 80, SEG // 256)
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-4


def _write_pairs(root, lengths, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, T in enumerate(lengths):
        np.save(os.path.join(root, f'utt_{i}.npy'),
                (rng.randn(80, T) - 4.0).astype(np.float32))
        save_wav(os.path.join(root, f'utt_{i}.wav'),
                 (0.1 * rng.randn(T * 256)).astype(np.float32), 22050)
    # a stray mel without its wav is not a pair
    np.save(os.path.join(root, 'orphan.npy'), np.zeros((80, 4), np.float32))


def test_dataset_crops_and_batches(tmp_path):
    _write_pairs(str(tmp_path), (50, 20, 77, 32, 90), seed=3)
    assert tv.find_pairs(str(tmp_path)) == jv.find_pairs(str(tmp_path)) == \
        [f'utt_{i}' for i in range(5)]
    j_ds = jv.HiFiGANFinetuneDataset(str(tmp_path), seed=7)
    t_ds = tv.HiFiGANFinetuneDataset(str(tmp_path), seed=7)
    n = 0
    for _epoch in range(3):
        for (jm, jw, jn), (tm, tw, tn) in zip(j_ds.batches(2),
                                              t_ds.batches(2)):
            assert jn == tn
            np.testing.assert_array_equal(jm, tm)
            np.testing.assert_array_equal(jw, tw)
            assert tm.shape == (2, 80, 32) and tw.shape == (2, SEG)
            n += 1
    assert n == 6
    whole = tv.HiFiGANFinetuneDataset(str(tmp_path), split=False)
    assert whole[2][0].shape == (80, 77) and whole[2][1].shape == (77 * 256,)
    with pytest.raises(ValueError, match='no \\(npy, wav\\) pairs'):
        tv.HiFiGANFinetuneDataset(str(tmp_path), names=[])


def _updates_match(p_new, j_new, p_old, grad, what):
    """Where |g| > 1e-6, the parameter within 1e-2 * lr of JAX's; returns
    whether the leaf has such an element."""
    mask = np.abs(grad) > 1e-6
    if not mask.any():
        return False
    d = np.abs(p_new - j_new)[mask]
    assert float(d.max()) <= 1e-2 * LR, (what, float(d.max()))
    # and the step moved them
    assert float(np.abs(p_new - p_old)[mask].max()) > 0.1 * LR, what
    return True


def test_one_float32_iteration(iteration):
    it = iteration
    out = _torch_iteration(it, 'float32')
    for a, b in zip(out['losses'], it['jax']['losses']):
        assert abs(a - b) <= 1e-4 * abs(b), (out['losses'],
                                              it['jax']['losses'])
    t_mpd, t_msd = out['modules']
    for name, u in t_msd.sn_state()['scale_0'].items():
        assert float(np.abs(u.numpy() - it['jax']['sn']['scale_0'][name])
                     .max()) <= 1e-5, name
        assert not np.allclose(u.numpy(), it['trees'][2]['scale_0'][name])
    j_d = dict(_flat(it['jax']['d']))
    mpd0, msd0, _ = it['trees']
    old = dict(_flat({'mpd': mpd0, 'msd': msd0}))
    n_d = n_g = 0
    for root, module in (('mpd', t_mpd), ('msd', t_msd)):
        for name, p in module.named_parameters():
            key = (root,) + tuple(name.split('.'))
            n_d += _updates_match(p.detach().numpy(), j_d[key], old[key],
                                  p.grad.numpy(), name)
    j_g = dict(_flat(it['jax']['g']))
    g_old = dict(_flat(jv.generator_to_weight_norm(it['gp'])))
    for key, p in _flat(out['g_wn']):
        n_g += _updates_match(p.detach().numpy(), j_g[key],
                              np.asarray(g_old[key]), p.grad.numpy(), key)
    # leaves compared: every discriminator leaf, 15 of the generator's 42
    # (the others have no gradient above 1e-6 at this init)
    assert n_d == 154 and n_g >= 10, (n_d, n_g, len(g_old))


def test_one_bf16_iteration(iteration):
    it = iteration
    out = _torch_iteration(it, 'bfloat16')
    for a, b in zip(out['losses'], it['jax']['losses']):
        assert np.isfinite(a) and abs(a - b) <= 2e-2 * abs(b), (
            out['losses'], it['jax']['losses'])
    t_mpd, t_msd = out['modules']
    tensors = [p for _, p in _flat(out['g_wn'])] + \
        list(t_mpd.parameters()) + list(t_msd.parameters()) + \
        list(t_msd.buffers())
    for opt in out['opts']:
        for st in opt.state.values():
            tensors += [v for k, v in st.items() if k != 'step']
    assert len(tensors) > 400
    assert all(t.dtype == torch.float32 for t in tensors)
    u = t_msd.sn_state()['scale_0']['conv_0'].numpy()
    assert not np.allclose(u, it['trees'][2]['scale_0']['conv_0'])


def test_finetune_end_to_end(tmp_path, jax_steps, monkeypatch):
    """finetune() on a tiny corpus: 3 pairs, 'utt_0' held out, batch 2,
    2 steps, a validation and a checkpoint at the end; without a TensorBoard
    writer on either side, as on a host without tensorboard (tensorboardX's
    audio summaries need soundfile, which is not a dependency here)."""
    _, memo = jax_steps
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    data = str(tmp_path / 'pairs')
    _write_pairs(data, (40, 45, 36), seed=4)
    rng = np.random.RandomState(5)
    trees = disc_trees(rng)
    gp = _gen_params(CFG_RB2, 2)
    monkeypatch.setattr(jv, 'make_gan_steps', memo)
    monkeypatch.setattr(jv, 'init_mpd_params', lambda key: trees[0])
    monkeypatch.setattr(jv, 'init_msd_params', lambda key: trees[1:])
    kw = dict(config=CFG_RB2, training_steps=2, batch_size=2, lr=LR,
              checkpoint_interval=2, log_interval=1, val_names=['utt_0'])
    j_out = jax.tree_util.tree_map(np.asarray, jv.finetune(
        data, str(tmp_path / 'jax'), gp, **kw))

    discs = load_discs(*trees)
    monkeypatch.setattr(tv, 'init_mpd_params', lambda seed, device: discs[0])
    monkeypatch.setattr(tv, 'init_msd_params', lambda seed, device: discs[1])
    t_out = tv.finetune(data, str(tmp_path / 'torch'),
                        generator_from_jax(gp), device='cpu', **kw)

    def names(d):
        return sorted(x for x in os.listdir(d) if x.startswith(('g_', 'do_')))
    assert names(tmp_path / 'torch') == names(tmp_path / 'jax') == [
        'do_00000002', 'do_00000002.json', 'g_00000002', 'g_00000002.json']
    j_flat = dict(_flat(j_out))
    t_flat = dict(_flat(t_out))
    assert set(t_flat) == set(j_flat)
    for key, v in t_flat.items():
        assert rel_l2(v, j_flat[key]) <= 1e-4, (key, rel_l2(v, j_flat[key]))
    # the checkpoints reload: the generator as returned, the discriminators
    # into the port's modules
    monkeypatch.undo()
    payload, meta = tv.ckpt.load_checkpoint(str(tmp_path / 'torch' /
                                                 'g_00000002'))
    assert meta['iteration'] == 2
    for key, v in _flat(payload['model']['generator']):
        assert torch.equal(v, t_flat[key])
    mpd, msd = tv.load_discriminators(str(tmp_path / 'torch' /
                                          'do_00000002'), device='cpu')
    assert torch.equal(msd.scale_0.conv_0.u, discs[1].scale_0.conv_0.u)
    assert torch.equal(mpd.period_3.conv_2.v, discs[0].period_3.conv_2.v)

"""The port's MPD, MSD and GAN losses (daft_exprt_torch/models/
discriminators.py) against the JAX package's, on the same full-width
discriminators (seeded numpy trees in the JAX layout, carried over by
``bridge.discriminators_from_jax``) and the same inputs, B = 2 x 4096
samples (4096 is no multiple of 3, 5, 7 or 11: every period but 2
reflect-pads; the MSD pools twice).

Bands: scores and every feature map rel-L2 <= 1e-5, the new power-
iteration state max-abs <= 1e-6, the three losses rel <= 1e-5, the D
loss's gradient on every g, v, w and b rel-L2 <= 1e-4 leaf by leaf (a
detached power iteration fails it; both packages in float64 at B = 2 x
512, see the test), bf16 compute's losses rel <= 2e-2 (about 1e-5
measured)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daft_exprt_tpu.models.discriminators as jd
import daft_exprt_torch.models.discriminators as td
from daft_exprt_torch.bridge import discriminators_from_jax

from tests.torch_port_utils import (
    disc_trees, load_discs, one_torch_thread, rel_l2,
)

B, T = 2, 4096


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


def _jax_d(d_params, sn_state, y, y_hat, dtype=None, grad=True):
    """Everything the comparisons read, from one jitted value_and_grad
    (``grad=False``: the forward only, as (value, aux))."""
    def loss_fn(dp):
        f_r, f_g, fm_f_r, fm_f_g = jd.mpd_forward(dp['mpd'], y, y_hat,
                                                  dtype=dtype)
        s_r, s_g, fm_s_r, fm_s_g, new_sn = jd.msd_forward(
            dp['msd'], sn_state, y, y_hat, update_sn=True, dtype=dtype)
        d_loss = jd.discriminator_loss(f_r, f_g)[0] \
            + jd.discriminator_loss(s_r, s_g)[0]
        aux = dict(scores=(f_r, f_g, s_r, s_g),
                   fmaps=(fm_f_r, fm_f_g, fm_s_r, fm_s_g), sn=new_sn,
                   g_loss=jd.generator_loss(f_g + s_g)[0],
                   fm_loss=jd.feature_loss(fm_f_r + fm_s_r, fm_f_g + fm_s_g))
        return d_loss, aux
    if not grad:
        return jax.jit(loss_fn)(d_params)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(d_params)


def _torch_d(mpd, msd, y, y_hat, dtype=None):
    f_r, f_g, fm_f_r, fm_f_g = mpd(y, y_hat, dtype=dtype)
    s_r, s_g, fm_s_r, fm_s_g, new_sn = msd(y, y_hat, update_sn=True,
                                           dtype=dtype)
    d_loss = td.discriminator_loss(f_r, f_g)[0] \
        + td.discriminator_loss(s_r, s_g)[0]
    return d_loss, dict(scores=(f_r, f_g, s_r, s_g),
                        fmaps=(fm_f_r, fm_f_g, fm_s_r, fm_s_g), sn=new_sn,
                        g_loss=td.generator_loss(f_g + s_g)[0],
                        fm_loss=td.feature_loss(fm_f_r + fm_s_r,
                                                fm_f_g + fm_s_g))


@pytest.fixture(scope='module')
def case():
    rng = np.random.RandomState(0)
    mpd, msd, sn_state = disc_trees(rng)
    y = (0.3 * rng.randn(B, 1, T)).astype(np.float32)
    y_hat = (0.3 * rng.randn(B, 1, T)).astype(np.float32)
    j_loss, j_aux = _jax_d({'mpd': mpd, 'msd': msd}, sn_state, y, y_hat,
                           grad=False)
    t_mpd, t_msd = load_discs(mpd, msd, sn_state)
    with torch.no_grad():
        t_loss, t_aux = _torch_d(t_mpd, t_msd, torch.from_numpy(y),
                                 torch.from_numpy(y_hat))
    return dict(trees=(mpd, msd, sn_state), y=y, y_hat=y_hat,
                jax=(j_loss, j_aux), torch=(t_loss, t_aux),
                modules=(t_mpd, t_msd))


def test_scores_and_feature_maps(case):
    _, j_aux = case['jax']
    _, t_aux = case['torch']
    n = 0
    for j_list, t_list in zip(j_aux['scores'], t_aux['scores']):
        assert len(j_list) == len(t_list)
        for a, b in zip(t_list, j_list):
            assert a.shape == b.shape
            assert rel_l2(a.detach(), b) <= 1e-5
            n += 1
    for j_sub, t_sub in zip(j_aux['fmaps'], t_aux['fmaps']):
        for j_maps, t_maps in zip(j_sub, t_sub):
            assert len(j_maps) == len(t_maps)
            for a, b in zip(t_maps, j_maps):
                assert a.shape == b.shape
                assert rel_l2(a.detach(), b) <= 1e-5
                n += 1
    # 5 periods + 3 scales, real and generated; 6 + 8 fmaps a pass
    assert n == 2 * 8 + 2 * (5 * 6 + 3 * 8)


def test_power_iteration_state(case):
    _, j_aux = case['jax']
    _, t_aux = case['torch']
    _, _, sn_state = case['trees']
    assert set(t_aux['sn']) == {'scale_0'}
    for name, u in t_aux['sn']['scale_0'].items():
        np.testing.assert_allclose(u.detach().numpy(),
                                   np.asarray(j_aux['sn']['scale_0'][name]),
                                   rtol=0, atol=1e-6)
        assert not np.allclose(u.detach().numpy(),
                               sn_state['scale_0'][name])
    # the forward does not write the buffers: the step does, after backward
    t_msd = case['modules'][1]
    for name, u in t_msd.sn_state()['scale_0'].items():
        np.testing.assert_array_equal(u.numpy(), sn_state['scale_0'][name])


def test_losses(case):
    j_loss, j_aux = case['jax']
    t_loss, t_aux = case['torch']
    for a, b in ((t_loss, j_loss), (t_aux['g_loss'], j_aux['g_loss']),
                 (t_aux['fm_loss'], j_aux['fm_loss'])):
        assert a.dtype == torch.float32
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


def _grad_check(t_modules, j_grads):
    """Every leaf's gradient within rel-L2 1e-4 of JAX's; returns the
    number of leaves."""
    j_flat = dict(_flat(j_grads))
    n = 0
    for root, module in zip(('mpd', 'msd'), t_modules):
        for name, p in module.named_parameters():
            path = (root,) + tuple(name.split('.'))
            g = j_flat[path]
            assert p.grad is not None and p.grad.shape == g.shape, name
            assert rel_l2(p.grad, g) <= 1e-4, (name, rel_l2(p.grad, g))
            n += 1
    assert n == len(j_flat) == 5 * 6 * 3 + 8 * 2 + 2 * 8 * 3
    return n


def test_d_loss_gradients_leaf_by_leaf():
    """The spectral norm's power iteration is differentiated as in JAX (v,
    u_new and sigma are functions of w): the D loss's gradient on every
    leaf within rel-L2 1e-4 of JAX's (about 1e-14 measured), both packages
    in float64 at B = 2 x 512 (every period reflect-pads). In float32 the
    two would not be comparable at that band on every input: where a
    value lands within rounding of an lrelu's kink, the two float32
    forwards can take opposite slopes (on the forward test's inputs, one
    value at period 7's last conv does), and every gradient below it moves
    by up to 1e-2."""
    rng = np.random.RandomState(1)
    mpd, msd, sn_state = disc_trees(rng)
    y = 0.3 * rng.randn(B, 1, 512)
    y_hat = 0.3 * rng.randn(B, 1, 512)
    with jax.enable_x64(True):
        def f64(t):
            return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                          t)
        _, j_grads = _jax_d({'mpd': f64(mpd), 'msd': f64(msd)}, f64(sn_state),
                            y, y_hat)
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    t_mpd, t_msd = load_discs(mpd, msd, sn_state)
    t_mpd.double()
    t_msd.double()
    t_loss, _ = _torch_d(t_mpd, t_msd, torch.from_numpy(y),
                         torch.from_numpy(y_hat))
    t_loss.backward()
    assert t_mpd.period_7.conv_4.v.grad.dtype == torch.float64
    assert _grad_check((t_mpd, t_msd), j_grads) == 154


def test_detached_power_iteration_changes_the_gradient(case):
    """The check above can fail: with u, v and sigma detached (as
    torch.nn.utils.spectral_norm computes them) the gradient on scale_0's
    w leaves the band."""
    t_mpd, t_msd = case['modules']
    sub = t_msd.scale_0
    w = sub.conv_6.w
    u = t_msd.sn_state()['scale_0']['conv_6']
    g_full = torch.autograd.grad(td.sn_weight(w, u, True)[0].pow(3).sum(), w)
    with torch.no_grad():
        w_sn, _ = td.sn_weight(w, u, True)
        sigma = (w / w_sn).flatten()[0]
    g_det = torch.autograd.grad((w / sigma).pow(3).sum(), w)
    assert rel_l2(g_det[0], g_full[0]) > 1e-3


def test_bf16_losses(case):
    mpd, msd, sn_state = case['trees']
    y, y_hat = case['y'], case['y_hat']
    j_loss, j_aux = _jax_d({'mpd': mpd, 'msd': msd}, sn_state, y, y_hat,
                           dtype=jnp.bfloat16, grad=False)
    t_mpd, t_msd = case['modules']
    with torch.no_grad():
        t_loss, t_aux = _torch_d(t_mpd, t_msd, torch.from_numpy(y),
                                 torch.from_numpy(y_hat),
                                 dtype=torch.bfloat16)
    assert t_aux['scores'][0][0].dtype == torch.bfloat16
    for a, b in ((t_loss, j_loss), (t_aux['g_loss'], j_aux['g_loss']),
                 (t_aux['fm_loss'], j_aux['fm_loss'])):
        assert a.dtype == torch.float32
        assert abs(float(a) - float(b)) <= 2e-2 * abs(float(b)), (a, b)
    # the power iteration stays float32
    for u in t_aux['sn']['scale_0'].values():
        assert u.dtype == torch.float32


def test_bridge_and_init_layout(case):
    mpd, msd, sn_state = case['trees']
    state = discriminators_from_jax(mpd, msd, sn_state)
    t_mpd = td.init_mpd_params(seed=3, device='cpu')
    t_msd = td.init_msd_params(seed=3, device='cpu')
    for module, st in ((t_mpd, state['mpd']), (t_msd, state['msd'])):
        own = module.state_dict()
        assert set(own) == set(st)
        assert all(own[k].shape == st[k].shape and
                   own[k].dtype == torch.float32 for k in own)
    # torch's conv init bounds, g the norm of v
    v = t_mpd.period_2.conv_3.v.detach()
    assert float(v.abs().max()) <= (3.0 / (512 * 5)) ** 0.5
    np.testing.assert_allclose(
        t_mpd.period_2.conv_3.g.detach().flatten().numpy(),
        v.flatten(1).norm(dim=1).numpy(), rtol=1e-6)
    again = td.init_msd_params(seed=3, device='cpu').state_dict()
    assert all(torch.equal(again[k], t_msd.state_dict()[k]) for k in again)
    bad = {'period_2': {'conv_0': {'kernel': np.zeros(1)}}}
    with pytest.raises(KeyError, match='no mapping'):
        discriminators_from_jax(bad, msd, sn_state)
    with pytest.raises(KeyError, match='spectral-norm conv'):
        discriminators_from_jax(mpd, msd, {'scale_1': {'conv_0': np.zeros(
            128, np.float32)}})

"""The port's training step (daft_exprt_torch/parallel/train_step.py)
against the JAX package's (``mesh=None``, ``donate=False``) on the same
parameters and batch, every dropout rate at 0, all five loss terms on (a
random frozen pitch predictor), at a small width (1 block, width 32, 2
heads of 16, 20 mel channels). The JAX model runs its Pallas attention in
interpret mode and the port's runs ``fused_attention`` (its plain pair on
the CPU), so both custom backwards are in the loop.

Bands: loss, each term and the global grad norm relative 1e-5; each
parameter's gradient max-abs 1e-4 of the leaf's largest gradient (float32
sums in another order; measured 2.6e-6). Parameters after the update: the
first Adam update is lr * g / (|g| + eps), close to lr * sign(g), so where
|g| sits at the noise floor (<= 1e-6, e.g. the key bias, whose exact
gradient is 0) the sign is noise and the two sides may differ by up to 2
lr per step; elsewhere they agree within 1e-3 lr.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _make_batch
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.loss import (
    compute_loss as jax_compute_loss, loss_cfg_from_hparams as jax_loss_cfg,
)
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.models.pitch_predictor import (
    PitchPredictor as JaxPitchPredictor,
)
from daft_exprt_tpu.parallel import train_step as jts
from daft_exprt_torch.bridge import (
    acoustic_state_from_jax, pitch_predictor_from_jax,
)
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.loss import loss_cfg_from_hparams
from daft_exprt_torch.models.daft_exprt import DaftExprt
from daft_exprt_torch.models.modules import MultiHeadSelfAttention
from daft_exprt_torch.models.pitch_predictor import PitchPredictor
from daft_exprt_torch.parallel import train_step as pts

N_MEL = 20
ITERATIONS = (5000.0, 5001.0)      # inside the adversarial warmup


def _cfg(dropout):
    return {'nb_blocks': 1, 'hidden_embed_dim': 32, 'attn_nb_heads': 2,
            'attn_dropout': dropout, 'conv_kernel': 3, 'conv_channels': 64,
            'conv_dropout': dropout}


def _hp_kw(dropout=0.0, accumulation_steps=1):
    return dict(verbose=False, training_files='unused',
                validation_files='unused', output_directory='/nonexistent',
                language='english', speakers=['a', 'b'],
                phoneme_encoder=_cfg(dropout), accent_encoder=_cfg(dropout),
                frame_decoder=_cfg(dropout), fused_attention=True,
                compute_dtype='float32', n_mel_channels=N_MEL,
                accumulation_steps=accumulation_steps)


@pytest.fixture(scope='module')
def setup():
    """JAX model, params (init plus seeded noise), frozen pitch predictor
    variables and a ragged batch of 4 with its raw frame prosody; the JAX
    Pallas attention in interpret mode while the module's tests run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DAFT_FUSED_ATTN_INTERPRET', '1')
        yield _setup()


def _setup():
    hp = JaxHParams(**_hp_kw())
    model = JaxDaftExprt.from_hparams(hp)
    b = _make_batch(hp, 4, 16, 64, seed=3)
    b.update(output_lengths=np.array([64, 40, 57, 33]),
             input_lengths=np.array([16, 10, 14, 7]),
             speaker_ids=np.array([0, 1, 2, 1]))
    rng = np.random.RandomState(7)
    params = model.init({'params': jax.random.PRNGKey(0),
                         'dropout': jax.random.PRNGKey(1)},
                        **{k: v[:1] for k, v in b.items()})['params']
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    jpp = JaxPitchPredictor(n_mel_channels=N_MEL)
    ppv = jpp.init(jax.random.PRNGKey(3), np.zeros((1, N_MEL, 8), np.float32))
    ppv = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), ppv)
    ppv['batch_stats'] = jax.tree_util.tree_map(lambda p: np.abs(p) + 0.5,
                                                ppv['batch_stats'])
    raw = {'frames_energy': (np.abs(b['frames_energy']) * 3).astype(
        np.float32),
           'frames_pitch': np.where(b['frames_pitch'] > 0,
                                    b['frames_pitch'] + 5, 0).astype(
               np.float32)}
    jax_pp = (lambda v, mel: jpp.apply(v, mel, deterministic=True,
                                       use_running_average=True), ppv)
    return hp, model, params, jax_pp, b, raw


def _port(params, ppv, **kw):
    hp = HyperParams(**_hp_kw(**kw))
    model = DaftExprt.from_hparams(hp, device='cpu').load_bridged(
        acoustic_state_from_jax(params))
    pp = PitchPredictor(N_MEL)
    pp.load_state_dict(pitch_predictor_from_jax(ppv['params'],
                                                ppv['batch_stats']))
    opt = pts.make_optimizer(model, hp)
    step = pts.make_train_step(model, opt, loss_cfg_from_hparams(hp),
                               pp.frozen(), hp.accumulation_steps)
    return model, opt, step


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_learning_rate_fn_matches_jax():
    hp_j = JaxHParams(**_hp_kw())
    hp_t = HyperParams(**_hp_kw())
    j, t = jts.make_learning_rate_fn(hp_j), pts.make_learning_rate_fn(hp_t)
    for it in (0, 1, 17, 5000, 9999, 10000, 10001, 123456, 370000):
        assert t(it) == pytest.approx(float(j(np.float32(it))), rel=1e-6)


def test_optimizer_update_count_sets_the_learning_rate(setup):
    """The n-th update (n from 0) takes lr_fn(n), whatever the iteration;
    the count survives a state-dict round trip."""
    _, _, params, (_, ppv), b, raw = setup
    model, opt, step = _port(params, ppv)
    lrs = []
    for it in (7000.0, 9.0):
        step(_torch(b), _torch(raw), it, 0)
        lrs.append(opt.param_groups[0]['lr'])
    assert lrs == [opt.lr_fn(0), opt.lr_fn(1)] and opt.updates == 2
    _, opt2, _ = _port(params, ppv)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.updates == 2


@pytest.mark.parametrize('accumulation_steps,n_steps', [(1, 2), (2, 1)])
def test_train_step_matches_jax(setup, accumulation_steps, n_steps):
    hp, jmodel, params, jax_pp, b, raw = setup
    hp.accumulation_steps = accumulation_steps
    tx = jts.make_optimizer(hp)
    jstep = jts.make_train_step(jmodel, tx, jax_loss_cfg(hp), jax_pp,
                                mesh=None,
                                accumulation_steps=accumulation_steps,
                                donate=False)
    model, opt, tstep = _port(params, jax_pp[1],
                              accumulation_steps=accumulation_steps)

    def loss_fn(p):
        out = jmodel.apply({'params': p}, deterministic=True,
                           **{k: b[k] for k in jts.MODEL_INPUT_KEYS})
        targets = {'mel_specs': b['mel_specs'],
                   'output_lengths': b['output_lengths'],
                   'speaker_ids': b['speaker_ids'],
                   'frames_energy_raw': raw['frames_energy'],
                   'frames_pitch_raw': raw['frames_pitch']}
        return jax_compute_loss(out, targets, jnp.float32(ITERATIONS[0]),
                                jax_loss_cfg(hp), jax_pp)[0]
    grads0 = acoustic_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_fn)(params)))
    noise = {k: g.abs() <= 1e-6 for k, g in grads0.items()}

    jparams, opt_state = params, tx.init(params)
    lr_sum = 0.0
    for n, it in enumerate(ITERATIONS[:n_steps]):
        jparams, opt_state, jm = jstep(jparams, opt_state, b, raw,
                                       np.float32(it), jax.random.PRNGKey(0))
        tm = tstep(_torch(b), _torch(raw), it, 0)
        assert set(tm) == set(jm)
        for k, v in jm.items():
            assert abs(float(tm[k]) - float(v)) <= 1e-5 * abs(float(v)) \
                + 1e-9, k
        if n == 0 and accumulation_steps == 1:
            for k, p in model.named_parameters():
                assert float((p.grad - grads0[k]).abs().max()) <= \
                    1e-4 * float(grads0[k].abs().max()) + 1e-12, k
        lr_sum += opt.lr_fn(n)
        ref = acoustic_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
        for k, p in model.named_parameters():
            d = (p.detach() - ref[k]).abs()
            assert float(torch.where(noise[k], 0.0, d).max()) <= \
                1e-3 * lr_sum, k
            assert float(d.max()) <= 2 * lr_sum + 1e-7, k


def test_fused_and_plain_routes_agree_with_dropout(setup):
    """Dropout 0.1 everywhere: the step through fused_attention (its plain
    pair on the CPU) and the step through the plain attention under
    autograd, from the same params and seed, draw the same masks (the
    attention mask is Philox of the drawn seed; the other masks come from
    the same generator in the same order) and agree; another seed does
    not. Gradients agree within 1e-4 of each leaf's largest, parameters
    within 1e-3 lr where the gradient is above the noise floor (the
    module's docstring)."""
    _, _, params, (_, ppv), b, raw = setup
    results = []
    for fused, seed in ((True, 0), (False, 0), (True, 1)):
        model, opt, step = _port(params, ppv, dropout=0.1)
        for m in model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.fused = fused
        metrics = step(_torch(b), _torch(raw), ITERATIONS[0], seed)
        results.append((metrics, {k: (p.detach().clone(), p.grad.clone())
                                  for k, p in model.named_parameters()}))
    (m_f, p_f), (m_p, p_p), (m_o, _) = results
    for k in m_f:
        assert float(m_f[k]) == pytest.approx(float(m_p[k]), rel=1e-5,
                                              abs=1e-9), k
    assert abs(float(m_f['loss']) - float(m_o['loss'])) > 1e-4
    lr = opt.lr_fn(0)
    for k, (p, g) in p_f.items():
        p2, g2 = p_p[k]
        assert float((g - g2).abs().max()) <= \
            1e-4 * float(g2.abs().max()) + 1e-12, k
        d = torch.where(g2.abs() <= 1e-6, 0.0, (p - p2).abs())
        assert float(d.max()) <= 1e-3 * lr, k

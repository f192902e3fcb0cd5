"""The port's composite loss and frozen pitch predictor against the JAX
package on the same numpy inputs and bridged parameters (JAX's init plus
seeded noise, BatchNorm statistics included).

Bands: each loss term relative 1e-5 (float32 sums in another order; the
parity band of PARITY.md is 2e-3 per term); the pitch predictor max-abs
1e-5 of its output's scale.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_exprt_tpu.loss import (
    adversarial_weight as jax_adversarial_weight,
    compute_loss as jax_compute_loss,
)
from daft_exprt_tpu.models.pitch_predictor import (
    PitchPredictor as JaxPitchPredictor,
)
from daft_exprt_torch.bridge import pitch_predictor_from_jax
from daft_exprt_torch.loss import adversarial_weight, compute_loss
from daft_exprt_torch.models.pitch_predictor import PitchPredictor

N_MEL = 20
CFG = {'warmup_steps': 10000.0, 'adv_max_weight': 1e-2,
       'post_mult_weight': 1e-3, 'mel_spec_weight': 1.0,
       'energy_consistency_weight': 0.05, 'pitch_consistency_weight': 0.15,
       'n_mel_channels': float(N_MEL)}


def _pitch_predictors(seed=3):
    """A JAX predictor (init plus noise, positive variances) and the port's
    on the same variables."""
    jpp = JaxPitchPredictor(n_mel_channels=N_MEL)
    variables = jpp.init(jax.random.PRNGKey(seed),
                         np.zeros((1, N_MEL, 8), np.float32))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), variables)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda p: np.abs(p) + 0.5, variables['batch_stats'])

    def apply_fn(v, mel):
        return jpp.apply(v, mel, deterministic=True,
                         use_running_average=True)
    tpp = PitchPredictor(N_MEL)
    tpp.load_state_dict(pitch_predictor_from_jax(variables['params'],
                                                 variables['batch_stats']))
    return (apply_fn, variables), tpp.frozen()


def test_pitch_predictor_matches_jax():
    (apply_fn, variables), tpp = _pitch_predictors()
    mel = np.random.RandomState(0).randn(3, N_MEL, 50).astype(np.float32)
    ref = np.asarray(apply_fn(variables, mel))
    got = tpp(torch.from_numpy(mel))
    assert got.shape == ref.shape == (3, 50)
    assert float(np.abs(got.detach().numpy() - ref).max()) <= \
        1e-5 * np.abs(ref).max()
    assert not any(p.requires_grad for p in tpp.parameters())
    assert set(tpp.state_dict()) >= {'bn_0.running_mean', 'bn_2.running_var'}


def _inputs(seed=0, B=4, T=40, n_spk=3):
    rng = np.random.RandomState(seed)
    out_len = np.array([T, 31, 17, 9][:B])
    mask = np.arange(T)[None] < out_len[:, None]
    outputs = {
        'mel_preds': np.where(mask[:, None], rng.randn(B, N_MEL, T) * 0.5,
                              0).astype(np.float32),
        'speaker_preds': rng.randn(B, n_spk).astype(np.float32),
        'post_multipliers': rng.randn(2, 4).astype(np.float32),
    }
    pitch = np.where(rng.rand(B, T) < 0.7, 5.0 + rng.randn(B, T) * 0.2, 0.0)
    targets = {
        'mel_specs': np.where(mask[:, None], rng.randn(B, N_MEL, T) * 0.5,
                              0).astype(np.float32),
        'output_lengths': out_len,
        'speaker_ids': np.array([0, 2, 1, 2][:B]),
        'frames_energy_raw': np.abs(rng.randn(B, T)).astype(np.float32),
        'frames_pitch_raw': np.where(mask, pitch, 0).astype(np.float32),
    }
    return outputs, targets


@pytest.mark.parametrize('iteration', [0, 2500, 20000])
def test_compute_loss_matches_jax(iteration):
    """Every term, energy and pitch consistency on, before, during and
    after the adversarial warmup."""
    jpp, tpp = _pitch_predictors()
    outputs, targets = _inputs(seed=iteration)
    j_loss, j_terms = jax_compute_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in targets.items()},
        jnp.float32(iteration), CFG, jpp)
    t_loss, t_terms = compute_loss(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()},
        iteration, CFG, tpp)
    assert set(t_terms) == set(j_terms)
    for name, got, ref in [('loss', t_loss, j_loss)] + [
            (k, t_terms[k], j_terms[k]) for k in j_terms]:
        ref = float(ref)
        assert abs(float(got) - ref) <= 1e-5 * abs(ref) + 1e-9, name
    assert float(t_terms['pitch_consistency_loss']) > 0
    assert float(t_terms['energy_consistency_loss']) > 0
    assert (float(t_terms['speaker_loss']) > 0) == (iteration > 0)
    assert adversarial_weight(iteration, 1e4, 1e-2) == pytest.approx(
        float(jax_adversarial_weight(jnp.float32(iteration), 1e4, 1e-2)),
        rel=1e-6)

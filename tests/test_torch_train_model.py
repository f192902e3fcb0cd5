"""The port's training-side model pieces against the JAX package, at a
small width (2 blocks, width 32, 2 heads of 16, conv_channels 64) on
ragged batches, with JAX's init plus seeded numpy noise on every leaf
carried by the bridge: gradient reversal, the factored backward of
``_normalize_weights``, ``AccentEncoder``, ``SpeakerClassifier``,
``encode_accent`` and the whole training forward (deterministic: dropout
off).

Bands, as tests/test_torch_acoustic.py uses for inference: float32 mel
max-abs 1e-3, alignments 1e-5, the other outputs 1e-4 (float32 sums in
another order); bf16 compute rel-L2 2e-2 (bf16 rounds at other points in
the two frameworks).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _make_batch
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.models.daft_exprt import (
    DaftExprt as JaxDaftExprt, _normalize_weights as jax_normalize_weights,
)
from daft_exprt_tpu.ops.grl import gradient_reversal as jax_grl
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.models.daft_exprt import DaftExprt, _normalize_weights
from daft_exprt_torch.ops.grl import gradient_reversal

from tests.torch_port_utils import max_abs, rel_l2

SMALL = {'nb_blocks': 2, 'hidden_embed_dim': 32, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 64,
         'conv_dropout': 0.1}
HP_KW = dict(verbose=False, training_files='unused',
             validation_files='unused', output_directory='/nonexistent',
             language='english', speakers=['a', 'b', 'c'],
             phoneme_encoder=dict(SMALL), accent_encoder=dict(SMALL),
             frame_decoder=dict(SMALL), fused_attention=False)


def test_gradient_reversal_matches_jax():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    g = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jax_grl(a, 0.7), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = gradient_reversal(t, 0.7)
    assert torch.equal(out.detach(), torch.from_numpy(np.asarray(y)))
    out.backward(torch.from_numpy(g))
    assert torch.equal(t.grad, torch.from_numpy(np.asarray(vjp(g)[0])))
    assert torch.equal(t.grad, -0.7 * torch.from_numpy(g))


def test_normalize_weights_backward_at_massless_frames():
    """Frames where no gaussian has mass (S = 0, or S underflowing): the
    port's backward is finite and equals the JAX custom VJP. JAX's own
    autodiff of the division is not finite there (it forms
    (S + 1e-20)**-2 = inf): the reason for the custom backward. PyTorch's
    autograd of the same division forms ((x / y) / y) and stays finite on
    these inputs; the port keeps the JAX formula all the same."""
    probs = np.random.RandomState(0).rand(2, 5, 7).astype(np.float32)
    probs[:, :, -1] = 0.0
    probs[:, :, -2] = 1e-30
    g = np.random.RandomState(1).randn(2, 5, 7).astype(np.float32)
    y_j, vjp = jax.vjp(jax_normalize_weights, jnp.asarray(probs))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(probs).requires_grad_()
    y = _normalize_weights(t)
    y.backward(torch.from_numpy(g))
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-5, atol=0)

    def plain(p):
        return p / (jnp.sum(p, axis=1, keepdims=True) + 1e-20)
    jax_plain = np.asarray(jax.vjp(plain, jnp.asarray(probs))[1](
        jnp.asarray(g))[0])
    assert not np.isfinite(jax_plain[:, :, -2:]).any()


def _models(compute_dtype, strict, fused_jax=False):
    hp = JaxHParams(**dict(HP_KW, fused_attention=fused_jax),
                    compute_dtype=compute_dtype)
    jmodel = JaxDaftExprt.from_hparams(hp).clone(strict_masking=strict)
    batch = _make_batch(hp, 2, 16, 64)
    params = jmodel.init({'params': jax.random.PRNGKey(0),
                          'dropout': jax.random.PRNGKey(1)},
                         **batch)['params']
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    tmodel = DaftExprt.from_hparams(
        HyperParams(**HP_KW, compute_dtype=compute_dtype), device='cpu',
        strict_masking=strict).load_bridged(acoustic_state_from_jax(params))
    return hp, jmodel, params, tmodel


def _train_batch(hp, seed=0, B=3, L=20, T=96):
    """A ragged training batch: symbols of 20 / 13 / 6, frames 96 / 61 /
    30 (padding beyond them), three speakers."""
    b = _make_batch(hp, B, L, T, seed=seed)
    rng = np.random.RandomState(seed + 1)
    in_len, out_len = np.array([L, 13, 6]), np.array([T, 61, 30])
    in_mask = np.arange(L)[None] < in_len[:, None]
    out_mask = np.arange(T)[None] < out_len[:, None]
    durs = np.where(in_mask, rng.randint(1, 6, (B, L)), 0).astype(np.int64)
    b.update(symbols=np.where(in_mask, b['symbols'], 0),
             durations_int=durs,
             durations_float=(durs * hp.hop_length / hp.sampling_rate
                              ).astype(np.float32),
             input_lengths=in_len, output_lengths=out_len,
             speaker_ids=np.array([0, 2, 1]))
    for k in ('symbols_energy', 'symbols_pitch'):
        b[k] = np.where(in_mask, b[k], 0).astype(np.float32)
    for k in ('frames_energy', 'frames_pitch'):
        b[k] = np.where(out_mask, b[k], 0).astype(np.float32)
    b['mel_specs'] = np.where(out_mask[:, None], b['mel_specs'],
                              0).astype(np.float32)
    return b


def _close(name, got, ref, compute_dtype):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    if compute_dtype == 'bfloat16':
        assert rel_l2(got, ref) < 2e-2, name
    else:
        band = {'mel_preds': 1e-3, 'alignments': 1e-5}.get(name, 1e-4)
        assert max_abs(got, ref) < band, name


@pytest.mark.parametrize('compute_dtype,strict,fused_jax', [
    ('float32', True, True), ('float32', False, False),
    ('bfloat16', True, False), ('bfloat16', False, False)])
def test_training_forward_matches_jax(compute_dtype, strict, fused_jax,
                                      monkeypatch):
    """All six outputs of DaftExprt.forward against DaftExprt.apply
    (deterministic). The first case runs the JAX model's Pallas attention
    in interpret mode."""
    if fused_jax:
        monkeypatch.setenv('DAFT_FUSED_ATTN_INTERPRET', '1')
    hp, jmodel, params, tmodel = _models(compute_dtype, strict, fused_jax)
    b = _train_batch(hp)
    j = jmodel.apply({'params': params}, deterministic=True, **b)
    t = tmodel(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    assert set(t) == set(j)
    for name in j:
        _close(name, t[name], np.asarray(j[name], np.float32), compute_dtype)


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_accent_encoder_and_speaker_classifier_match_jax(compute_dtype):
    """encode_accent (the AccentEncoder) and the SpeakerClassifier on its
    output, each against the JAX module's method on the same params."""
    hp, jmodel, params, tmodel = _models(compute_dtype, True)
    b = _train_batch(hp, seed=4)
    args = [b[k] for k in ('frames_energy', 'frames_pitch', 'mel_specs',
                           'output_lengths')]
    j_acc = np.asarray(jmodel.apply({'params': params}, *args,
                                    method=jmodel.encode_accent))
    t_acc = tmodel.encode_accent(*(torch.from_numpy(a) for a in args))
    _close('accent_emb', t_acc, j_acc, compute_dtype)
    j_spk = np.asarray(jmodel.apply(
        {'params': params}, jnp.asarray(j_acc),
        method=lambda m, x: m.speaker_classifier(x)))
    t_spk = tmodel.speaker_classifier(torch.from_numpy(j_acc))
    _close('speaker_preds', t_spk, j_spk, 'float32')
    assert t_spk.shape == (3, hp.n_speakers)


def test_training_mode_draws_from_the_generator():
    """In training mode the forward's dropout masks come from the
    generator: the same seed gives the same outputs, another seed others;
    without a generator it raises; eval mode draws nothing."""
    hp, _, _, tmodel = _models('float32', True)
    b = {k: torch.from_numpy(np.asarray(v))
         for k, v in _train_batch(hp).items()}
    eval_out = tmodel(**b)['mel_preds']
    tmodel.train()

    def run(seed):
        return tmodel(**b, generator=torch.Generator().manual_seed(seed))[
            'mel_preds']
    a, again, other = run(1), run(1), run(2)
    assert torch.equal(a, again)
    assert max_abs(a.detach(), other.detach()) > 1e-3
    assert max_abs(a.detach(), eval_out.detach()) > 1e-3
    with pytest.raises(ValueError, match='Generator'):
        tmodel(**b)
    tmodel.eval()
    assert torch.equal(tmodel(**b)['mel_preds'], eval_out)

"""The port's acoustic inference (daft_exprt_torch/models/daft_exprt.py),
its Synthesizer and the parameter bridge against the JAX package, at a
small width (2 blocks, width 32, 2 heads, conv_channels 64) on ragged
batches. Params are JAX's init plus seeded numpy noise on every leaf (so
biases and LayerNorm params are not trivial), carried by the bridge.

Bands: float32 mel atol 1e-3 (BASELINE.md), alignments 1e-5; bf16 compute
mel rel-L2 <= 2e-2 (bf16 rounds at other points in the two frameworks).
"""
import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _make_batch
from daft_exprt_tpu.generate import Synthesizer as JaxSynthesizer
from daft_exprt_tpu.hparams import HyperParams as JaxHParams
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.generate import Synthesizer
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.models.daft_exprt import DaftExprt

from tests.torch_port_utils import max_abs, rel_l2

SMALL = {'nb_blocks': 2, 'hidden_embed_dim': 32, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 64,
         'conv_dropout': 0.1}
HP_KW = dict(verbose=False, training_files='unused',
             validation_files='unused', output_directory='/nonexistent',
             language='english', speakers=['a', 'b'],
             phoneme_encoder=dict(SMALL), accent_encoder=dict(SMALL),
             frame_decoder=dict(SMALL), fused_attention=False)


def _jax_model(compute_dtype, strict):
    hp = JaxHParams(**HP_KW, compute_dtype=compute_dtype)
    model = JaxDaftExprt.from_hparams(hp).clone(strict_masking=strict)
    batch = _make_batch(hp, 2, 16, 64)
    params = model.init({'params': jax.random.PRNGKey(0),
                         'dropout': jax.random.PRNGKey(1)}, **batch)['params']
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    return hp, model, params


def _port_model(compute_dtype, strict, params):
    hp = HyperParams(**HP_KW, compute_dtype=compute_dtype)
    model = DaftExprt.from_hparams(hp, device='cpu', strict_masking=strict)
    return hp, model.load_bridged(acoustic_state_from_jax(params))


def _batch(hp, seed=0, B=3, L=24):
    rng = np.random.RandomState(seed)
    lengths = np.array([L, 17, 9][:B], np.int64)
    valid = np.arange(L)[None, :] < lengths[:, None]
    durs = np.where(valid, rng.randint(1, 5, (B, L)), 0).astype(np.int64)
    return dict(
        symbols=np.where(valid, rng.randint(1, hp.n_symbols, (B, L)), 0),
        duration_preds=(durs * hp.hop_length / hp.sampling_rate
                        ).astype(np.float32),
        durations_int=durs,
        energy_preds=np.where(valid, rng.randn(B, L), 0).astype(np.float32),
        pitch_preds=np.where(valid, rng.randn(B, L), 0).astype(np.float32),
        input_lengths=lengths,
        spk_embs=rng.randn(B, hp.external_emb_dim).astype(np.float32),
        accent_emb=rng.randn(B, SMALL['hidden_embed_dim']).astype(np.float32),
    )


def _run_both(compute_dtype, strict):
    hp, jmodel, params = _jax_model(compute_dtype, strict)
    _, tmodel = _port_model(compute_dtype, strict, params)
    b = _batch(hp)
    out_len = b['durations_int'].sum(1)
    T = int(out_len.max())
    j = jmodel.apply({'params': params}, method=jmodel.inference,
                     output_lengths=out_len, n_frames=T, deterministic=True,
                     **b)
    t = tmodel.inference(output_lengths=torch.from_numpy(out_len),
                         n_frames=T, **{k: torch.from_numpy(np.asarray(v))
                                        for k, v in b.items()})
    return ({k: np.asarray(v, np.float32) for k, v in j.items()},
            {k: v.float().numpy() for k, v in t.items()})


@pytest.mark.parametrize('strict', [True, False])
def test_inference_matches_jax_f32(strict):
    j, t = _run_both('float32', strict)
    assert t['mel_preds'].shape == j['mel_preds'].shape
    assert t['alignments'].shape == j['alignments'].shape
    assert max_abs(t['mel_preds'], j['mel_preds']) < 1e-3
    assert max_abs(t['alignments'], j['alignments']) < 1e-5


def test_inference_matches_jax_bf16():
    j, t = _run_both('bfloat16', True)
    assert np.isfinite(t['mel_preds']).all()
    assert rel_l2(t['mel_preds'], j['mel_preds']) < 2e-2


def test_synthesizer_matches_jax():
    hp_j, jmodel, params = _jax_model('float32', True)
    hp_t, tmodel = _port_model('float32', True, params)
    b = _batch(hp_j, seed=3)
    j_mel, j_w, j_len = JaxSynthesizer(jmodel, params, hp_j).infer(**b)
    t_mel, t_w, t_len = Synthesizer(tmodel, hp_t).infer(**b)
    # padded to the (64 symbol, 256 frame) buckets, cropped to T_true
    assert t_mel.shape == j_mel.shape == (3, 80, int(j_len.max()))
    assert t_w.shape == j_w.shape
    assert np.array_equal(t_len, j_len)
    assert max_abs(t_mel, j_mel) < 1e-3
    assert max_abs(t_w, j_w) < 1e-5


def test_bridge_maps_every_leaf_once():
    """Every leaf of a full JAX DaftExprt tree (accent encoder and speaker
    classifier included) maps to one parameter of the port and loads; a
    missing or an unknown key raises."""
    _, _, params = _jax_model('float32', True)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = acoustic_state_from_jax(params)
    assert len(state) == len(leaves)
    assert any(k.startswith('accent_encoder.ln_2.') for k in state)
    assert any(k.startswith('speaker_classifier.fc3.') for k in state)
    _, model = _port_model('float32', True, params)
    assert set(state) == set(dict(model.named_parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    # Dense kernels arrive transposed, conv kernels as (out, in, k)
    k = np.asarray(params['spk_projection']['linear_layer']['kernel'])
    assert np.array_equal(state['spk_projection.linear_layer.weight'], k.T)
    c = np.asarray(params['phoneme_encoder']['block_0']['feed_forward']
                   ['conv1']['conv']['kernel'])
    assert np.array_equal(
        state['phoneme_encoder.block_0.feed_forward.conv1.conv.weight'],
        c.transpose(2, 1, 0))
    with pytest.raises(KeyError, match='no mapping'):
        acoustic_state_from_jax({'x': {'running_mean': np.zeros(3)}})
    for key in ('spk_projection.linear_layer.bias',
                'accent_encoder.conv_0.conv.weight',
                'speaker_classifier.fc1.linear_layer.weight'):
        with pytest.raises(KeyError, match='missing'):
            model.load_bridged({k: v for k, v in state.items() if k != key})
    with pytest.raises(KeyError, match='unexpected'):
        model.load_bridged(dict(state, **{'extra.weight': torch.zeros(1)}))

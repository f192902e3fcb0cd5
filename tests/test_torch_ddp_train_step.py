"""The port's data-parallel training step (``make_train_step(mesh=...)``)
on two gloo ranks against the JAX package's step over a 2-device data mesh
(``make_train_step(mesh=make_mesh(n_data=2, ...))``), at the same global
batch of 4 (rows 0-1 on rank 0, 2-3 on rank 1), dropout 0, all five loss
terms on (a random frozen pitch predictor, energy consistency 0.05), the
small width of ``scripts/rehearse_multihost.py`` (2 blocks, width 32, 2
heads), 20 mel channels.

The halves differ in output lengths and in voicing, so the consistency
terms' global denominators matter: a control shows that the mean of the
per-replica losses (what an average of per-replica gradients optimises)
misses the JAX loss by more than 1e-3 on these inputs. ``validate`` over
the mesh, on shards that differ by a batch, against JAX's ``validate``
over its mesh. Bands as
``test_torch_train_step.py``: metrics relative 1e-5; the first step's
gradients 1e-4 of each tensor's largest; parameters 1e-3 lr where |g| >
1e-6 and 2 lr elsewhere (the first Adam update is ~lr sign(g)). World 1
is today's single-process step bit for bit. The JAX side runs its XLA
attention; the port's ranks run ``fused_attention`` (its plain pair on
the CPU).

The batch's durations are a collated batch's (zero on padded symbols,
summing to each row's frames). With ``_make_batch``'s durations (every
symbol 4 frames whatever the lengths), JAX's 2-device step itself leaves
its unsharded function: gradient norm 32.3660 against 32.3804 of
``jax.grad`` of the same loss and of its ``mesh=None`` step (4.4e-4; the
port's ranks give 32.3804), while with either lengths full the two agree
to 2e-7."""
import concurrent.futures

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
from daft_exprt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_exprt_tpu.train import validate as jax_validate
from daft_exprt_torch.bridge import acoustic_state_from_jax
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.loss import loss_cfg_from_hparams
from daft_exprt_torch.parallel import train_step as pts
from daft_exprt_torch.parallel.launch import run_ranks
from daft_exprt_torch.parallel.mesh import init_distributed, make_mesh

from tests import torch_dist_workers as workers

N_MEL = 20
ITERATIONS = (5000.0, 5001.0)      # inside the adversarial warmup
RUNS = ((1, 2), (2, 1))            # (accumulation_steps, steps)
SMALL = {'nb_blocks': 2, 'hidden_embed_dim': 32, 'attn_nb_heads': 2,
         'attn_dropout': 0.0, 'conv_kernel': 3, 'conv_channels': 64,
         'conv_dropout': 0.0}


def _hp_kw(fused, dropout=0.0, accumulation_steps=1):
    cfg = dict(SMALL, attn_dropout=dropout, conv_dropout=dropout)
    return dict(verbose=False, training_files='unused',
                validation_files='unused', output_directory='/nonexistent',
                language='english', speakers=['a', 'b'],
                phoneme_encoder=dict(cfg), accent_encoder=dict(cfg),
                frame_decoder=dict(cfg), fused_attention=fused,
                compute_dtype='float32', n_mel_channels=N_MEL,
                accumulation_steps=accumulation_steps)


@pytest.fixture(scope='module')
def setup():
    """JAX model and params (init plus seeded noise), the pitch predictor's
    variables and a global batch of 4 whose halves differ in lengths and
    voicing."""
    return _setup()


def _setup():
    hp = JaxHParams(**_hp_kw(False))
    model = JaxDaftExprt.from_hparams(hp)
    b = _make_batch(hp, 4, 16, 64, seed=5)
    b.update(output_lengths=np.array([64, 58, 30, 17]),
             input_lengths=np.array([16, 15, 8, 5]),
             speaker_ids=np.array([0, 1, 2, 1]))
    # durations as a collated batch has them: zero on padded symbols,
    # summing to each row's frames
    dur = np.zeros_like(b['durations_int'])
    for i, (n_sym, n_fr) in enumerate(zip(b['input_lengths'],
                                          b['output_lengths'])):
        dur[i, :n_sym] = n_fr // n_sym
        dur[i, n_sym - 1] += n_fr - (n_fr // n_sym) * n_sym
    b.update(durations_int=dur, durations_float=(
        dur * hp.hop_length / hp.sampling_rate).astype(np.float32))
    rng = np.random.RandomState(11)
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
    # rank 0's rows voiced on ~90% of frames, rank 1's on ~20%
    voiced = rng.rand(4, 64) < np.array([0.9, 0.9, 0.2, 0.2])[:, None]
    raw = {'frames_energy': (np.abs(b['frames_energy']) * 3).astype(
        np.float32),
           'frames_pitch': np.where(voiced, np.abs(b['frames_pitch']) + 5,
                                    0).astype(np.float32)}
    jax_pp = (lambda v, mel: jpp.apply(v, mel, deterministic=True,
                                       use_running_average=True), ppv)
    return hp, model, params, jax_pp, b, raw


def _val_pairs(b, raw):
    """Validation: the global batches (b, then b with other mels) and each
    rank's (normalised batch, raw frames) pairs of them. Rank 0 holds rows
    0-1 of the first and the whole second, rank 1 rows 2-3 of the first
    and no second: shards that differ by a batch."""
    b2 = dict(b, mel_specs=(0.5 * b['mel_specs'] + 0.3).astype(np.float32))
    rows = lambda d, lo, hi: {k: v[lo:hi] for k, v in d.items()}  # noqa
    per_rank = [[(rows(b, 0, 2), rows(raw, 0, 2)), (b2, raw)],
                [(rows(b, 2, 4), rows(raw, 2, 4))]]
    return [(b, raw), (b2, raw)], per_rank


@pytest.fixture(scope='module')
def ranks(setup):
    """Both ranks' results (torch_dist_workers.ddp_train_step), computed
    in the background while the JAX side compiles: call ``.result()``."""
    _, _, params, (_, ppv), b, raw = setup
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, workers.ddp_train_step, 2, args=(
            _hp_kw(True), params, ppv, N_MEL, b, raw, RUNS, ITERATIONS,
            _val_pairs(b, raw)[1]), device='cpu', timeout=300, threads=1)


@pytest.fixture(scope='module')
def jax_side(setup):
    """JAX's loss of the global batch at the initial parameters and its
    gradient (port naming), its train step over a 2-device data mesh at
    each accumulation of RUNS, compiled side by side, its eval step's
    metrics and its ``validate`` over the mesh on the global validation
    batches."""
    hp, jmodel, params, jax_pp, b, raw = setup

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

    mesh = jax_make_mesh(n_data=2, devices=jax.devices('cpu')[:2])
    tx = jts.make_optimizer(hp)
    opt_state = tx.init(params)

    def step(accum):
        hp_a = JaxHParams(**_hp_kw(False, accumulation_steps=accum))
        return jts.make_train_step(jmodel, tx, jax_loss_cfg(hp_a), jax_pp,
                                   mesh=mesh, accumulation_steps=accum,
                                   donate=False).lower(
            params, opt_state, b, raw, np.float32(0),
            jax.random.PRNGKey(0)).compile()

    with concurrent.futures.ThreadPoolExecutor(2 + len(RUNS)) as pool:
        grad = pool.submit(lambda: jax.jit(jax.value_and_grad(loss_fn)).lower(
            params).compile())
        evaluate = pool.submit(lambda: jts.make_eval_step(
            jmodel, jax_loss_cfg(hp), jax_pp, mesh=mesh).lower(
                params, b, raw).compile())
        steps = {a: pool.submit(step, a) for a, _ in RUNS}
        loss, grads = grad.result()(params)
        metrics = {k: float(v) for k, v in
                   evaluate.result()(params, b, raw)[0].items()}
        steps = {a: f.result() for a, f in steps.items()}
    val_loss = jax_validate(evaluate.result(), params,
                            *workers.val_batches(_val_pairs(b, raw)[0]),
                            mesh, hp)
    return float(loss), acoustic_state_from_jax(jax.tree_util.tree_map(
        np.asarray, grads)), tx, steps, metrics, val_loss


@pytest.mark.parametrize('accumulation_steps,n_steps', RUNS)
def test_two_ranks_match_the_jax_mesh_step(setup, ranks, jax_side,
                                           accumulation_steps, n_steps):
    hp, jmodel, params, jax_pp, b, raw = setup
    _, grads0, tx, jsteps = jax_side[:4]
    jstep = jsteps[accumulation_steps]
    noise = {k: g.abs() <= 1e-6 for k, g in grads0.items()}

    r0, r1 = (r[accumulation_steps]['steps'] for r in ranks.result())
    for s0, s1 in zip(r0, r1):          # the ranks agree exactly
        assert s0['metrics'] == s1['metrics']
        for k, v in s0['params'].items():
            assert np.array_equal(v, s1['params'][k]), k
    jparams, opt_state = params, tx.init(params)
    lr_fn = pts.make_learning_rate_fn(HyperParams(**_hp_kw(True)))
    lr_sum = 0.0
    for n, it in enumerate(ITERATIONS[:n_steps]):
        jparams, opt_state, jm = jstep(jparams, opt_state, b, raw,
                                       np.float32(it), jax.random.PRNGKey(0))
        tm = r0[n]['metrics']
        assert set(tm) == set(jm)
        for k, v in jm.items():
            assert abs(tm[k] - float(v)) <= 1e-5 * abs(float(v)) + 1e-9, k
        if n == 0 and accumulation_steps == 1:
            for k, g in r0[0]['grads'].items():
                assert float(np.abs(g - grads0[k].numpy()).max()) <= \
                    1e-4 * float(grads0[k].abs().max()) + 1e-12, k
        lr_sum += lr_fn(n)
        ref = acoustic_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
        for k, p in r0[n]['params'].items():
            d = np.abs(p - ref[k].numpy())
            assert float(np.where(noise[k].numpy(), 0.0, d).max()) <= \
                1e-3 * lr_sum, k
            assert float(d.max()) <= 2 * lr_sum + 1e-7, k


def test_replica_mean_of_losses_is_not_the_global_loss(ranks, jax_side):
    """The control: on these inputs, averaging the ranks' own losses (a
    plain DDP wrap's objective) misses the JAX global loss, which the
    data-parallel step reports."""
    jax_loss = jax_side[0]
    naive = np.mean([r[1]['local_loss'] for r in ranks.result()])
    assert abs(naive - jax_loss) > 1e-3 * abs(jax_loss), (naive, jax_loss)
    # the step's first metrics are the global loss at the same parameters
    got = ranks.result()[0][1]['steps'][0]['metrics']['loss']
    assert abs(got - jax_loss) <= 1e-5 * abs(jax_loss)


def test_eval_step_over_the_mesh_matches_jax(ranks, jax_side):
    """``make_eval_step(mesh=...)``: the global batch's metrics on every
    rank, against JAX's eval step over the 2-device mesh."""
    want = jax_side[4]
    for r in ranks.result():
        got = r[1]['eval']
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v) + 1e-9, k


def test_validate_over_the_mesh_matches_jax(ranks, jax_side):
    """``train``'s ``validate`` over the mesh on shards that differ by a
    batch: every rank returns JAX's ``validate`` over the 2-device mesh,
    the mean of the global batches' losses, and the second batch, which
    rank 1 joins without rows, counts (the value is not the first batch's
    loss alone)."""
    want, first = jax_side[5], jax_side[4]['loss']
    got = [r[1]['validate'] for r in ranks.result()]
    assert got[0] == got[1]
    assert abs(got[0] - want) <= 1e-5 * abs(want), (got, want)
    assert abs(got[0] - first) > 1e-3 * abs(first), (got, first)


def test_world_one_is_the_single_process_step(setup, tmp_path):
    """A data mesh of one rank (gloo) computes today's step bit for bit,
    dropout 0.1 on: the same metrics, gradients and parameters over two
    steps, the same dropout masks (rank 0 keeps the single-process
    seed)."""
    _, _, params, (_, ppv), b, raw = setup
    kw = _hp_kw(True, dropout=0.1)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    tr = {k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()}
    init_distributed(0, 1, f'file://{tmp_path}/store', device='cpu',
                     timeout=60)
    try:
        mesh = make_mesh(device='cpu')
        results = []
        for m in (None, mesh):
            hp, model, opt, pp = workers.port_acoustic(kw, params, ppv,
                                                       N_MEL)
            step = pts.make_train_step(model, opt, loss_cfg_from_hparams(hp),
                                       pp, mesh=m)
            steps = []
            for it in ITERATIONS:
                metrics = step(tb, tr, it, 3)
                steps.append((metrics, {k: (p.detach().clone(),
                                            p.grad.clone())
                                        for k, p in model.named_parameters()
                                        }))
            results.append(steps)
    finally:
        torch.distributed.destroy_process_group()
    for (m0, p0), (m1, p1) in zip(*results):
        assert set(m0) == set(m1)
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        for k, (p, g) in p0.items():
            assert torch.equal(p, p1[k][0]) and torch.equal(g, p1[k][1]), k
    assert pts.step_seed(3, 7, 1) == pts.step_seed(3, 7, 1, rank=0)
    assert len({pts.step_seed(3, 7, m, r) for m in range(2)
                for r in range(4)}) == 8

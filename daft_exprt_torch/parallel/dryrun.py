"""A compile-and-run check of the flagship model and a multi-rank dry run
(the counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``).

``entry()`` returns the full-size acoustic model's deterministic forward and
example inputs. ``dryrun_multichip(n)`` runs on the caller's process group
of ``n`` ranks (``mesh.init_distributed`` first, on every rank): one full
data-parallel train step (loss, gradients, Adam) at accumulation 2 on tiny
shapes, the 2-D (data x model) tensor-parallel vocoder when ``n`` is even
and at least 4, and the data-parallel GAN steps; rank 0 prints the JAX
dry run's lines.
"""
import numpy as np
import torch
import torch.distributed as dist

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.hparams import HyperParams
from daft_exprt_torch.loss import loss_cfg_from_hparams
from daft_exprt_torch.models.daft_exprt import DaftExprt
from daft_exprt_torch.models.discriminators import (
    init_mpd_params, init_msd_params,
)
from daft_exprt_torch.models.hifigan import init_generator_params
from daft_exprt_torch.parallel.mesh import data_rows, make_mesh, shard_batch
from daft_exprt_torch.parallel.train_step import (
    make_optimizer, make_train_step,
)
from daft_exprt_torch.parallel.vocoder_sharding import (
    make_sharded_vocoder, shard_generator_params,
)
from daft_exprt_torch.vocoder_finetune import (
    generator_to_weight_norm, make_gan_steps,
)

SMALL = {'nb_blocks': 2, 'hidden_embed_dim': 32, 'attn_nb_heads': 2,
         'attn_dropout': 0.1, 'conv_kernel': 3, 'conv_channels': 64,
         'conv_dropout': 0.1}
VOC_CFG = {'sampling_rate': 22050, 'upsample_rates': [8, 2],
           'upsample_kernel_sizes': [16, 4], 'upsample_initial_channel': 64,
           'resblock': '2', 'resblock_kernel_sizes': [3],
           'resblock_dilation_sizes': [[1, 3]], 'model_in_dim': 80}
GAN_CFG = dict(VOC_CFG, upsample_initial_channel=16, resblock='1')


def make_batch(hp, B, L, T, seed=0):
    """A seeded training batch of B utterances of L symbols and T frames
    (numpy; the JAX package's ``__graft_entry__._make_batch``)."""
    rng = np.random.RandomState(seed)
    dur_int = np.full((B, L), T // L, dtype=np.int64)
    dur_int[:, -1] += T - (T // L) * L
    return dict(
        symbols=rng.randint(1, hp.n_symbols, (B, L)),
        durations_float=(dur_int * hp.hop_length / hp.sampling_rate
                         ).astype(np.float32),
        durations_int=dur_int,
        symbols_energy=rng.randn(B, L).astype(np.float32),
        symbols_pitch=rng.randn(B, L).astype(np.float32),
        input_lengths=np.full((B,), L, dtype=np.int64),
        frames_energy=rng.randn(B, T).astype(np.float32),
        frames_pitch=rng.randn(B, T).astype(np.float32),
        mel_specs=rng.randn(B, hp.n_mel_channels, T).astype(np.float32),
        output_lengths=np.full((B,), T, dtype=np.int64),
        speaker_ids=np.zeros((B,), dtype=np.int64),
        spk_embs=rng.randn(B, hp.external_emb_dim).astype(np.float32),
    )


def _hparams(**kw):
    return HyperParams(verbose=False, training_files='unused',
                       validation_files='unused', output_directory='unused',
                       language='english', speakers=['lj'], **kw)


def entry(device=None):
    """(fn, (params, batch)): ``fn(params, batch)`` is the full-size
    acoustic model's deterministic forward (phoneme and accent encoders,
    FiLM, Gaussian upsampling, frame decoder) -> mel_preds, on ``device``
    (default cuda; raises without it unless given 'cpu'); ``params`` its
    seeded random state dict, ``batch`` B=2 x L=64 x T=512."""
    dev = resolve_device(device)
    hp = _hparams()
    model = DaftExprt.from_hparams(hp, device=dev, seed=0).eval()
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in make_batch(hp, 2, 64, 512).items()}

    @torch.no_grad()
    def fn(params, batch):
        return torch.func.functional_call(model, params, (),
                                          batch)['mel_preds']

    return fn, (dict(model.state_dict()), batch)


def dryrun_multichip(n_devices, device=None):
    """The multi-rank dry run (module note) on ``device`` (default cuda;
    raises without it unless given 'cpu'); the process group must have
    ``n_devices`` ranks."""
    dev = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f'dryrun_multichip({n_devices}) needs a process '
                           f'group of {n_devices} ranks: call '
                           'mesh.init_distributed on each first')
    chief = dist.get_rank() == 0
    hp = _hparams(phoneme_encoder=dict(SMALL), accent_encoder=dict(SMALL),
                  frame_decoder=dict(SMALL), batch_size=1,
                  accumulation_steps=2)
    mesh = make_mesh(n_data=n_devices, n_model=1, device=dev)
    model = DaftExprt.from_hparams(hp, device=mesh.device, seed=0).train()
    B = n_devices * hp.accumulation_steps   # per micro-batch global = n
    lo, hi = data_rows(B, mesh)
    batch = {k: v[lo:hi] for k, v in make_batch(hp, B, 16, 64).items()}
    raw = {'frames_energy': batch['frames_energy'],
           'frames_pitch': batch['frames_pitch']}
    step = make_train_step(model, make_optimizer(model, hp),
                           loss_cfg_from_hparams(hp), None,
                           accumulation_steps=hp.accumulation_steps,
                           mesh=mesh)
    metrics = step(shard_batch(batch, mesh), shard_batch(raw, mesh), 0, 2)
    loss = float(metrics['loss'])
    assert np.isfinite(loss), f'non-finite loss in dry run: {loss}'
    if chief:
        print(f'dryrun_multichip({n_devices}): loss={loss:.4f} '
              f'grad_norm={float(metrics["grad_norm"]):.4f}', flush=True)

    # 2D (data x model) mesh: the batch over data, the vocoder's channels
    # over model
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_mesh(n_data=n_devices // 2, n_model=2, device=dev)
        params = init_generator_params(3, VOC_CFG, device=mesh2d.device)
        voc = make_sharded_vocoder(mesh2d, VOC_CFG)
        wav = voc(shard_generator_params(params, mesh2d),
                  torch.zeros(2, 80, 16))     # this rank's rows
        assert np.isfinite(float(wav.abs().sum()))
        if chief:
            print(f'dryrun_multichip({n_devices}): 2D mesh '
                  f'({n_devices // 2}x2) TP vocoder ok', flush=True)

    # data-parallel GAN fine-tuning steps over the same data mesh
    d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
        GAN_CFG, lr=1e-4, mesh=mesh)
    rng = np.random.RandomState(0)
    Tw = 512
    lo, hi = data_rows(n_devices, mesh)       # a global batch of n
    mel = torch.from_numpy(rng.randn(n_devices, 80, Tw // 16).astype(
        np.float32)[lo:hi]).to(mesh.device)
    y = torch.from_numpy((0.1 * rng.randn(n_devices, 1, Tw)).astype(
        np.float32)[lo:hi]).to(mesh.device)
    g_wn = generator_to_weight_norm(init_generator_params(
        4, GAN_CFG, device=mesh.device))
    mpd = init_mpd_params(5, mesh.device)
    msd = init_msd_params(5, mesh.device)
    d_opt, g_opt = optim_d(mpd, msd), optim_g(g_wn)
    d_loss = float(d_step(mpd, msd, d_opt, g_wn, mel, y))
    with torch.no_grad():
        y_mel = loss_mel_fn(y[:, 0])
    g_loss, _ = g_step(g_wn, g_opt, mpd, msd, mel, y, y_mel)
    g_loss = float(g_loss)
    assert np.isfinite(d_loss) and np.isfinite(g_loss)
    if chief:
        print(f'dryrun_multichip({n_devices}): DP GAN steps ok '
              f'(d_loss={d_loss:.3f} g_loss={g_loss:.3f})', flush=True)

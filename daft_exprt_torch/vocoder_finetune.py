"""HiFi-GAN vocoder fine-tuning: full GAN training (PyTorch port of
``daft_exprt_tpu/vocoder_finetune.py``).

(predicted-mel, ground-truth-wav) pairs with random 8192-sample segment
crops, AdamW (lr 2e-4, betas 0.8/0.99, optax's eps 1e-8 and weight decay
1e-4 on every leaf), a discriminator step (MPD + MSD, LSGAN) and a
generator step (mel-L1 x 45 + feature matching + adversarial), generator
and discriminator checkpoints.

The generator is the port's plain route (``generator_forward`` without
the fused kernels, as the JAX step runs it without Pallas) on params kept
in the weight-norm parameterisation ``{'g', 'v', 'b'}``; the loss mel is
the DFT-matmul extractor of ``ops/mel.py`` at full bandwidth, in float32
without TF32. ``compute_dtype='bfloat16'`` runs the generator and the
discriminators' convs in bf16 (params, optimizer states, weight-norm
folds, the power iteration and the mel loss stay float32).

``mesh`` runs both steps data-parallel over the mesh's data axis, one
process a rank: the steps take this rank's rows of the global batch, as
many on every rank; parameters, optimizer states and the spectral state
stay replicated (the power iteration depends on the weights only). Every
loss term is a plain mean over equal shards (LSGAN scores, feature maps,
mel L1), so the global gradient is the mean of the ranks' gradients: one
all-reduce of a flat buffer a step, divided by the data-axis size,
carries the gradients and the losses. ``finetune`` then logs, validates
and saves on rank 0 only, the others waiting at a barrier after each
save.

Difference by design: no TensorBoard where neither ``tensorboardX`` nor
``torch.utils.tensorboard`` imports (``utils/logger._summary_writer``):
the loop then logs to Python logging only.
"""
import contextlib
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.frontend.audio import load_wav
from daft_exprt_torch.models.discriminators import (
    discriminator_loss, feature_loss, generator_loss, init_mpd_params,
    init_msd_params,
)
from daft_exprt_torch.models.hifigan import (
    DEFAULT_CONFIG, _to, generator_forward,
)
from daft_exprt_torch.ops.mel import _windowed_dft_basis, mel_filterbank
from daft_exprt_torch.ops.vocoder_kernels import full_f32
from daft_exprt_torch.parallel.mesh import (
    all_reduce_grads, data_rows, mesh_device,
)
from daft_exprt_torch.utils.logger import _summary_writer

_logger = logging.getLogger(__name__)

SAMPLING_RATE = 22050
N_FFT = 1024
NUM_MELS = 80
HOP_SIZE = 256
FMIN = 0
SEGMENT_SIZE = 8192
ADAM_EPS = 1e-8            # optax.adamw's defaults
WEIGHT_DECAY = 1e-4


# ----------------------------------------------------------------------
# weight-norm (g, v) parameterisation over the generator's params
# ----------------------------------------------------------------------

def _map_convs(params, leaf_key, fn):
    return {k: (fn(v) if leaf_key in v else _map_convs(v, leaf_key, fn))
            for k, v in params.items()}


def generator_to_weight_norm(params):
    """Plain kernels {'w', 'b'} -> {'g', 'v', 'b'} (norm over every dim but
    the first: a transposed conv's (in, out, k) kernel is normed over (out,
    k), as torch's weight_norm(dim=0) does). New tensors."""
    def convert(leaf):
        w = leaf['w'].detach()
        g = w.pow(2).sum(dim=tuple(range(1, w.ndim)), keepdim=True).sqrt()
        return {'g': g, 'v': w.clone(), 'b': leaf['b'].detach().clone()}
    return _map_convs(params, 'w', convert)


def generator_from_weight_norm(params_wn):
    """{'g', 'v', 'b'} -> {'w', 'b'}: w = g * v / max(|v|, 1e-12);
    differentiable."""
    def fold(leaf):
        v = leaf['v']
        norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
        return {'w': leaf['g'] * v / torch.clamp(norm, min=1e-12),
                'b': leaf['b']}
    return _map_convs(params_wn, 'v', fold)


def param_leaves(params):
    """The tensors of a nested param dict, in sorted-path order."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


# ----------------------------------------------------------------------
# loss mel (full bandwidth, like FMAX_FOR_LOSS=None)
# ----------------------------------------------------------------------

def make_loss_mel_fn(sr=SAMPLING_RATE, n_fft=N_FFT, hop=HOP_SIZE,
                     n_mels=NUM_MELS, fmin=FMIN, fmax=None, device=None):
    """wav (B, T_samples) -> (B, n_mels, T_frames) log-mel on ``device``
    (default cuda): reflect padding of (n_fft - hop) / 2, the windowed DFT
    basis, sqrt(re^2 + im^2 + 1e-9), the mel projection, log-clamp at
    1e-5; float32 matmuls without TF32; differentiable."""
    dev = resolve_device(device)
    fb_t = torch.from_numpy(np.ascontiguousarray(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax or sr / 2).T)).to(dev)
    basis_r, basis_i = (torch.from_numpy(b).to(dev)
                        for b in _windowed_dft_basis(n_fft))
    pad = (n_fft - hop) // 2

    def loss_mel(wav):
        x = F.pad(wav[:, None], (pad, pad), mode='reflect')[:, 0]
        frames = x.unfold(1, n_fft, hop)                     # (B, T, n_fft)
        with full_f32():
            re = frames @ basis_r
            im = frames @ basis_i
            spec = torch.sqrt(re * re + im * im + 1e-9)
            mel = spec @ fb_t
        return torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)

    return loss_mel


# ----------------------------------------------------------------------
# dataset
# ----------------------------------------------------------------------

def find_pairs(data_dir):
    """{name}.npy (predicted mel) + {name}.wav (ground-truth audio) pairs."""
    return sorted(x[:-4] for x in os.listdir(data_dir)
                  if x.endswith('.npy')
                  and os.path.isfile(os.path.join(data_dir, x[:-4] + '.wav')))


class HiFiGANFinetuneDataset:
    """Random fixed-size segment crops of (mel, audio) pairs; the crops and
    the shuffle come from ``np.random.RandomState(seed)``, as in the JAX
    package, so both give the same batches."""

    def __init__(self, data_dir, names=None, segment_size=SEGMENT_SIZE,
                 hop=HOP_SIZE, split=True, seed=1234):
        self.data_dir = data_dir
        self.names = names if names is not None else find_pairs(data_dir)
        if not self.names:
            raise ValueError(f'no (npy, wav) pairs found in {data_dir}')
        self.segment_size = segment_size
        self.hop = hop
        self.split = split
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index):
        name = self.names[index]
        mel = np.load(os.path.join(self.data_dir, f'{name}.npy'))
        wav, _ = load_wav(os.path.join(self.data_dir, f'{name}.wav'),
                          target_sr=SAMPLING_RATE)
        frames_per_seg = self.segment_size // self.hop
        if self.split:
            if mel.shape[1] >= frames_per_seg:
                start = self.rng.randint(0, mel.shape[1] - frames_per_seg + 1)
                mel = mel[:, start:start + frames_per_seg]
                wav = wav[start * self.hop: start * self.hop
                          + self.segment_size]
            if mel.shape[1] < frames_per_seg:
                mel = np.pad(mel, ((0, 0),
                                   (0, frames_per_seg - mel.shape[1])),
                             constant_values=np.log(1e-5))
            if len(wav) < self.segment_size:
                wav = np.pad(wav, (0, self.segment_size - len(wav)))
            wav = wav[:self.segment_size]
        return mel.astype(np.float32), wav.astype(np.float32), name

    def batches(self, batch_size, shuffle=True):
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(j)] for j in order[i:i + batch_size]]
            mels = np.stack([it[0] for it in items])
            wavs = np.stack([it[1] for it in items])
            names = [it[2] for it in items]
            yield mels, wavs, names


# ----------------------------------------------------------------------
# training steps
# ----------------------------------------------------------------------

@contextlib.contextmanager
def _frozen(modules):
    """The modules' parameters as constants (no gradient) inside."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def make_gan_steps(config=None, lr=2e-4, b1=0.8, b2=0.99,
                   compute_dtype='float32', device=None, mesh=None):
    """Builds the GAN training steps on ``device`` (default cuda; raises
    without CUDA unless ``device='cpu'``). Returns ``(d_step, g_step,
    (optim_g, optim_d), loss_mel_fn)``:

    - ``optim_g(g_params_wn)`` / ``optim_d(mpd, msd)``: ``torch.optim.AdamW``
      over the generator's weight-norm leaves (made to require gradients) /
      the discriminators' parameters, with optax.adamw's eps and decay;
    - ``d_step(mpd, msd, d_opt, g_params_wn, mel, y)``: one discriminator
      update (the generator under ``no_grad``); writes the spectral state
      to ``msd``'s buffers after the backward; returns the loss;
    - ``g_step(g_params_wn, g_opt, mpd, msd, mel, y, y_mel)``: one
      generator update (the discriminators' weights constants, their
      spectral state not updated); returns (loss, mel L1 = mel term / 45).

    Every tensor argument lies on ``device``; mel (B, n_mels, T), y (B, 1,
    T * hop), y_mel ``loss_mel_fn(y[:, 0])``.

    ``mesh``: data-parallel steps on the mesh's device (module note); mel,
    y and y_mel are this rank's rows, as many on every rank.
    """
    cfg = config or DEFAULT_CONFIG
    dev = mesh_device(mesh, device)
    group = None if mesh is None else mesh.data_group
    n_shards = 1 if mesh is None else mesh.n_data

    def reduce(params, *losses):
        """Mean gradients and losses over the data axis."""
        if group is None:
            return losses
        return tuple(t[0] for t in all_reduce_grads(
            params, losses, group, divide_by=n_shards))

    cdt = torch.bfloat16 if compute_dtype == 'bfloat16' else None
    loss_mel_fn = make_loss_mel_fn(device=dev)

    def adamw(params):
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=ADAM_EPS,
                                 weight_decay=WEIGHT_DECAY)

    def optim_g(g_params_wn):
        leaves = param_leaves(g_params_wn)
        for p in leaves:
            p.requires_grad_(True)
        return adamw(leaves)

    def optim_d(mpd, msd):
        return adamw(list(mpd.parameters()) + list(msd.parameters()))

    def gen_wav(g_params_wn, mel):
        plain = generator_from_weight_norm(g_params_wn)
        if cdt is not None:
            plain = _map_convs(plain, 'w', lambda l: {
                k: v.to(cdt) for k, v in l.items()})
            mel = mel.to(cdt)
        return generator_forward(plain, mel, cfg).float()    # (B, 1, T)

    def d_step(mpd, msd, d_opt, g_params_wn, mel, y):
        with torch.no_grad():
            y_hat = gen_wav(g_params_wn, mel)
        df_r, df_g, _, _ = mpd(y, y_hat, dtype=cdt)
        loss_f, _, _ = discriminator_loss(df_r, df_g)
        ds_r, ds_g, _, _, new_sn = msd(y, y_hat, update_sn=True, dtype=cdt)
        loss_s, _, _ = discriminator_loss(ds_r, ds_g)
        loss = loss_f + loss_s
        d_opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, = reduce([p for grp in d_opt.param_groups
                        for p in grp['params']], loss.detach())
        d_opt.step()
        msd.load_sn_state(new_sn)
        return loss.detach()

    def g_step(g_params_wn, g_opt, mpd, msd, mel, y, y_mel):
        leaves = param_leaves(g_params_wn)
        with _frozen((mpd, msd)):
            y_hat = gen_wav(g_params_wn, mel)
            y_hat_mel = loss_mel_fn(y_hat[:, 0, :])
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * 45.0
            df_r, df_g, fmap_f_r, fmap_f_g = mpd(y, y_hat, dtype=cdt)
            ds_r, ds_g, fmap_s_r, fmap_s_g, _ = msd(y, y_hat,
                                                    update_sn=False,
                                                    dtype=cdt)
            loss_fm = feature_loss(fmap_f_r, fmap_f_g) \
                + feature_loss(fmap_s_r, fmap_s_g)
            loss_adv_f, _ = generator_loss(df_g)
            loss_adv_s, _ = generator_loss(ds_g)
            total = loss_adv_f + loss_adv_s + loss_fm + loss_mel
            grads = torch.autograd.grad(total, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        total, mel_l1 = reduce(leaves, total.detach(),
                               (loss_mel / 45.0).detach())
        g_opt.step()
        return total.detach(), mel_l1.detach()

    return d_step, g_step, (optim_g, optim_d), loss_mel_fn


def finetune(data_dir, output_dir, generator_params, config=None,
             training_steps=1000, batch_size=16, lr=2e-4,
             checkpoint_interval=1000, log_interval=20, seed=1234,
             val_names=None, compute_dtype='float32', device=None,
             mesh=None):
    """Run GAN fine-tuning on ``device`` (default cuda; raises without CUDA
    unless ``device='cpu'``); returns the fine-tuned generator params
    (plain kernels {'w', 'b'}, float32, on the device).
    ``compute_dtype='bfloat16'`` runs mixed-precision steps. ``mesh`` runs
    both steps data-parallel over it (module note): ``batch_size`` is then
    the global batch, which must divide by the data-axis size, and each
    rank steps on its rows of every batch."""
    dev = mesh_device(mesh, device)
    lo, hi = (0, batch_size) if mesh is None else \
        data_rows(batch_size, mesh)
    is_chief = mesh is None or dist.get_rank() == 0
    os.makedirs(output_dir, exist_ok=True)
    cfg = config or DEFAULT_CONFIG
    d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
        cfg, lr, compute_dtype=compute_dtype, device=dev, mesh=mesh)

    g_params_wn = generator_to_weight_norm(
        _to(generator_params, torch.float32, dev))
    mpd = init_mpd_params(seed, device=dev)
    msd = init_msd_params(seed, device=dev)
    g_opt = optim_g(g_params_wn)
    d_opt = optim_d(mpd, msd)

    all_names = find_pairs(data_dir)
    if val_names is None:
        # hold out a few pairs for validation
        val_names = all_names[:max(1, len(all_names) // 20)] \
            if len(all_names) > 4 else []
    train_names = [n for n in all_names if n not in set(val_names)]
    dataset = HiFiGANFinetuneDataset(data_dir, names=train_names, seed=seed)
    if is_chief:
        _logger.info(f'{len(dataset)} training pairs, {len(val_names)} '
                     f'validation pairs')

    writer = _summary_writer() if is_chief else None
    sw = writer(os.path.join(output_dir, 'logs')) if writer else None

    def checkpoint():
        if is_chief:
            _validate(data_dir, val_names, g_params_wn, cfg, loss_mel_fn,
                      sw, step, dev)
            _save(output_dir, step, g_params_wn, mpd, msd)
        if mesh is not None:
            dist.barrier(group=mesh.data_group)

    step, epoch = 0, 0
    start = time.time()
    while step < training_steps:
        epoch += 1
        for mels, wavs, _names in dataset.batches(batch_size):
            if step >= training_steps:
                break
            wavs = torch.from_numpy(wavs[lo:hi]).to(dev)
            mels = torch.from_numpy(mels[lo:hi]).to(dev)
            y = wavs[:, None, :]
            with torch.no_grad():
                y_mel = loss_mel_fn(wavs)
            d_loss = d_step(mpd, msd, d_opt, g_params_wn, mels, y)
            g_loss, mel_l1 = g_step(g_params_wn, g_opt, mpd, msd, mels, y,
                                    y_mel)
            step += 1
            if is_chief and step % log_interval == 0:
                _logger.info(
                    f'Step {step} | Gen {float(g_loss):.3f} | '
                    f'Disc {float(d_loss):.3f} | Mel L1 {float(mel_l1):.4f} '
                    f'| {time.time() - start:.1f}s elapsed')
                if sw is not None:
                    sw.add_scalar('training/gen_loss', float(g_loss), step)
                    sw.add_scalar('training/disc_loss', float(d_loss), step)
                    sw.add_scalar('training/mel_l1', float(mel_l1), step)
            if step % checkpoint_interval == 0:
                checkpoint()
    if step % checkpoint_interval != 0:
        checkpoint()
    if sw is not None:
        sw.close()
    return _plain_detached(g_params_wn)


@torch.no_grad()
def _plain_detached(g_params_wn):
    """The folded generator as constants."""
    return _map_convs(generator_from_weight_norm(g_params_wn), 'w',
                      lambda l: {k: v.detach() for k, v in l.items()})


@torch.no_grad()
def _validate(data_dir, val_names, g_params_wn, cfg, loss_mel_fn, sw, step,
              dev):
    """Full-utterance validation mel L1 (and TensorBoard audio)."""
    if not val_names:
        return None
    plain = generator_from_weight_norm(g_params_wn)
    losses = []
    for idx, name in enumerate(val_names):
        mel = np.load(os.path.join(data_dir, f'{name}.npy'))
        wav, _ = load_wav(os.path.join(data_dir, f'{name}.wav'),
                          target_sr=SAMPLING_RATE)
        y_hat = generator_forward(
            plain, torch.from_numpy(mel[None].astype(np.float32)).to(dev),
            cfg)[0, 0]
        n = min(len(y_hat), len(wav))
        gt_mel = loss_mel_fn(torch.from_numpy(wav[None, :n].astype(
            np.float32)).to(dev))
        gen_mel = loss_mel_fn(y_hat[None, :n])
        losses.append(float(torch.mean(torch.abs(gt_mel - gen_mel))))
        if sw is not None and idx < 3:
            sw.add_audio(f'generated/{name}',
                         np.clip(y_hat[:n].cpu().numpy(), -1, 1)[:, None],
                         step, sample_rate=SAMPLING_RATE)
    val_l1 = float(np.mean(losses))
    _logger.info(f'Validation mel L1 [{step}]: {val_l1:.4f}')
    if sw is not None:
        sw.add_scalar('validation/mel_l1', val_l1, step)
    return val_l1


def _save(output_dir, step, g_params_wn, mpd, msd):
    """``g_{step:08d}``: {'generator': plain params}; ``do_{step:08d}``:
    {'mpd', 'msd' (parameters), 'sn_state'} state dicts; both in the
    port's checkpoint format (``checkpoint.save_checkpoint``)."""
    ckpt.save_checkpoint(os.path.join(output_dir, f'g_{step:08d}'),
                         {'generator': _plain_detached(g_params_wn)},
                         iteration=step)
    sn = {'scale_0': {k: u.detach().clone()
                      for k, u in msd.sn_state()['scale_0'].items()}}
    ckpt.save_checkpoint(
        os.path.join(output_dir, f'do_{step:08d}'),
        {'mpd': mpd.state_dict(),
         'msd': {k: v for k, v in msd.state_dict().items()
                 if not k.endswith('.u')},
         'sn_state': sn}, iteration=step)
    _logger.info(f'saved vocoder checkpoints at step {step}')


def load_discriminators(path, device=None):
    """(mpd, msd) from a ``do_`` checkpoint, on ``device`` (default cuda)."""
    payload, _ = ckpt.load_checkpoint(path)
    state = payload['model']
    mpd, msd = init_mpd_params(device=device), init_msd_params(device=device)
    mpd.load_state_dict(state['mpd'], strict=True)
    msd_state = dict(state['msd'])
    for name, u in state['sn_state']['scale_0'].items():
        msd_state[f'scale_0.{name}.u'] = u
    msd.load_state_dict(msd_state, strict=True)
    return mpd, msd

"""HiFi-GAN discriminators (MPD + MSD) and the GAN losses (PyTorch port of
``daft_exprt_tpu/models/discriminators.py``).

The Multi-Period Discriminator runs over periods 2/3/5/7/11 (2-D strided
convs on period-folded audio), the Multi-Scale Discriminator over 3 scales
(the first spectral-normalised, the others weight-normalised); LSGAN
discriminator and generator losses and the x2 L1 feature-matching loss.

The training parameterisations are kept, as in the JAX package:

- weight norm as ``(g, v, b)`` parameters, folded at every forward to
  ``g * v / max(|v|, 1e-12)`` over every axis but the first
  (``torch.nn.utils.weight_norm`` has no clamp);
- spectral norm as ``(w, b)`` parameters and a power-iteration vector
  ``u`` per conv (a buffer: ``scale_0``'s, the only spectral scale). One
  power-iteration step runs inside the differentiated function: ``v``,
  the new ``u`` and ``sigma`` are functions of ``w``, so the gradient
  flows through them (``torch.nn.utils.spectral_norm`` detaches ``u`` and
  ``v`` and computes another gradient). :meth:`MultiScaleDiscriminator.
  forward` returns the new ``u`` undetached; the training step writes it
  to the buffers after its backward (:meth:`load_sn_state`).

``dtype`` (bf16 compute) casts the input and the folded weights; the
weight-norm fold, the power iteration and the inter-scale pooling stay
float32, and the losses cast to float32.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from daft_exprt_torch.device import resolve_device

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
_MSD_LAYERS = [
    # (cin, cout, k, stride, groups, pad)
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
]


def _lrelu(x):
    """The slope is a constant of x's dtype, as JAX's weakly typed 0.1."""
    return torch.where(x >= 0, x, x * x.new_tensor(LRELU_SLOPE))


def _init_conv(gen, shape):
    """torch's conv init (the JAX package's ``_init_conv``): w and b
    uniform in +-sqrt(3 / fan_in) and +-sqrt(1 / fan_in)."""
    fan_in = math.prod(shape[1:])
    bound = math.sqrt(1.0 / fan_in)

    def uniform(*s):
        return (torch.rand(s, generator=gen) * 2.0 - 1.0) * bound
    return uniform(*shape) * math.sqrt(3.0), uniform(shape[0])


def wn_weight(g, v):
    """The weight-norm fold: g * v / max(|v|, 1e-12), |v| over every axis
    but the first."""
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g * v / torch.clamp(norm, min=1e-12)


def sn_weight(w, u, update_u):
    """Spectral norm with one power-iteration step, differentiable in w.
    Returns (w / sigma, the u of the next call: the new one when
    ``update_u``, else ``u``)."""
    mat = w.reshape(w.shape[0], -1)
    v = mat.t() @ u
    v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
    u_new = mat @ v
    u_new = u_new / torch.clamp(torch.linalg.norm(u_new), min=1e-12)
    u_used = u_new if update_u else u
    sigma = u_used @ (mat @ v)
    return w / torch.clamp(sigma, min=1e-12), (u_new if update_u else u)


class WNConv(nn.Module):
    """A conv's weight-norm parameters ``g`` (out, 1, ...), ``v``, ``b``."""

    def __init__(self, shape, gen):
        super().__init__()
        w, b = _init_conv(gen, shape)
        norm = w.pow(2).sum(dim=tuple(range(1, w.ndim)), keepdim=True).sqrt()
        self.g, self.v, self.b = (nn.Parameter(norm), nn.Parameter(w),
                                  nn.Parameter(b))

    def weight(self):
        return wn_weight(self.g, self.v)


class SNConv(nn.Module):
    """A conv's spectral-norm parameters ``w``, ``b`` and its power-
    iteration buffer ``u`` (out,)."""

    def __init__(self, shape, gen):
        super().__init__()
        w, b = _init_conv(gen, shape)
        self.w, self.b = nn.Parameter(w), nn.Parameter(b)
        self.register_buffer('u', torch.randn(shape[0], generator=gen))


def _cast(t, dtype):
    return t if dtype is None else t.to(dtype)


class DiscriminatorP(nn.Module):
    def __init__(self, period, gen):
        super().__init__()
        self.period = period
        for i, (cin, cout) in enumerate(_MPD_CHANNELS):
            self.add_module(f'conv_{i}', WNConv((cout, cin, 5, 1), gen))
        self.conv_post = WNConv((1, 1024, 3, 1), gen)

    def forward(self, x, dtype=None):
        """x: (B, 1, T) -> (score (B, n), fmap list)."""
        x = _cast(x, dtype)
        b, c, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode='reflect')
            t = t + n_pad
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for i in range(len(_MPD_CHANNELS)):
            conv = getattr(self, f'conv_{i}')
            x = F.conv2d(x, _cast(conv.weight(), dtype),
                         stride=(3, 1) if i < 4 else (1, 1), padding=(2, 0))
            x = _lrelu(x + _cast(conv.b, dtype)[None, :, None, None])
            fmap.append(x)
        x = F.conv2d(x, _cast(self.conv_post.weight(), dtype),
                     padding=(1, 0)) \
            + _cast(self.conv_post.b, dtype)[None, :, None, None]
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Sub-discriminators ``period_{p}`` for p in :data:`MPD_PERIODS`."""

    def __init__(self, gen):
        super().__init__()
        for p in MPD_PERIODS:
            self.add_module(f'period_{p}', DiscriminatorP(p, gen))

    def forward(self, y, y_hat, dtype=None):
        """y, y_hat: (B, 1, T). Returns (real scores, generated scores, real
        fmaps, generated fmaps), lists over the periods."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for p in MPD_PERIODS:
            sub = getattr(self, f'period_{p}')
            s_r, f_r = sub(y, dtype)
            s_g, f_g = sub(y_hat, dtype)
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DiscriminatorS(nn.Module):
    def __init__(self, spectral, gen):
        super().__init__()
        self.spectral = spectral
        conv = SNConv if spectral else WNConv
        for i, (cin, cout, k, _st, groups, _pad) in enumerate(_MSD_LAYERS):
            self.add_module(f'conv_{i}', conv((cout, cin // groups, k), gen))
        self.conv_post = conv((1, 1024, 3), gen)

    def _names(self):
        return [f'conv_{i}' for i in range(len(_MSD_LAYERS))] + ['conv_post']

    def forward(self, x, u=None, update_sn=False, dtype=None):
        """x: (B, 1, T). ``u`` ({conv name: vector}, spectral scale only)
        is the power-iteration state to start from. Returns (score, fmap
        list, the next state: {} for a weight-norm scale)."""
        x = _cast(x, dtype)
        fmap, new_u = [], {}
        layers = _MSD_LAYERS + [(1024, 1, 3, 1, 1, 1)]
        for name, (_ci, _co, _k, stride, groups, pad) in zip(self._names(),
                                                            layers):
            conv = getattr(self, name)
            if self.spectral:
                w, new_u[name] = sn_weight(conv.w, u[name], update_sn)
            else:
                w = conv.weight()
            x = F.conv1d(x, _cast(w, dtype), stride=stride, padding=pad,
                         groups=groups) + _cast(conv.b, dtype)[None, :, None]
            if name != 'conv_post':
                x = _lrelu(x)
            fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap, new_u


def _avg_pool_4_2(x):
    """AvgPool1d(4, 2, padding=2), the padding counted."""
    return F.avg_pool1d(x, 4, 2, padding=2, count_include_pad=True)


class MultiScaleDiscriminator(nn.Module):
    """Sub-discriminators ``scale_0`` (spectral norm, buffers ``u``) and
    ``scale_1``, ``scale_2`` (weight norm)."""

    def __init__(self, gen):
        super().__init__()
        for s in range(3):
            self.add_module(f'scale_{s}', DiscriminatorS(s == 0, gen))

    def sn_state(self):
        """{'scale_0': {conv name: u}}: the buffers (the JAX ``sn_state``)."""
        sub = self.scale_0
        return {'scale_0': {n: getattr(sub, n).u for n in sub._names()}}

    @torch.no_grad()
    def load_sn_state(self, sn_state):
        """Write a state from :meth:`forward` (or :meth:`sn_state`) to the
        buffers, detached."""
        for name, u in sn_state['scale_0'].items():
            getattr(self.scale_0, name).u.copy_(u.detach())

    def forward(self, y, y_hat, update_sn=True, dtype=None):
        """Starting from the buffers' state, returns (real scores, generated
        scores, real fmaps, generated fmaps, the new sn_state, undetached).
        The pooling stays float32. The generated pass reuses the real
        pass's state (one power step a call), undetached as in the JAX
        package."""
        state = self.sn_state()
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        new_state = dict(state)
        for s in range(3):
            if s != 0:
                y, y_hat = _avg_pool_4_2(y), _avg_pool_4_2(y_hat)
            sub = getattr(self, f'scale_{s}')
            u = state.get(f'scale_{s}')
            s_r, f_r, u_r = sub(y, u, update_sn, dtype)
            s_g, f_g, _ = sub(y_hat, u_r if sub.spectral else None, False,
                              dtype)
            if sub.spectral:
                new_state[f'scale_{s}'] = u_r
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs, new_state


def init_mpd_params(seed=0, device=None):
    """A :class:`MultiPeriodDiscriminator` with torch's conv init, drawn
    from a CPU ``torch.Generator`` seeded with ``seed``, on ``device``
    (default cuda; raises without CUDA unless ``device='cpu'``)."""
    dev = resolve_device(device)
    return MultiPeriodDiscriminator(
        torch.Generator().manual_seed(int(seed))).to(dev)


def init_msd_params(seed=0, device=None):
    """A :class:`MultiScaleDiscriminator` (its ``u`` buffers standard
    normal), seeded as :func:`init_mpd_params`."""
    dev = resolve_device(device)
    return MultiScaleDiscriminator(
        torch.Generator().manual_seed(int(seed) + 1)).to(dev)


# ----------------------------------------------------------------------
# losses (LSGAN + feature matching), float32
# ----------------------------------------------------------------------

def discriminator_loss(real_outputs, generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r = torch.mean((1.0 - dr.float()) ** 2)
        g = torch.mean(dg.float() ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0

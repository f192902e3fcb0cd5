"""Plain float32 reference of HiFi-GAN fine-tuning's steps: the generator
in weight-norm form, the multi-period and multi-scale discriminators
(weight norm, and spectral norm with one differentiable power-iteration
step on the first scale), the LSGAN and feature-matching losses, the
full-band loss mel and AdamW. A frozen copy of the arithmetic of the
port's ``vocoder_finetune.py`` and ``models/discriminators.py``, written
as functions of parameter dicts; it imports nothing of the port.

Parameters: the generator's ``{path: tensor}`` with paths such as
``ups_0/g`` (weight norm ``g``, ``v``, ``b`` per conv), the
discriminators' ``{name: tensor}`` with the port's module names
(``period_2.conv_0.v``, ``scale_0.conv_0.w``, ...) and the power-iteration
vectors ``scale_0.<conv>.u``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _sibling(name):
    spec = importlib.util.spec_from_file_location(
        f'portbench_reference_{name}', Path(__file__).with_name(f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


generator = _sibling('generator').generator

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
MSD_LAYERS = [(1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20),
              (128, 256, 41, 2, 16, 20), (256, 512, 41, 4, 16, 20),
              (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
              (1024, 1024, 5, 1, 1, 2)]
SR, N_FFT, HOP, N_MELS = 22050, 1024, 256, 80


def lrelu(x):
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def wn(g, v):
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g * v / torch.clamp(norm, min=1e-12)


def fold_generator(gp):
    """{'ups_0/g': ..} -> the generator's nested plain {'ups_0': {'w', 'b'}}."""
    out = {}
    for path in {p.rsplit('/', 1)[0] for p in gp}:
        leaf = {'w': wn(gp[f'{path}/g'], gp[f'{path}/v']), 'b': gp[f'{path}/b']}
        node = out
        parts = path.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return out


# ---- the loss mel (full band) and the generator's input mel ------------

def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    fsp, brk, q = 200.0 / 3.0, 1000.0, np.log(6.4) / 27.0
    return np.where(f >= brk, brk / fsp + np.log(np.maximum(f, 1e-10) / brk)
                    / q, f / fsp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    fsp, brk, q = 200.0 / 3.0, 1000.0, np.log(6.4) / 27.0
    return np.where(m >= brk / fsp, brk * np.exp(q * (m - brk / fsp)),
                    m * fsp)


def mel_filterbank(sr, n_fft, n_mels, fmin, fmax):
    """Slaney triangular filters with area normalisation (n_mels, bins)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


class LogMel:
    """wav (B, N) -> (B, n_mels, frames) log-mel: reflect padding of
    (n_fft - hop) / 2, periodic Hann, magnitude sqrt(re^2 + im^2 + 1e-9),
    mel projection, log of max(., 1e-5)."""

    def __init__(self, device, fmax=None, n_mels=N_MELS):
        t = np.arange(N_FFT)[:, None].astype(np.float64)
        k = np.arange(1 + N_FFT // 2)[None, :].astype(np.float64)
        win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
        ph = 2.0 * np.pi * t * k / N_FFT
        self.br = torch.from_numpy((np.cos(ph) * win[:, None]).astype(
            np.float32)).to(device)
        self.bi = torch.from_numpy((-np.sin(ph) * win[:, None]).astype(
            np.float32)).to(device)
        self.fb = torch.from_numpy(np.ascontiguousarray(mel_filterbank(
            SR, N_FFT, n_mels, 0, fmax or SR / 2).T)).to(device)

    def __call__(self, wav):
        pad = (N_FFT - HOP) // 2
        x = F.pad(wav[:, None], (pad, pad), mode='reflect')[:, 0]
        fr = x.unfold(1, N_FFT, HOP)
        re, im = fr @ self.br, fr @ self.bi
        mel = torch.sqrt(re * re + im * im + 1e-9) @ self.fb
        return torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)


# ---- discriminators ------------------------------------------------------

def mpd(dp, x):
    """Scores and feature maps of every period for x (B, 1, T)."""
    scores, fmaps = [], []
    for p in MPD_PERIODS:
        pre = f'period_{p}'
        b, c, t = x.shape
        h = x
        if t % p:
            h = F.pad(h, (0, p - t % p), mode='reflect')
        h = h.reshape(b, c, h.shape[-1] // p, p)
        fm = []
        for i in range(len(MPD_CHANNELS)):
            w = wn(dp[f'{pre}.conv_{i}.g'], dp[f'{pre}.conv_{i}.v'])
            h = F.conv2d(h, w, stride=(3, 1) if i < 4 else (1, 1),
                         padding=(2, 0))
            h = lrelu(h + dp[f'{pre}.conv_{i}.b'][None, :, None, None])
            fm.append(h)
        w = wn(dp[f'{pre}.conv_post.g'], dp[f'{pre}.conv_post.v'])
        h = F.conv2d(h, w, padding=(1, 0)) + \
            dp[f'{pre}.conv_post.b'][None, :, None, None]
        fm.append(h)
        scores.append(h.reshape(b, -1))
        fmaps.append(fm)
    return scores, fmaps


def _sn(w, u, update):
    mat = w.reshape(w.shape[0], -1)
    v = mat.t() @ u
    v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
    u_new = mat @ v
    u_new = u_new / torch.clamp(torch.linalg.norm(u_new), min=1e-12)
    u_used = u_new if update else u
    sigma = u_used @ (mat @ v)
    return w / torch.clamp(sigma, min=1e-12), (u_new if update else u)


def _scale(dp, s, x, u, update):
    names = [f'conv_{i}' for i in range(len(MSD_LAYERS))] + ['conv_post']
    layers = MSD_LAYERS + [(1024, 1, 3, 1, 1, 1)]
    fm, new_u = [], {}
    for name, (_ci, _co, _k, stride, groups, pad) in zip(names, layers):
        pre = f'scale_{s}.{name}'
        if s == 0:
            w, new_u[name] = _sn(dp[f'{pre}.w'], u[name], update)
        else:
            w = wn(dp[f'{pre}.g'], dp[f'{pre}.v'])
        x = F.conv1d(x, w, stride=stride, padding=pad, groups=groups) + \
            dp[f'{pre}.b'][None, :, None]
        if name != 'conv_post':
            x = lrelu(x)
        fm.append(x)
    return x.reshape(x.shape[0], -1), fm, new_u


def msd(dp, u, y, y_hat, update):
    """(real scores, generated scores, real fmaps, generated fmaps, the
    power-iteration vectors after the call)."""
    rs, gs, frs, fgs = [], [], [], []
    new_u = u
    for s in range(3):
        if s:
            y = F.avg_pool1d(y, 4, 2, padding=2, count_include_pad=True)
            y_hat = F.avg_pool1d(y_hat, 4, 2, padding=2,
                                 count_include_pad=True)
        s_r, f_r, u_r = _scale(dp, s, y, u if s == 0 else None, update)
        s_g, f_g, _ = _scale(dp, s, y_hat, u_r if s == 0 else None, False)
        if s == 0:
            new_u = u_r
        rs.append(s_r)
        gs.append(s_g)
        frs.append(f_r)
        fgs.append(f_g)
    return rs, gs, frs, fgs, new_u


def d_loss(real, gen):
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2)
               for r, g in zip(real, gen))


def g_adv(gen):
    return sum(torch.mean((1.0 - g) ** 2) for g in gen)


def fm_loss(fr, fg):
    return 2.0 * sum(torch.mean(torch.abs(a - b))
                     for dr, dg in zip(fr, fg) for a, b in zip(dr, dg))


class Trainer:
    """The reference's GAN training from float32 initial parameters:
    ``step(mel, y)`` runs a discriminator then a generator update and
    returns (d_loss, g_loss); AdamW as configured. ``alter`` (a planted
    fault) is applied to every generated waveform."""

    def __init__(self, gp, dp, u, cfg, opt, device, alter=None):
        self.cfg = cfg
        self.alter = alter or (lambda wav: wav)
        self.gp = {k: v.detach().clone().float().requires_grad_(True)
                   for k, v in gp.items()}
        self.dp = {k: v.detach().clone().float().requires_grad_(True)
                   for k, v in dp.items()}
        self.u = {k: v.detach().clone().float() for k, v in u.items()}
        kw = dict(lr=opt['lr'], betas=tuple(opt['betas']), eps=opt['eps'],
                  weight_decay=opt['weight_decay'], foreach=False)
        self.g_opt = torch.optim.AdamW(list(self.gp.values()), **kw)
        self.d_opt = torch.optim.AdamW(list(self.dp.values()), **kw)
        self.loss_mel = LogMel(device)

    def wav(self, mel):
        return self.alter(generator(fold_generator(self.gp), mel,
                                    self.cfg)[:, None])

    def step(self, mel, y):
        with torch.no_grad():
            y_hat = self.wav(mel)
        r, _ = mpd(self.dp, y)
        g, _ = mpd(self.dp, y_hat)
        rs, gs, _, _, new_u = msd(self.dp, self.u, y, y_hat, True)
        loss_d = d_loss(r, g) + d_loss(rs, gs)
        self.d_opt.zero_grad(set_to_none=True)
        loss_d.backward()
        self.d_grads = {k: v.grad.detach().clone() for k, v in self.dp.items()}
        self.d_opt.step()
        self.u = {k: v.detach() for k, v in new_u.items()}

        y_mel = self.loss_mel(y[:, 0])
        y_hat = self.wav(mel)
        loss_mel = torch.mean(torch.abs(y_mel - self.loss_mel(y_hat[:, 0]))) \
            * 45.0
        dp = {k: v.detach() for k, v in self.dp.items()}
        s_r, f_r = mpd(dp, y)
        s_g, f_g = mpd(dp, y_hat)
        ms_r, ms_g, mf_r, mf_g, _ = msd(dp, self.u, y, y_hat, False)
        total = g_adv(s_g) + g_adv(ms_g) + fm_loss(f_r, f_g) + \
            fm_loss(mf_r, mf_g) + loss_mel
        self.g_opt.zero_grad(set_to_none=True)
        total.backward()
        self.g_grads = {k: v.grad.detach().clone() for k, v in self.gp.items()}
        self.g_opt.step()
        return float(loss_d.detach()), float(total.detach())


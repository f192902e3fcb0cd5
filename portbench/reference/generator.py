"""Plain float32 reference of the HiFi-GAN generator (jik876/hifi-gan
``Generator`` with weight norm folded), in plain PyTorch convolutions: a
frozen copy of the arithmetic of the port's plain route
(``models/hifigan.py``, ``use_fast=False``). It imports nothing of the
port. Parameters are a dict ``{'conv_pre': {'w', 'b'}, 'ups_{i}': ...,
'resblock_{i}_{j}': {'convs1_{l}': ..., 'convs2_{l}': ...},
'conv_post': ...}`` with torch's weight layouts.

``q`` (optional) is applied to both operands of every resblock and
upsampling convolution, the ones the fused MRF kernels compute: the
control computes them in a lower precision with it.
"""
import math

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
MEL_FLOOR = math.log(1e-5)       # the value the serving tiers pad mels with


def _id(t, axis=None):
    return t


def lrelu(x):
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def conv1d(x, p, dilation=1, q=_id):
    w = p['w'].float()
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(q(x, 1), q(w, 0), padding=pad, dilation=dilation) + \
        p['b'].float()[None, :, None]


def generator(params, mel, cfg, q=None):
    """mel (B, n_mels, T) float32 -> waveform (B, T * hop) float32."""
    q = q or _id
    n_k = len(cfg['resblock_kernel_sizes'])
    x = conv1d(mel, params['conv_pre'])
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        ups = params[f'ups_{i}']
        x = F.conv_transpose1d(q(lrelu(x), 1), q(ups['w'].float(), 1),
                               stride=u, padding=(k - u) // 2) + \
            ups['b'].float()[None, :, None]
        xs = None
        for j, dils in enumerate(cfg['resblock_dilation_sizes']):
            rb = params[f'resblock_{i}_{j}']
            y = x
            for l, d in enumerate(dils):
                if cfg['resblock'] == '1':
                    t = conv1d(lrelu(y), rb[f'convs1_{l}'], d, q)
                    t = conv1d(lrelu(t), rb[f'convs2_{l}'], 1, q)
                else:
                    t = conv1d(lrelu(y), rb[f'convs_{l}'], d, q)
                y = t + y
            xs = y if xs is None else xs + y
        x = xs / n_k
    x = conv1d(lrelu(x), params['conv_post'])
    return torch.tanh(x)[:, 0]


def serve(params, mel, cfg, pad_to=128, q=None):
    """The waveform a serving tier returns for ``mel``: the mel padded to
    a multiple of ``pad_to`` frames with the mel floor, the waveform
    cropped to the mel's frames and clipped to [-1, 1]."""
    T0 = mel.shape[-1]
    hop = math.prod(cfg['upsample_rates'])
    if pad_to:
        t_pad = -(-T0 // pad_to) * pad_to
        mel = F.pad(mel, (0, t_pad - T0), value=MEL_FLOOR)
    return generator(params, mel, cfg, q)[:, :T0 * hop].clamp(-1.0, 1.0)

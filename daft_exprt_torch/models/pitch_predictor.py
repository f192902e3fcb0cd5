"""Mel -> frame-level pitch CNN (PyTorch port of
``daft_exprt_tpu/models/pitch_predictor.py``), used frozen by the
pitch-consistency loss and trained by ``scripts/train_pitch_predictor.py``.

Four convs 80 -> 256 -> 256 -> 256 -> 1 (k=3, SAME padding), ReLU,
BatchNorm and dropout between them; float32. In eval mode (``frozen()``,
the loss's use) BatchNorm reads its running averages and dropout is off.
In training mode BatchNorm normalises with the batch's statistics and
updates its running averages as flax's ``BatchNorm(momentum=0.9)`` does,
and dropout draws its masks from the caller's ``torch.Generator``. Names
follow flax: ``conv_{i}``, ``bn_{i}``, ``conv_out``.
"""
import math

import torch
import torch.nn as nn

from daft_exprt_torch.models.modules import Conv1d, dropout

# flax BatchNorm's default: running = MOMENTUM * running + (1 - MOMENTUM) * batch
MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last axis, (x - mean) * (rsqrt(var +
    eps) * scale) + bias. Eval mode: the running averages. Training mode:
    the batch's mean and biased variance over every other axis (var =
    mean(x^2) - mean(x)^2, at least 0, padded frames included, as flax
    computes them), and the running averages move to MOMENTUM * running +
    (1 - MOMENTUM) * batch (``torch.nn.BatchNorm1d`` keeps the unbiased
    variance and reads its momentum the other way round)."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = torch.clamp(x.square().mean(axes) - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(
                    (1.0 - MOMENTUM) * mean.detach())
                self.running_var.mul_(MOMENTUM).add_(
                    (1.0 - MOMENTUM) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class PitchPredictor(nn.Module):

    def __init__(self, n_mel_channels=80, hidden_dim=256, kernel_size=3,
                 dropout=0.1):
        super().__init__()
        self.dropout = dropout
        dims = (n_mel_channels, hidden_dim, hidden_dim, hidden_dim)
        for i in range(3):
            self.add_module(f'conv_{i}', Conv1d(dims[i], dims[i + 1],
                                                kernel_size))
            self.add_module(f'bn_{i}', BatchNorm(dims[i + 1]))
        self.conv_out = Conv1d(hidden_dim, 1, kernel_size)

    def forward(self, mel_specs, generator=None):
        """mel_specs: (B, n_mels, T) -> (B, T) predicted log-pitch. In
        training mode with dropout > 0, ``generator`` (a torch.Generator on
        the input's device) draws the dropout masks."""
        x = mel_specs.float().transpose(1, 2)             # (B, T, n_mels)
        for i in range(3):
            x = torch.relu(getattr(self, f'conv_{i}')(x))
            x = getattr(self, f'bn_{i}')(x)
            if self.training and self.dropout > 0:
                x = dropout(x, self.dropout, generator)
        return self.conv_out(x)[..., 0]

    @torch.no_grad()
    def init_random_(self, seed):
        """Seeded parameters as flax initialises them: conv kernels LeCun
        normal (truncated at two standard deviations, fan-in scaled),
        biases 0, BatchNorm scale 1, bias 0, running mean 0 and variance 1
        (CPU ``torch.Generator``)."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            mod, leaf = name.rsplit('.', 1)
            if mod.startswith('bn_'):
                p.fill_(1.0 if leaf == 'weight' else 0.0)
            elif leaf == 'bias':
                p.zero_()
            else:
                # flax's truncated normal: unit variance after truncation
                std = 1.0 / math.sqrt(p[0].numel()) / .87962566103423978
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_((w * std).to(p.device))
        for name, b in self.named_buffers():
            b.fill_(0.0 if name.endswith('running_mean') else 1.0)
        return self

    def frozen(self):
        """In eval mode with every parameter's gradient off: gradients still
        flow through it to its input."""
        self.requires_grad_(False)
        return self.eval()

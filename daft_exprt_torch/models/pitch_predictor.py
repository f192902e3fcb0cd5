"""Mel -> frame-level pitch CNN, used frozen by the pitch-consistency loss
(PyTorch port of ``daft_exprt_tpu/models/pitch_predictor.py``).

Four convs 80 -> 256 -> 256 -> 256 -> 1 (k=3, SAME padding), ReLU and
BatchNorm with its running averages between them; float32; dropout off
(the loss runs it deterministically). Names follow flax: ``conv_{i}``,
``bn_{i}``, ``conv_out``.
"""
import torch
import torch.nn as nn

from daft_exprt_torch.models.modules import Conv1d


class FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True)`` over the last axis:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class PitchPredictor(nn.Module):

    def __init__(self, n_mel_channels=80, hidden_dim=256, kernel_size=3):
        super().__init__()
        dims = (n_mel_channels, hidden_dim, hidden_dim, hidden_dim)
        for i in range(3):
            self.add_module(f'conv_{i}', Conv1d(dims[i], dims[i + 1],
                                                kernel_size))
            self.add_module(f'bn_{i}', FrozenBatchNorm(dims[i + 1]))
        self.conv_out = Conv1d(hidden_dim, 1, kernel_size)

    def forward(self, mel_specs):
        """mel_specs: (B, n_mels, T) -> (B, T) predicted log-pitch."""
        x = mel_specs.float().transpose(1, 2)             # (B, T, n_mels)
        for i in range(3):
            x = torch.relu(getattr(self, f'conv_{i}')(x))
            x = getattr(self, f'bn_{i}')(x)
        return self.conv_out(x)[..., 0]

    def frozen(self):
        """In eval mode with every parameter's gradient off: gradients still
        flow through it to its input."""
        self.requires_grad_(False)
        return self.eval()

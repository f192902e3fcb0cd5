"""Shared neural building blocks (PyTorch port of
``daft_exprt_tpu/models/modules.py``).

Module and parameter names mirror the flax names (``linear_layer``,
``conv``, ``in_proj``, ``layer_norm``, ...), so a JAX parameter tree maps
onto a state dict mechanically (see ``bridge.py``). Parameters are float32;
each layer takes the compute dtype like flax's ``dtype=``: inputs and
parameters are cast to it, while LayerNorm statistics, FiLM and the
Gaussian upsampling stay float32, as in the JAX package.

Training mode (``module.train()``) applies dropout where the JAX package
does: on the attention weights (inside the attention kernel), after the
attention's output projection (``resid_drop``) and after the feed-forward's
second conv (``drop``). Masks come from the explicit ``torch.Generator``
passed down the forward; each attention call draws its 32-bit dropout seed
from it first. In eval mode (``inference``) nothing is drawn.
"""
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from daft_exprt_torch.ops.attention_kernels import (
    attention_plain, fused_attention,
)


def _need_generator(generator):
    if generator is None:
        raise ValueError('training-mode dropout needs an explicit '
                         'torch.Generator (generator=...)')


def dropout(x, p, generator):
    """flax ``nn.Dropout``: keep with probability 1 - p (mask drawn from
    ``generator``), kept values divided by 1 - p in x's dtype."""
    _need_generator(generator)
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def sequence_mask(lengths, max_len):
    """(B,) lengths -> (B, max_len) bool validity mask (True = valid)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < \
        lengths[:, None]


def sinusoidal_table(max_len, embed_dim, timestep=10000.0):
    """Sinusoidal position table (max_len, embed_dim), float32: even
    columns sin, odd columns cos, frequencies exp(-2i ln(T)/d)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, embed_dim, 2, dtype=np.float64)
                 * (-np.log(timestep) / embed_dim))[None, :]
    table = np.zeros((max_len, embed_dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table.astype(np.float32))


class PositionTable(nn.Module):
    """The first ``L`` rows of the sinusoidal table, as a non-persistent
    buffer of ``max_len`` rows (grown on demand)."""

    def __init__(self, embed_dim, max_len=5000):
        super().__init__()
        self.embed_dim = embed_dim
        self.register_buffer('table', sinusoidal_table(max_len, embed_dim),
                             persistent=False)

    def forward(self, length):
        if length > self.table.shape[0]:
            self.table = sinusoidal_table(length, self.embed_dim).to(
                self.table.device)
        return self.table[:length]


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ W + b in the compute dtype; weight stored
    (out, in) as torch's Linear."""

    def __init__(self, in_features, out_features, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias \
            else None

    def forward(self, x, dtype=torch.float32):
        y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over (B, L, C) with SAME padding (odd kernels);
    weight stored (out, in, k) as torch's Conv1d."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1,
                 use_bias=True):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError('SAME padding is implemented for odd kernels')
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias \
            else None

    def forward(self, x, dtype=torch.float32):
        k = self.weight.shape[-1]
        y = F.conv1d(x.to(dtype).transpose(1, 2), self.weight.to(dtype),
                     padding=self.dilation * (k - 1) // 2,
                     dilation=self.dilation).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class LayerNorm(nn.Module):
    """flax LayerNorm numerics in float32: var = max(E[x^2] - E[x]^2, 0),
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + \
            self.bias


class LinearNorm(nn.Module):
    """Dense layer (reference LinearNorm)."""

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_layer = Dense(in_features, out_features, use_bias)

    def forward(self, x):
        return self.linear_layer(x, self.dtype)


class ConvNorm1D(nn.Module):
    """1D convolution over (B, L, C) with SAME padding."""

    def __init__(self, in_channels, out_channels, kernel_size=1, dilation=1,
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation,
                           use_bias)

    def forward(self, x):
        return self.conv(x, self.dtype)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention + dropout + residual + LayerNorm.

    ``fused`` routes the attention core through ``fused_attention``
    (the CUDA kernels on a CUDA tensor); otherwise the plain branch,
    differentiated by autograd. Both apply the same Philox weight mask."""

    def __init__(self, embed_dim, num_heads, dtype=torch.float32,
                 fused=False, dropout=0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype, self.fused, self.dropout = dtype, fused, dropout
        self.in_proj = Dense(embed_dim, 3 * embed_dim)
        self.out_proj = Dense(embed_dim, embed_dim)
        self.layer_norm = LayerNorm(embed_dim)

    def forward(self, x, valid_mask, generator=None):
        d, h = self.embed_dim, self.num_heads
        hd = d // h
        qkv = self.in_proj(x, self.dtype)
        q, k, v = torch.split(qkv, d, dim=-1)
        b, l, _ = x.shape

        def split_heads(t):                              # (B,L,d)->(B,h,L,hd)
            return t.reshape(b, l, h, hd).permute(0, 2, 1, 3)

        q = split_heads(q) * hd ** -0.5
        k, v = split_heads(k), split_heads(v)
        lengths = valid_mask.sum(dim=1, dtype=torch.int32)
        drop = self.training and self.dropout > 0
        seed, p = 0, 0.0
        if drop:
            _need_generator(generator)
            seed = torch.randint(0, 2 ** 32, (1,), generator=generator,
                                 device=generator.device)
            p = float(self.dropout)
        attend = fused_attention if self.fused else attention_plain
        out = attend(q.contiguous(), k.contiguous(), v.contiguous(), lengths,
                     seed, p)
        out = out.permute(0, 2, 1, 3).reshape(b, l, d)
        out = self.out_proj(out, self.dtype)
        if drop:
            out = dropout(out, self.dropout, generator)
        return self.layer_norm(out + x).to(self.dtype)


class PositionWiseConvFF(nn.Module):
    """Two convs + ReLU + residual + LN + FiLM. ``strict_masking`` re-masks
    the hidden activation between the convs (padding-invariant); False
    reproduces the reference's ragged-batch leak."""

    def __init__(self, embed_dim, conv_channels, kernel_size,
                 strict_masking=True, dtype=torch.float32, dropout=0.0):
        super().__init__()
        self.embed_dim, self.strict_masking, self.dtype = \
            embed_dim, strict_masking, dtype
        self.dropout = dropout
        self.conv1 = ConvNorm1D(embed_dim, conv_channels, kernel_size,
                                dtype=dtype)
        self.conv2 = ConvNorm1D(conv_channels, embed_dim, kernel_size,
                                dtype=dtype)
        self.layer_norm = LayerNorm(embed_dim)

    def forward(self, x, film_params, valid_mask=None, generator=None):
        y = torch.relu(self.conv1(x))
        if self.strict_masking and valid_mask is not None:
            y = torch.where(valid_mask[..., None], y, torch.zeros_like(y))
        y = self.conv2(y)
        if self.training and self.dropout > 0:
            y = dropout(y, self.dropout, generator)
        y = self.layer_norm(y + x)
        if film_params is not None:
            gammas = film_params[:, None, :self.embed_dim]
            betas = film_params[:, None, self.embed_dim:]
            y = gammas * y + betas
        return y.to(self.dtype)


class FFTBlock(nn.Module):
    """Attention + conv feed-forward with FiLM + masking."""

    def __init__(self, embed_dim, num_heads, conv_channels, conv_kernel,
                 strict_masking=True, dtype=torch.float32,
                 fused_attention=False, attn_dropout=0.0, conv_dropout=0.0):
        super().__init__()
        self.attention = MultiHeadSelfAttention(embed_dim, num_heads, dtype,
                                                fused_attention, attn_dropout)
        self.feed_forward = PositionWiseConvFF(
            embed_dim, conv_channels, conv_kernel, strict_masking, dtype,
            conv_dropout)

    def forward(self, x, film_params, valid_mask, generator=None):
        y = self.attention(x, valid_mask, generator)
        y = torch.where(valid_mask[..., None], y, torch.zeros_like(y))
        y = self.feed_forward(y, film_params, valid_mask, generator)
        return torch.where(valid_mask[..., None], y, torch.zeros_like(y))

"""Plain float32 reference of the Daft-Exprt acoustic model's synthesis
forward (``inference``), in plain PyTorch: a frozen copy of the
arithmetic of the port's ``models/daft_exprt.py`` and ``models/modules.py``
written as functions of a state dict, with the attention as softmax over
masked scores and no kernel. It imports nothing of the port.

``q`` (optional) is applied to both operands of every projection and
convolution: the control computes them in a lower precision with it.
Every layer computes in float32 (TF32 off is the caller's to set).
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

_LOG_2PI = float(np.log(2.0 * np.pi))


def _id(t):
    return t


def sinusoidal_table(max_len, embed_dim, timestep=10000.0):
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, embed_dim, 2, dtype=np.float64)
                 * (-np.log(timestep) / embed_dim))[None, :]
    table = np.zeros((max_len, embed_dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table.astype(np.float32))


class Acoustic:
    """The model's synthesis forward from its float32 state dict ``sd``
    (parameter names as the port's ``DaftExprt``) and its hparams'
    block configurations."""

    def __init__(self, sd, acfg, q=None):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.acfg = acfg
        self.q = q or _id

    def dense(self, x, name, bias=True):
        w = self.sd[f'{name}.weight']
        y = torch.matmul(self.q(x), self.q(w).t())
        return y + self.sd[f'{name}.bias'] if bias else y

    def conv(self, x, name, dilation=1):
        """SAME conv over (B, L, C)."""
        w = self.sd[f'{name}.weight']
        k = w.shape[-1]
        y = F.conv1d(self.q(x).transpose(1, 2), self.q(w),
                     padding=dilation * (k - 1) // 2,
                     dilation=dilation).transpose(1, 2)
        return y + self.sd[f'{name}.bias']

    def layer_norm(self, x, name, eps=1e-5):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + eps)
                             * self.sd[f'{name}.weight']) + \
            self.sd[f'{name}.bias']

    def attention(self, x, mask, name, heads):
        b, l, d = x.shape
        hd = d // heads
        qkv = self.dense(x, f'{name}.in_proj')
        q, k, v = torch.split(qkv, d, dim=-1)

        def split(t):
            return t.reshape(b, l, heads, hd).permute(0, 2, 1, 3)

        q, k, v = split(q) * hd ** -0.5, split(k), split(v)
        s = torch.matmul(q, k.transpose(-1, -2))
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e9))
        out = torch.matmul(torch.softmax(s, dim=-1), v)
        out = out.permute(0, 2, 1, 3).reshape(b, l, d)
        out = self.dense(out, f'{name}.out_proj')
        return self.layer_norm(out + x, f'{name}.layer_norm')

    def block(self, x, film, mask, name, heads, d):
        m = mask[..., None]
        y = self.attention(x, mask, f'{name}.attention', heads)
        y = torch.where(m, y, torch.zeros_like(y))
        h = torch.relu(self.conv(y, f'{name}.feed_forward.conv1.conv'))
        h = torch.where(m, h, torch.zeros_like(h))
        h = self.conv(h, f'{name}.feed_forward.conv2.conv')
        h = self.layer_norm(h + y, f'{name}.feed_forward.layer_norm')
        if film is not None:
            h = film[:, None, :d] * h + film[:, None, d:]
        return torch.where(m, h, torch.zeros_like(h))

    def width(self, cfg):
        """A block stack's width: the frame decoder's is the phoneme
        encoder's (no ``frame_decoder_input_dim``)."""
        return cfg.get('hidden_embed_dim',
                       self.acfg['phoneme_encoder']['hidden_embed_dim'])

    def blocks(self, x, film, mask, prefix, cfg):
        for i in range(cfg['nb_blocks']):
            x = self.block(x, film[:, i, :], mask, f'{prefix}.block_{i}',
                           cfg['attn_nb_heads'], self.width(cfg))
        return x

    def style(self, emb):
        enc, dec = self.acfg['phoneme_encoder'], self.acfg['frame_decoder']
        gam = self.dense(emb, 'style_adapter.gammas_predictor.linear_layer')
        bet = self.dense(emb, 'style_adapter.betas_predictor.linear_layer')
        post = self.sd.get('style_adapter.post_multipliers')
        film, col, blk = {}, 0, 0
        for key, cfg in (('phoneme_encoder', enc), ('frame_decoder', dec)):
            nb, c = cfg['nb_blocks'], self.width(cfg)
            g = gam[:, col:col + nb * c].reshape(-1, nb, c)
            b = bet[:, col:col + nb * c].reshape(-1, nb, c)
            if post is not None:
                g = post[0, blk:blk + nb][None, :, None] * g + 1.0
                b = post[1, blk:blk + nb][None, :, None] * b
            else:
                g = g + 1.0
            film[key] = torch.cat([g, b], dim=2)
            blk += nb
            col += nb * c
        return film

    def infer(self, symbols, duration_preds, durations_int, energy_preds,
              pitch_preds, input_lengths, output_lengths, n_frames,
              spk_embs, accent_emb):
        """(B, n_mels, n_frames) float32 mel, zero past each length."""
        sd = self.sd
        enc_cfg = self.acfg['phoneme_encoder']
        d = enc_cfg['hidden_embed_dim']
        norm = torch.linalg.norm(spk_embs, dim=-1, keepdim=True)
        spk = self.dense(spk_embs / torch.clamp(norm, min=1e-12),
                         'spk_projection.linear_layer')
        film = self.style(accent_emb + spk)
        B, L = symbols.shape
        in_mask = torch.arange(L, device=symbols.device)[None] < \
            input_lengths[:, None]
        x = sd['phoneme_encoder.symbols_embedding.weight'][symbols]
        pos = sinusoidal_table(max(L, n_frames), d).to(x.device)
        x = torch.where(in_mask[..., None], x + pos[:L][None],
                        torch.zeros_like(x))
        x = self.blocks(x, film['phoneme_encoder'], in_mask,
                        'phoneme_encoder', enc_cfg)

        # gaussian upsampling
        gu = 'gaussian_upsampling'
        durs = self.conv(duration_preds[..., None],
                         f'{gu}.duration_projection.conv')
        nrg = self.conv(energy_preds[..., None], f'{gu}.energy_projection.conv')
        f0 = self.conv(pitch_preds[..., None], f'{gu}.pitch_projection.conv')
        x = x + nrg + f0
        ranges = self.dense(x + durs, f'{gu}.range_projection.linear_layer')
        ranges = torch.logaddexp(ranges, torch.zeros_like(ranges))[..., 0]
        ranges = torch.where(in_mask, ranges, torch.ones_like(ranges))
        stds = torch.clamp(ranges, min=1e-3)
        dur_i = durations_int.float()
        cums = torch.cumsum(dur_i, dim=1)
        means = dur_i / 2.0 + F.pad(cums[:, :-1], (1, 0))
        t = torch.arange(n_frames, dtype=torch.float32,
                         device=x.device) + 0.5
        z = (t[None, None, :] - means[..., None]) / stds[..., None]
        probs = torch.exp(-0.5 * z * z - torch.log(stds)[..., None]
                          - 0.5 * _LOG_2PI)
        probs = torch.where(in_mask[..., None], probs, torch.zeros_like(probs))
        weights = probs / (probs.sum(dim=1, keepdim=True) + 1e-20)
        x = torch.einsum('blt,bld->btd', weights, x)

        # frame decoder
        dec_cfg = self.acfg['frame_decoder']
        out_mask = torch.arange(n_frames, device=x.device)[None] < \
            output_lengths[:, None]
        x = torch.where(out_mask[..., None], x + pos[:n_frames][None],
                        torch.zeros_like(x))
        x = self.blocks(x, film['frame_decoder'], out_mask, 'frame_decoder',
                        dec_cfg)
        mel = self.dense(x, 'frame_decoder.projection.linear_layer')
        mel = torch.where(out_mask[..., None], mel, torch.zeros_like(mel))
        return mel.transpose(1, 2)


def round_to_bucket(value, buckets):
    """The smallest bucket that holds ``value``, past the last one a
    multiple of the last stride (the synthesis entry point's padding)."""
    for b in buckets:
        if value <= b:
            return b
    stride = buckets[-1] - buckets[-2] if len(buckets) > 1 else buckets[-1]
    return buckets[-1] + math.ceil((value - buckets[-1]) / stride) * stride

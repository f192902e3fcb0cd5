"""DaftExprt acoustic model (PyTorch port of
``daft_exprt_tpu/models/daft_exprt.py``): ``PhonemeEncoder``,
``AccentEncoder``, ``SpeakerClassifier`` behind gradient reversal,
``StyleAdapter``, ``GaussianUpsampling`` (with the factored backward of
``_normalize_weights``), ``FrameDecoder``, and ``DaftExprt`` with its
training forward, ``encode_accent`` and ``inference``.

In training mode (``model.train()``) the forward applies the JAX package's
dropouts, with masks drawn from the ``generator`` it is given (see
``modules.py``); ``inference`` runs in eval mode and draws nothing.
"""
import numpy as np
import torch
import torch.nn as nn

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.models.modules import (
    ConvNorm1D, FFTBlock, LayerNorm, LinearNorm, PositionTable, dropout,
    sequence_mask,
)
from daft_exprt_torch.ops.grl import gradient_reversal

_LOG_2PI = float(np.log(2.0 * np.pi))


class _NormalizeWeights(torch.autograd.Function):
    """probs / (sum_L probs + 1e-20) with the JAX package's factored
    backward ``inv * (g - sum_L g * y)``: autograd of the division forms
    1 / (S + 1e-20)**2, which overflows float32 at frames where no gaussian
    has mass (S = 0) and turns every upstream gradient into NaN."""

    @staticmethod
    def forward(ctx, probs):
        denom = torch.sum(probs, dim=1, keepdim=True) + 1e-20
        y = probs / denom
        ctx.save_for_backward(y, 1.0 / denom)
        return y

    @staticmethod
    def backward(ctx, g):
        y, inv = ctx.saved_tensors
        return inv * (g - torch.sum(g * y, dim=1, keepdim=True))


def _normalize_weights(probs):
    return _NormalizeWeights.apply(probs)


class _Blocks(nn.Module):
    """Holds FFT blocks under the flax names ``block_{i}``."""

    def __init__(self, cfg, embed_dim, strict, dtype):
        super().__init__()
        self.n_blocks = cfg['nb_blocks']
        for i in range(self.n_blocks):
            self.add_module(f'block_{i}', FFTBlock(
                embed_dim, cfg['attn_nb_heads'], cfg['conv_channels'],
                cfg['conv_kernel'], strict_masking=strict, dtype=dtype,
                fused_attention=cfg.get('fused_attention', False),
                attn_dropout=cfg.get('attn_dropout', 0.0),
                conv_dropout=cfg.get('conv_dropout', 0.0)))

    def run_blocks(self, x, film_params, mask, generator=None):
        for i in range(self.n_blocks):
            fp = film_params[:, i, :] if film_params is not None else None
            x = getattr(self, f'block_{i}')(x, fp, mask, generator)
        return x


class PhonemeEncoder(_Blocks):
    """Symbols -> contextual phoneme encodings with FiLM conditioning."""

    def __init__(self, n_symbols, cfg, strict_masking=True,
                 dtype=torch.float32, max_len=5000):
        d = cfg['hidden_embed_dim']
        super().__init__(cfg, d, strict_masking, dtype)
        self.symbols_embedding = nn.Embedding(n_symbols, d)
        self.positions = PositionTable(d, max_len)

    def forward(self, symbols, film_params, input_lengths, generator=None):
        L = symbols.shape[1]
        x = self.symbols_embedding(symbols)
        mask = sequence_mask(input_lengths, L)
        x = torch.where(mask[..., None], x + self.positions(L)[None],
                        torch.zeros_like(x))
        return self.run_blocks(x, film_params, mask, generator)


class AccentEncoder(_Blocks):
    """Reference mel + frame prosody -> global accent embedding: energy
    and pitch conv embeddings (float32), a conv stack over the mel
    (``conv_{i}``, ReLU, ``ln_{i}``, dropout), FFT blocks without FiLM and a
    length-normalised float32 mean pool over the valid frames."""

    def __init__(self, n_mel_channels, cfg, strict_masking=True,
                 dtype=torch.float32, max_len=5000):
        d = cfg['hidden_embed_dim']
        super().__init__(cfg, d, strict_masking, dtype)
        cc, k = cfg['conv_channels'], cfg['conv_kernel']
        self.strict_masking, self.dtype = strict_masking, dtype
        self.conv_dropout = cfg.get('conv_dropout', 0.0)
        self.positions = PositionTable(d, max_len)
        self.energy_embedding = ConvNorm1D(1, d, k)
        self.pitch_embedding = ConvNorm1D(1, d, k)
        for i, (c_in, c_out) in enumerate(((n_mel_channels, cc), (cc, cc),
                                           (cc, d))):
            self.add_module(f'conv_{i}', ConvNorm1D(c_in, c_out, k,
                                                    dtype=dtype))
            self.add_module(f'ln_{i}', LayerNorm(c_out))

    def forward(self, frames_energy, frames_pitch, mel_specs, output_lengths,
                generator=None):
        T = mel_specs.shape[-1]
        energy = self.energy_embedding(frames_energy[..., None])
        pitch = self.pitch_embedding(frames_pitch[..., None])
        mask = sequence_mask(output_lengths, T)
        x = mel_specs.transpose(1, 2)                       # (B, T, n_mels)
        for i in range(3):
            if self.strict_masking and i > 0:
                x = torch.where(mask[..., None], x, torch.zeros_like(x))
            x = torch.relu(getattr(self, f'conv_{i}')(x))
            x = getattr(self, f'ln_{i}')(x).to(self.dtype)
            if self.training and self.conv_dropout > 0:
                x = dropout(x, self.conv_dropout, generator)
        x = x + energy + pitch + self.positions(T)[None]
        x = torch.where(mask[..., None], x, torch.zeros_like(x)).to(self.dtype)
        x = self.run_blocks(x, None, mask, generator)
        return torch.sum(x.float(), dim=1) / output_lengths[:, None].float()


class SpeakerClassifier(nn.Module):
    """Three dense layers behind gradient reversal (adversarial
    disentanglement of the accent embedding from the speaker)."""

    def __init__(self, input_dim, n_speakers, embed_dim, lambda_reversal=1.0):
        super().__init__()
        self.lambda_reversal = lambda_reversal
        self.fc1 = LinearNorm(input_dim, embed_dim)
        self.fc2 = LinearNorm(embed_dim, embed_dim)
        self.fc3 = LinearNorm(embed_dim, n_speakers)

    def forward(self, x):
        x = gradient_reversal(x, self.lambda_reversal)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


class StyleAdapter(nn.Module):
    """Style embedding -> FiLM (gamma, beta) per module block."""

    def __init__(self, input_dim, module_params, post_mult_weight):
        super().__init__()
        self.module_params = dict(module_params)
        nb_tot = sum(b * c for b, c in self.module_params.values())
        self.gammas_predictor = LinearNorm(input_dim, nb_tot)
        self.betas_predictor = LinearNorm(input_dim, nb_tot)
        if post_mult_weight != 0.0:
            nb_post = sum(b for b, _ in self.module_params.values())
            self.post_multipliers = nn.Parameter(torch.empty(2, nb_post))
        else:
            self.post_multipliers = None

    def forward(self, style_embedding):
        gammas = self.gammas_predictor(style_embedding)
        betas = self.betas_predictor(style_embedding)
        post = self.post_multipliers
        film, col, blk = {}, 0, 0
        for name, (nb_blocks, channels) in self.module_params.items():
            n = nb_blocks * channels
            g = gammas[:, col:col + n].reshape(-1, nb_blocks, channels)
            b = betas[:, col:col + n].reshape(-1, nb_blocks, channels)
            if post is not None:
                g = post[0, blk:blk + nb_blocks][None, :, None] * g + 1.0
                b = post[1, blk:blk + nb_blocks][None, :, None] * b
            else:
                g = g + 1.0
            film[name] = torch.cat([g, b], dim=2)          # (B, nb, 2c)
            blk += nb_blocks
            col += n
        return film, post


class GaussianUpsampling(nn.Module):
    """Symbol encodings -> frame-rate sequence via Gaussian attention,
    float32 throughout."""

    def __init__(self, embed_dim, conv_kernel, use_concatenation=False):
        super().__init__()
        d = embed_dim
        self.use_concatenation = use_concatenation
        self.duration_projection = ConvNorm1D(1, d, conv_kernel)
        self.energy_projection = ConvNorm1D(1, d, conv_kernel)
        self.pitch_projection = ConvNorm1D(1, d, conv_kernel)
        self.range_projection = LinearNorm(d, 1)

    def forward(self, x, durations_float, durations_int, energies, pitch,
                input_lengths, n_frames):
        durs = self.duration_projection(durations_float[..., None])
        nrg = self.energy_projection(energies[..., None])
        f0 = self.pitch_projection(pitch[..., None])
        if self.use_concatenation:
            x_summed = x + nrg + f0
            x_up_in = x
        else:
            x = x + nrg + f0
            x_summed = x_up_in = x
        ranges = self.range_projection(x_summed + durs)
        ranges = torch.logaddexp(ranges, torch.zeros_like(ranges))[..., 0]
        mask = sequence_mask(input_lengths, x.shape[1])
        ranges = torch.where(mask, ranges, torch.ones_like(ranges))
        stds = torch.clamp(ranges.float(), min=1e-3)

        dur_i = durations_int.float()
        cums = torch.cumsum(dur_i, dim=1)
        means = dur_i / 2.0 + torch.nn.functional.pad(cums[:, :-1], (1, 0))
        means = torch.nan_to_num(means, nan=0.0, posinf=1e6, neginf=-1e6)
        stds = torch.clamp(torch.nan_to_num(stds, nan=1.0, posinf=1e6,
                                            neginf=1e-3), min=1e-3)

        t = torch.arange(n_frames, dtype=torch.float32,
                         device=x.device) + 0.5
        z = (t[None, None, :] - means[..., None]) / stds[..., None]
        log_prob = -0.5 * z * z - torch.log(stds)[..., None] - 0.5 * _LOG_2PI
        probs = torch.exp(log_prob)                                # (B,L,T)
        probs = torch.where(mask[..., None], probs, torch.zeros_like(probs))
        weights = _normalize_weights(probs)
        x_upsamp = torch.einsum('blt,bld->btd', weights, x_up_in.float())
        return x_upsamp.to(x.dtype), weights


class FrameDecoder(_Blocks):
    """Frame-rate sequence -> mel-spectrogram with FiLM conditioning."""

    def __init__(self, n_mel_channels, cfg, embed_dim, strict_masking=True,
                 dtype=torch.float32, max_len=5000):
        super().__init__(cfg, embed_dim, strict_masking, dtype)
        self.dtype = dtype
        self.positions = PositionTable(embed_dim, max_len)
        self.projection = LinearNorm(embed_dim, n_mel_channels)

    def forward(self, x, film_params, output_lengths, generator=None):
        T = x.shape[1]
        mask = sequence_mask(output_lengths, T)
        x = torch.where(mask[..., None], x + self.positions(T)[None],
                        torch.zeros_like(x)).to(self.dtype)
        x = self.run_blocks(x, film_params, mask, generator)
        mel = self.projection(x.float())
        mel = torch.where(mask[..., None], mel, torch.zeros_like(mel))
        return mel.transpose(1, 2)                      # (B, n_mels, T)


class DaftExprt(nn.Module):
    """The acoustic model. Build with
    ``DaftExprt.from_hparams(hp, device=...)``."""

    def __init__(self, n_symbols, n_speakers, n_mel_channels,
                 phoneme_encoder_cfg, accent_encoder_cfg, frame_decoder_cfg,
                 gum_conv_kernel=3, gum_use_concatenation=False,
                 external_emb_dim=192, lambda_reversal=1.0,
                 post_mult_weight=1e-3, frame_decoder_input_dim=None,
                 strict_masking=True, compute_dtype='float32'):
        super().__init__()
        dtype = torch.bfloat16 if compute_dtype == 'bfloat16' \
            else torch.float32
        d = phoneme_encoder_cfg['hidden_embed_dim']
        acc_dim = accent_encoder_cfg['hidden_embed_dim']
        dec_dim = frame_decoder_input_dim or d
        self.hidden_dim = d
        self.accent_encoder = AccentEncoder(n_mel_channels, accent_encoder_cfg,
                                            strict_masking, dtype)
        self.speaker_classifier = SpeakerClassifier(acc_dim, n_speakers, d,
                                                    lambda_reversal)
        self.style_adapter = StyleAdapter(
            acc_dim, {'phoneme_encoder': (phoneme_encoder_cfg['nb_blocks'], d),
                      'frame_decoder': (frame_decoder_cfg['nb_blocks'], d)},
            post_mult_weight)
        self.phoneme_encoder = PhonemeEncoder(
            n_symbols, phoneme_encoder_cfg, strict_masking, dtype)
        self.gaussian_upsampling = GaussianUpsampling(
            d, gum_conv_kernel, gum_use_concatenation)
        self.frame_decoder = FrameDecoder(
            n_mel_channels, frame_decoder_cfg, dec_dim, strict_masking, dtype)
        self.spk_projection = LinearNorm(external_emb_dim, d)

    @classmethod
    def from_hparams(cls, hp, device=None, strict_masking=True, seed=None):
        """Model on ``device`` (default cuda; raises without CUDA unless
        ``device='cpu'``). ``hp.fused_attention``: 'auto' routes attention
        through the CUDA kernel whenever the device is CUDA. ``seed``
        given, the parameters are random (:meth:`init_random_`)."""
        dev = resolve_device(device)
        fused = getattr(hp, 'fused_attention', 'auto')
        if fused == 'auto':
            fused = dev.type == 'cuda'
        gum = dict(hp.gaussian_upsampling_module)
        enc_cfg, acc_cfg, dec_cfg = (dict(hp.phoneme_encoder),
                                     dict(hp.accent_encoder),
                                     dict(hp.frame_decoder))
        for cfg in (enc_cfg, acc_cfg, dec_cfg):
            cfg['fused_attention'] = bool(fused)
        model = cls(
            n_symbols=hp.n_symbols,
            n_speakers=hp.n_speakers,
            n_mel_channels=hp.n_mel_channels,
            phoneme_encoder_cfg=enc_cfg,
            accent_encoder_cfg=acc_cfg,
            frame_decoder_cfg=dec_cfg,
            gum_conv_kernel=gum.get('conv_kernel', 3),
            gum_use_concatenation=gum.get('use_concatenation', False),
            external_emb_dim=getattr(hp, 'external_emb_dim', 192),
            lambda_reversal=getattr(hp, 'lambda_reversal', 1.0),
            post_mult_weight=getattr(hp, 'post_mult_weight', 1e-3),
            frame_decoder_input_dim=getattr(hp, 'frame_decoder_input_dim',
                                            None),
            strict_masking=strict_masking,
            compute_dtype=getattr(hp, 'compute_dtype', 'float32'))
        if seed is not None:
            model.init_random_(seed)
        return model.to(dev).eval()

    @torch.no_grad()
    def init_random_(self, seed):
        """Seeded random parameters (CPU ``torch.Generator``): normal with
        std 1/sqrt(fan_in) for weights, N(0, 1) symbol embeddings, N(0,
        0.02) biases, LayerNorm scale 1 and bias 0, post-multipliers N(0,
        0.1)."""
        gen = torch.Generator().manual_seed(int(seed))

        def kind(m):
            return 'norm' if isinstance(m, LayerNorm) else \
                'embed' if isinstance(m, nn.Embedding) else None
        kinds = {f'{m}.{leaf}': kind(mod) for m, mod in self.named_modules()
                 for leaf, _ in mod.named_parameters(recurse=False)}
        for name, p in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if kinds[name] == 'norm':
                val = torch.ones(p.shape) if leaf == 'weight' \
                    else torch.zeros(p.shape)
            elif leaf == 'bias':
                val = 0.02 * torch.randn(p.shape, generator=gen)
            elif leaf == 'post_multipliers':
                val = 0.1 * torch.randn(p.shape, generator=gen)
            else:
                fan_in = 1 if kinds[name] == 'embed' else p[0].numel()
                val = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
            p.copy_(val.to(p.device))
        return self

    def load_bridged(self, state_dict):
        """Load a state dict from ``bridge.acoustic_state_from_jax``: every
        parameter must be there, and nothing else; a missing or unexpected
        key raises ``KeyError``."""
        missing, unexpected = self.load_state_dict(state_dict, strict=False)
        if missing or unexpected:
            raise KeyError(f'state dict mismatch: missing {missing}, '
                           f'unexpected {unexpected}')
        return self

    def _speaker_embedding(self, spk_embs):
        norm = torch.linalg.norm(spk_embs, dim=-1, keepdim=True)
        return self.spk_projection(spk_embs / torch.clamp(norm, min=1e-12))

    def encode_accent(self, frames_energy, frames_pitch, mel_specs,
                      output_lengths, generator=None):
        """The accent embedding of a reference mel, (B, accent dim) float32."""
        return self.accent_encoder(frames_energy, frames_pitch, mel_specs,
                                   output_lengths, generator)

    def forward(self, symbols, durations_float, durations_int,
                symbols_energy, symbols_pitch, input_lengths, frames_energy,
                frames_pitch, mel_specs, output_lengths, speaker_ids,
                spk_embs, external_accent_emb=None, external_spk_emb=None,
                generator=None):
        """The training forward (the counterpart of the JAX ``__call__``).
        In training mode, dropout masks come from ``generator``. Returns
        {'speaker_preds', 'post_multipliers', 'film_frame_decoder',
        'mel_preds' (B, n_mels, T), 'alignments' (B, L, T), 'accent_emb'}."""
        if external_spk_emb is not None:
            spk_emb = external_spk_emb
        else:
            spk_emb = self._speaker_embedding(spk_embs)
        if external_accent_emb is not None:
            accent_emb = external_accent_emb
        else:
            accent_emb = self.accent_encoder(frames_energy, frames_pitch,
                                             mel_specs, output_lengths,
                                             generator)
        speaker_preds = self.speaker_classifier(accent_emb)
        film, post = self.style_adapter(accent_emb + spk_emb)
        enc = self.phoneme_encoder(symbols, film['phoneme_encoder'],
                                   input_lengths, generator)
        x, weights = self.gaussian_upsampling(
            enc, durations_float, durations_int, symbols_energy,
            symbols_pitch, input_lengths, mel_specs.shape[-1])
        mel = self.frame_decoder(x, film['frame_decoder'], output_lengths,
                                 generator)
        return {'speaker_preds': speaker_preds, 'post_multipliers': post,
                'film_frame_decoder': film['frame_decoder'],
                'mel_preds': mel, 'alignments': weights,
                'accent_emb': accent_emb}

    @torch.no_grad()
    def inference(self, symbols, duration_preds, durations_int, energy_preds,
                  pitch_preds, input_lengths, output_lengths, n_frames,
                  spk_embs=None, accent_emb=None, spk_emb_projected=None):
        """Synthesis forward with externally supplied symbol prosody;
        tensors on the model's device. Returns {'mel_preds' (B, n_mels,
        n_frames) float32, 'alignments' (B, L, n_frames) float32}."""
        if spk_emb_projected is not None:
            spk_emb = spk_emb_projected
        else:
            spk_emb = self._speaker_embedding(spk_embs)
        if accent_emb is None:
            raise ValueError('accent_emb is required for synthesis')
        film, _ = self.style_adapter(accent_emb + spk_emb)
        enc = self.phoneme_encoder(symbols, film['phoneme_encoder'],
                                   input_lengths)
        x, weights = self.gaussian_upsampling(
            enc, duration_preds, durations_int, energy_preds, pitch_preds,
            input_lengths, n_frames)
        mel = self.frame_decoder(x, film['frame_decoder'], output_lengths)
        return {'mel_preds': mel, 'alignments': weights}


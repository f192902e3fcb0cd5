"""Operations of the Daft-Exprt acoustic model's synthesis forward, from
its widths and each utterance's own symbols and frames (no padding):
every matrix product and convolution counted as 2 x its multiply-adds."""


def fft_block_macs(n, d, heads, conv_ch, k):
    """One FFT block over ``n`` positions: q, k, v and output projections,
    the two attention products (all heads together: n * n * d each) and
    the two convolutions of the feed-forward."""
    return n * 4 * d * d + 2 * n * n * d + 2 * n * d * conv_ch * k


def synthesis_ops(symbols, frames, acfg):
    """Operations of ``inference`` for one utterance of ``symbols`` symbols
    and ``frames`` frames under the acoustic configuration ``acfg`` (the
    hparams' phoneme_encoder, frame_decoder, n_mel_channels; the frame
    decoder's width is the encoder's unless it states its own)."""
    enc, dec = acfg['phoneme_encoder'], acfg['frame_decoder']
    d = enc['hidden_embed_dim']
    macs = enc['nb_blocks'] * fft_block_macs(
        symbols, d, enc['attn_nb_heads'], enc['conv_channels'],
        enc['conv_kernel'])
    macs += dec['nb_blocks'] * fft_block_macs(
        frames, dec.get('hidden_embed_dim', d), dec['attn_nb_heads'], dec['conv_channels'],
        dec['conv_kernel'])
    macs += symbols * frames * d                     # gaussian upsampling
    macs += frames * d * acfg['n_mel_channels']      # mel projection
    return 2 * macs

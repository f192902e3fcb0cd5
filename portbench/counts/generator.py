"""Operations and bytes of the HiFi-GAN generator (ResBlock1 or 2), from
its configuration and the mel's frames alone (a frozen copy of the counts
behind ``chip_smoke.py::bound``): every convolution counted as 2 x its
multiply-adds, each input byte read once and each output byte written
once."""


def conv_macs(frames, cfg):
    """Multiply-adds per utterance of ``frames`` mel frames, split into
    'mrf' (the resblock convolutions and the upsampling transposed
    convolutions, which the fused MRF kernels compute) and 'edge'
    (conv_pre and conv_post)."""
    c0 = cfg['upsample_initial_channel']
    n_mels = cfg.get('model_in_dim', 80)
    edge = frames * n_mels * c0 * 7
    mrf, n, c_in = 0, frames, c0
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        c = c0 // 2 ** (i + 1)
        mrf += n * c_in * c * k            # transposed conv: k taps an input
        n *= u
        per_dil = 2 if cfg['resblock'] == '1' else 1
        for rk, dils in zip(cfg['resblock_kernel_sizes'],
                            cfg['resblock_dilation_sizes']):
            mrf += len(dils) * per_dil * n * c * c * rk
        c_in = c
    edge += n * c_in * 7
    return {'mrf': mrf, 'edge': edge}


def least_ops(frames_list, cfg, tier):
    """Operations by precision for a batch of utterances (their own
    frames): the MRF part at the tier's rate (int8 for the int8 tiers,
    else bfloat16; float32 for the float32 route), the edge convs in
    bfloat16 (float32 on the float32 route)."""
    mrf = sum(2 * conv_macs(f, cfg)['mrf'] for f in frames_list)
    edge = sum(2 * conv_macs(f, cfg)['edge'] for f in frames_list)
    if tier == 'float32':
        return {'float32': mrf + edge}
    mrf_p = 'int8' if tier.startswith('int8') else 'bfloat16'
    out = {mrf_p: mrf}
    out['bfloat16'] = out.get('bfloat16', 0) + edge
    return out


def io_bytes(frames_list, cfg, hop=None):
    """The mel read (float32) and the waveform written (float32)."""
    hop = hop or 1
    for u in cfg['upsample_rates']:
        hop *= u
    n_mels = cfg.get('model_in_dim', 80)
    return sum(4 * f * n_mels + 4 * f * hop for f in frames_list)

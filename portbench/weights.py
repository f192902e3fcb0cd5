"""Weights made from the seed on the run's device, in a few large calls
of a seeded ``torch.Generator`` there: one normal draw for every random
leaf of a model, sliced and scaled leaf by leaf. The reference gets the
same float32 tensors; the program derives its own serving forms from
them."""
import torch


def _draw(total, seed, device):
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    return torch.randn(total, generator=g, device=device)


def fill_acoustic(model, seed):
    """Seeded parameters for the acoustic model, in place: weights N(0,
    1/fan_in), symbol embeddings N(0, 1), biases N(0, 0.02^2), LayerNorm
    scale 1 and bias 0, FiLM post-multipliers N(0, 0.1^2) (the port's
    ``init_random_`` distributions). Returns the float32 state dict (its
    parameters only) for the reference."""
    kinds = {}
    for mname, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            kinds[f'{mname}.{leaf}' if mname else leaf] = type(mod).__name__
    params = [(n, p) for n, p in model.named_parameters()]
    dev = params[0][1].device
    rand = [(n, p) for n, p in params if kinds[n] != 'LayerNorm']
    buf = _draw(sum(p.numel() for _, p in rand), seed, dev)
    off = 0
    with torch.no_grad():
        for n, p in params:
            leaf = n.rsplit('.', 1)[-1]
            if kinds[n] == 'LayerNorm':
                p.fill_(1.0 if leaf == 'weight' else 0.0)
                continue
            z = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            if leaf == 'bias':
                std = 0.02
            elif leaf == 'post_multipliers':
                std = 0.1
            elif kinds[n] == 'Embedding':
                std = 1.0
            else:
                std = p[0].numel() ** -0.5
            p.copy_(z * std)
    return {n: p.detach().float().clone() for n, p in params}


def generator_params(cfg, seed, device, gain=1.0, bias_std=0.01,
                     resblock_gain=None):
    """HiFi-GAN generator parameters (the port's dict layout) in float32:
    every conv weight N(0, gain^2 / fan_in), where a transposed conv's
    fan-in is C_in * k / stride (the resblock convs at ``resblock_gain``
    where given), biases N(0, bias_std^2). Unit-gain convs
    keep the activations and the waveform at a scale where every level
    matters (the reference init's std 0.01 gives waveforms of ~1e-4)."""
    c0 = cfg['upsample_initial_channel']
    shapes = [('conv_pre', (c0, cfg['model_in_dim'], 7), None)]
    ch = c0
    names = ('convs1', 'convs2') if cfg['resblock'] == '1' else ('convs',)
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                   cfg['upsample_kernel_sizes'])):
        out = c0 // 2 ** (i + 1)
        shapes.append((f'ups_{i}', (ch, out, k), ch * k / u))
        for j, (rk, dils) in enumerate(zip(cfg['resblock_kernel_sizes'],
                                           cfg['resblock_dilation_sizes'])):
            for pre in names:
                for l in range(len(dils)):
                    shapes.append((f'resblock_{i}_{j}/{pre}_{l}',
                                   (out, out, rk), None))
        ch = out
    shapes.append(('conv_post', (1, ch, 7), None))
    total = sum(s[0] * s[1] * s[2] + (s[1] if n.startswith('ups') else s[0])
                for n, s, _ in shapes)
    buf = _draw(total, seed, device)
    params, off = {}, 0
    for name, shape, fan in shapes:
        n_w = shape[0] * shape[1] * shape[2]
        n_b = shape[1] if name.startswith('ups') else shape[0]
        fan = fan or shape[1] * shape[2]
        g = gain if resblock_gain is None or '/' not in name \
            else resblock_gain
        w = buf[off:off + n_w].view(shape) * (g * fan ** -0.5)
        b = buf[off + n_w:off + n_w + n_b] * bias_std
        off += n_w + n_b
        leaf = {'w': w.clone(), 'b': b.clone()}
        if '/' in name:
            top, sub = name.split('/')
            params.setdefault(top, {})[sub] = leaf
        else:
            params[name] = leaf
    return params


def rounded(params, dtype):
    """A nested parameter dict with every tensor rounded to ``dtype`` and
    held in float32 (the values the program serves with)."""
    return {k: rounded(v, dtype) if isinstance(v, dict)
            else v.to(dtype).float() for k, v in params.items()}

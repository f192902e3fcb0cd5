"""Vocoder fine-tuning: HiFi-GAN's discriminator step, then its generator
step, as ``vocoder_finetune.finetune`` calls them, on batches of
voice-like segments drawn from the seed.

Set-up builds one training object (the generator in weight-norm form,
the discriminators, both AdamW optimisers, the port's
``make_gan_steps``) and drives it through its first ``check_steps``
iterations through the window's own call, on batches that all differ; it
records each step's two losses, the first gradient of every leaf as its
optimiser got it (read back from AdamW's first moment after step 1) and
every leaf's change over those steps, then hands the same object to the
window. After the window the plain float32 reference
(``portbench/reference/gan.py``) follows the same steps from the same
initial weights and inputs, and the check compares the two.
"""
import time

import torch


def _sync(device):
    if device == 'cuda':
        torch.cuda.synchronize()


def _leaf_names(tree, prefix=''):
    """Paths of a nested param dict in ``param_leaves``' sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f'{prefix}{k}'
        out.extend(_leaf_names(v, path + '/') if isinstance(v, dict)
                   else [path])
    return out


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def fill_discriminators(mpd, msd, seed):
    """Seeded discriminator weights, in place, from one normal draw on
    their device: every conv's ``v`` or ``w`` N(0, 1/fan_in), ``g`` the
    norm of its ``v`` (the fold starts at v), biases N(0, 1/fan_in), the
    power-iteration vectors N(0, 1). Returns float32 copies
    ({name: tensor} of the parameters, {name: u}) for the reference."""
    named = list(mpd.named_parameters()) + list(msd.named_parameters())
    bufs = [(n, b) for n, b in msd.named_buffers() if n.endswith('.u')]
    drawn = [(n, p) for n, p in named if not n.endswith('.g')] + bufs
    dev = named[0][1].device
    g = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    buf = torch.randn(sum(p.numel() for _, p in drawn), generator=g,
                      device=dev)
    fan = {}
    for n, p in named:
        if n.endswith(('.v', '.w')):
            fan[n.rsplit('.', 1)[0]] = p[0].numel()
    off = 0
    with torch.no_grad():
        for n, p in drawn:
            z = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            std = 1.0 if n.endswith('.u') else \
                fan[n.rsplit('.', 1)[0]] ** -0.5
            p.copy_(z * std)
        params = dict(named)
        for n, p in named:
            if n.endswith('.g'):
                v = params[n[:-2] + '.v']
                p.copy_(v.pow(2).sum(dim=tuple(range(1, v.ndim)),
                                     keepdim=True).sqrt())
    return ({n: p.detach().float().clone() for n, p in named},
            {n: b.detach().float().clone() for n, b in bufs})


def _program(state, compute_dtype, discriminators=None):
    """A training object from the kept initial weights: on
    ``discriminators`` (mpd, msd) already holding them, else on new
    ones."""
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    from daft_exprt_torch.vocoder_finetune import (
        generator_to_weight_norm, make_gan_steps,
    )
    dev, g = state['device'], state['gan']
    d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
        config=state['voc_cfg'], lr=g['lr'], b1=g['betas'][0],
        b2=g['betas'][1], compute_dtype=compute_dtype, device=dev)
    g_wn = generator_to_weight_norm(state['g_plain'])      # new tensors
    if discriminators is not None:
        mpd, msd = discriminators
    else:
        mpd, msd = init_mpd_params(0, dev), init_msd_params(0, dev)
        with torch.no_grad():
            for n, p in list(mpd.named_parameters()) + \
                    list(msd.named_parameters()):
                p.copy_(state['d_init'][n])
            for n, b in msd.named_buffers():
                if n in state['u_init']:
                    b.copy_(state['u_init'][n])
    prog = dict(d_step=d_step, g_step=g_step, loss_mel=loss_mel_fn,
                g_wn=g_wn, mpd=mpd, msd=msd, g_opt=optim_g(g_wn),
                d_opt=optim_d(mpd, msd))
    prog['g_names'] = _leaf_names(g_wn)
    prog['d_names'] = [n for n, _ in mpd.named_parameters()] + \
        [n for n, _ in msd.named_parameters()]
    return prog


def _iteration(prog, mel, y):
    """The window's call: a discriminator step, then a generator step."""
    y_mel = prog['loss_mel'](y[:, 0])
    d_loss = prog['d_step'](prog['mpd'], prog['msd'], prog['d_opt'],
                            prog['g_wn'], mel, y)
    g_loss, _ = prog['g_step'](prog['g_wn'], prog['g_opt'], prog['mpd'],
                               prog['msd'], mel, y, y_mel)
    return d_loss, g_loss


def _feed(state, batch):
    y = torch.as_tensor(batch, device=state['device'])
    return state['input_mel'](y[:, 0]), y


def _readings(prog, state):
    """Drives ``prog`` through the check steps; returns each step's
    losses, every leaf's first gradient norm (from AdamW's first moment
    after step 1) and every leaf's change norm over the steps."""
    b1 = state['gan']['betas'][0]
    g_leaves = _leaves(prog['g_wn'])
    d_leaves = [p for grp in prog['d_opt'].param_groups for p in grp['params']]
    names = ['G/' + n for n in prog['g_names']] + \
        ['D/' + n for n in prog['d_names']]
    leaves = g_leaves + d_leaves
    start = [p.detach().clone() for p in leaves]
    losses, grads = [], None
    for i, (mel, y) in enumerate(state['check_feed']):
        d, g = _iteration(prog, mel, y)
        losses.append((float(d), float(g)))
        if i == 0:
            opt_of = [prog['g_opt']] * len(g_leaves) + \
                [prog['d_opt']] * len(d_leaves)
            grads = {n: float(o.state[p]['exp_avg'].double().norm()) / (1 - b1)
                     for n, p, o in zip(names, leaves, opt_of)}
    change = {n: float((p.detach() - s).double().norm())
              for n, p, s in zip(names, leaves, start)}
    return dict(losses=losses, grads=grads, change=change)


def setup(ctx):
    weights = ctx['module']('weights')
    ref = ctx['module']('reference/gan')
    dev, cfg, mix, seed = ctx['device'], ctx['config'], ctx['traffic'], \
        ctx['seed']
    state = dict(ctx=ctx, device=dev, gan=cfg['gan'], voc_cfg=cfg['vocoder'])
    state['g_plain'] = weights.generator_params(
        cfg['vocoder'], seed + 1, dev, **cfg.get('vocoder_init', {}))
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    mpd, msd = init_mpd_params(0, dev), init_msd_params(0, dev)
    state['d_init'], state['u_init'] = fill_discriminators(mpd, msd,
                                                           seed + 2)
    state['input_mel'] = ref.LogMel(dev)
    Gen = ctx['generator'].Segments
    check = Gen(mix, seed, stream=1)
    state['check_batches'] = [check.batch() for _ in range(mix['check_steps'])]
    state['check_feed'] = [_feed(state, b) for b in state['check_batches']]
    prog = _program(state, cfg['gan']['compute_dtype'], (mpd, msd))
    state['readings'] = _readings(prog, state)
    state['prog'] = prog
    state['gen'] = Gen(mix, seed, stream=3)
    _sync(dev)
    return state


def window(state, seconds):
    prog, gen, mix = state['prog'], state['gen'], state['ctx']['traffic']
    dev = state['device']
    seg_s = mix['batch'] * mix['segment'] / mix['sampling_rate']
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    begin = time.perf_counter()
    deadline = begin + seconds
    n, marks = 0, []
    while time.perf_counter() < deadline:
        mel, y = _feed(state, gen.batch())
        d, g = _iteration(prog, mel, y)
        bad += (~torch.isfinite(d)).long() + (~torch.isfinite(g)).long()
        n += 1
        marks.append((marks[-1][1] if marks else begin, time.perf_counter(),
                      seg_s))
    _sync(dev)
    end = time.perf_counter()
    return dict(kind='gan', window_s=end - begin, iterations=n,
                begin=begin, marks=marks,
                audio_s=n * seg_s, attempted=n, failed=int(bad.clamp(max=n)),
                least_s=n * _least_s(state))


def _least_s(state):
    """One iteration's least time at the configuration's peak (frozen
    counts, ``portbench/counts/gan.py``)."""
    counts = _mod(state, 'counts/gan')
    peaks = _mod(state, 'counts/peaks')
    mix, g = state['ctx']['traffic'], state['gan']
    ops = counts.iteration_ops(mix['batch'], mix['segment'], state['voc_cfg'])
    return peaks.least_seconds({g['peak_precision']: ops})


def trace(state, record):
    """Two profiled stretches of ``trace_iterations`` iterations each: the
    device alone (busy time, idle share, device operations), then with
    the host, each step inside the benchmark's ``d_step`` and ``g_step``
    ranges (their device time, the idle gaps)."""
    from torch.profiler import record_function
    tracing = _mod(state, 'tracing')
    prog, mix = state['prog'], state['ctx']['traffic']
    n = mix['trace_iterations']
    lean = [state['gen'].batch() for _ in range(n)]
    feed = [_feed(state, state['gen'].batch()) for _ in range(n)]

    def plain():
        for batch in lean:
            _iteration(prog, *_feed(state, batch))

    def ranged():
        for mel, y in feed:
            y_mel = prog['loss_mel'](y[:, 0])
            with record_function('d_step'):
                prog['d_step'](prog['mpd'], prog['msd'], prog['d_opt'],
                               prog['g_wn'], mel, y)
            with record_function('g_step'):
                prog['g_step'](prog['g_wn'], prog['g_opt'], prog['mpd'],
                               prog['msd'], mel, y, y_mel)

    tr = tracing.two_stretches(plain, ranged,
                               lambda: _sync(state['device']))
    tr['iterations'] = n
    record['trace'] = tr


def release(state):
    state.pop('prog', None)
    state.pop('gen', None)
    if state['device'] == 'cuda':
        torch.cuda.empty_cache()


def _reference(state):
    """The reference's readings over the same check steps (cached)."""
    if 'ref' not in state:
        state['ref'] = _reference_readings(state)
    return state['ref']


def _reference_readings(state, feed=None, alter=None):
    """The reference's readings over the check steps (``feed``: other
    inputs; ``alter``: a planted fault on the generated waveforms)."""
    ref = _mod(state, 'reference/gan')
    g = state['gan']
    gp = {}
    for path, leaf in _flat_plain(state['g_plain']).items():
        w = leaf['w'].float()
        gp[f'{path}/g'] = w.pow(2).sum(dim=tuple(range(1, w.ndim)),
                                       keepdim=True).sqrt()
        gp[f'{path}/v'] = w.clone()
        gp[f'{path}/b'] = leaf['b'].float().clone()
    u = {n.split('.', 1)[1].rsplit('.', 1)[0]: t
         for n, t in state['u_init'].items()}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tr = ref.Trainer(gp, state['d_init'], u, state['voc_cfg'], g,
                         state['device'], alter)
        start = {('G/' + k): v.detach().clone() for k, v in tr.gp.items()}
        start.update({('D/' + k): v.detach().clone()
                      for k, v in tr.dp.items()})
        losses, grads = [], None
        for i, (mel, y) in enumerate(feed or state['check_feed']):
            losses.append(tr.step(mel, y))
            if i == 0:
                grads = {('G/' + k): float(v.double().norm())
                         for k, v in tr.g_grads.items()}
                grads.update({('D/' + k): float(v.double().norm())
                              for k, v in tr.d_grads.items()})
        now = {('G/' + k): v for k, v in tr.gp.items()}
        now.update({('D/' + k): v for k, v in tr.dp.items()})
        change = {k: float((now[k].detach() - s).double().norm())
                  for k, s in start.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    del tr
    return dict(losses=losses, grads=grads, change=change)


def _flat_plain(params, prefix=''):
    out = {}
    for k, v in params.items():
        if 'w' in v and not isinstance(v['w'], dict):
            out[prefix + k] = v
        else:
            out.update(_flat_plain(v, prefix + k + '/'))
    return out


def _checks(readings, state):
    return _mod(state, 'steps').checks(
        readings, _reference(state),
        state['ctx']['config']['gan']['limits'])


def check(state):
    return _checks(state['readings'], state)


def control(state):
    """The program's own lower-precision path (``compute_dtype``
    'bfloat16') from the same weights over the same check steps."""
    prog = _program(state, 'bfloat16')
    state['control_readings'] = _readings(prog, state)
    del prog
    return [(n, v) for n, v, _ in _checks(state['control_readings'], state)]


def faults(state):
    """Readings of faults planted in the reference put in the program's
    place: half of each batch left out (the mean over the rest), and an
    answer altered where it is produced (the first generated waveform of
    each step at half its amplitude)."""
    half = [(mel[:len(mel) // 2], y[:len(y) // 2])
            for mel, y in state['check_feed']]

    def halve_first(wav):
        scale = torch.ones(len(wav), 1, 1, device=wav.device)
        scale[0] = 0.5
        return wav * scale
    out = {}
    for name, kw in (('half_batch', dict(feed=half)),
                     ('altered_answer', dict(alter=halve_first))):
        readings = _reference_readings(state, **kw)
        out[name] = [(n, v) for n, v, _ in _checks(readings, state)]
    return out


def details(state):
    detail = _mod(state, 'steps').detail
    out = {'program': detail(state['readings'], _reference(state))}
    if 'control_readings' in state:
        out['control'] = detail(state['control_readings'], state['ref'])
    return out


def _mod(state, name):
    """The benchmark's helper ``portbench/<name>.py``."""
    return state['ctx']['module'](name)

"""Qualify the int8 vocoder serving tiers on trained weights (the port's
``scripts/qualify_int8.py``).

    python -m daft_exprt_torch.scripts.qualify_int8 --train_steps 300 \
        --out OUT [--weights OUT/weights.npz] [--device cuda]

1. GAN-fine-tunes the full V1 generator on synthetic voiced audio (pulse
   trains through formant resonators) for ``--train_steps`` steps in bf16
   (``vocoder_finetune.make_gan_steps``), or loads ``--weights``;
2. measures each fast tier against the float32 plain route on held-out
   mels: waveform rel-L2 and max-abs, mel-L1 and a multi-resolution STFT
   distance, for random-init and trained weights. The tiers, by the JAX
   script's names: ``bf16_pallas`` (``fused_mrf_tc`` and ``fused_mrf_phase``
   in bf16), ``int8_pallas`` (the dynamic tier: ``fused_mrf_ct_q8`` and the
   dynamic ``fused_mrf_phase_q8``) and ``int8_static_pallas`` (calibrated
   scales: ``fused_mrf_tc_q8`` and, from batch ``--ptc_min_batch``, the
   static ``fused_mrf_ptc``);
3. sweeps the static scales' calibration corpus (matched, 0.25x quiet,
   noise) with each quant point's saturation rate against the 1.1 margin;
4. records the per-level error budget of the static tier against the
   float32 route (``generator_forward(fuse_post=False)``: the last level's
   tap is the MRF output on both routes);
5. gates the results on the JAX script's thresholds and writes
   ``report.json`` (exit code 1 on a failing verdict).

``--weights`` reads the JAX script's own ``weights.npz`` (flax paths
``a/b/c``), and the port writes that format too. ``--ptc_min_batch``
(default 1) stands for the JAX script's ``DAFT_PTC_MIN_BATCH=1``: the
evaluation batch of 4 takes the phase-tc kernel at the narrow levels, the
route of batched serving. Random weights are drawn by torch, not by
``jax.random``: the same seed gives other weights than the JAX script's.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from daft_exprt_torch.bridge import generator_from_jax
from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.models.hifigan import (
    DEFAULT_CONFIG, _conv1d, _conv_transpose1d, _lrelu, _to,
    calibrate_act_scales, generator_forward, init_generator_params,
)
from daft_exprt_torch.ops.vocoder_kernels import full_f32
from daft_exprt_torch.scripts._cli import add_device_flag, parse_args
from daft_exprt_torch.vocoder_finetune import (
    SEGMENT_SIZE, _plain_detached, generator_to_weight_norm, make_gan_steps,
    make_loss_mel_fn,
)


# ----------------------------------------------------------------------
# synthetic voiced corpus (host-side, cheap)
# ----------------------------------------------------------------------

def synth_voice(rng, n, sr=22050):
    """Pulse train with drifting f0 through two formant resonators plus
    breath noise: crude but spectrally speech-shaped."""
    from scipy.signal import lfilter
    f0 = 90 + 120 * rng.rand()
    drift = np.cumsum(rng.randn(n) * 0.3)
    drift = drift - drift.mean()
    inst_f0 = np.clip(f0 * (1 + 0.003 * drift), 60, 400)
    phase = np.cumsum(inst_f0 / sr)
    sig = np.zeros(n)
    idx = np.searchsorted(phase, np.arange(1, int(phase[-1])))
    sig[np.clip(idx, 0, n - 1)] = 1.0
    out = np.zeros(n)
    for fc, bw, g in ((500 + 400 * rng.rand(), 80, 1.0),
                      (1400 + 800 * rng.rand(), 120, 0.6),
                      (2600 + 600 * rng.rand(), 180, 0.3)):
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        out += g * lfilter([1.0], [1, -2 * r * np.cos(theta), r * r], sig)
    out += 0.01 * rng.randn(n)
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * np.arange(n) * 2.7 / sr))
    out *= env
    return (out / (np.abs(out).max() + 1e-9) * 0.6).astype(np.float32)


def build_corpus(rng, n_segments, segment):
    segs = np.stack([synth_voice(rng, segment) for _ in range(n_segments)])
    return segs[:, None, :]                                  # (N, 1, S)


# ----------------------------------------------------------------------
# brief GAN fine-tune -> realistic weights
# ----------------------------------------------------------------------

def train_generator(steps, batch, seed=0, log_every=50, device=None,
                    config=None):
    """``steps`` GAN steps (bf16) of a seeded generator (``config``,
    default V1) against seeded MPD + MSD on a synthetic corpus of
    max(64, 8 * batch) segments, each step's rows drawn as the JAX script
    draws them. Returns the folded generator params (float32, no grad)."""
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    cfg = config or DEFAULT_CONFIG
    rng = np.random.RandomState(seed)
    n_segs = max(64, batch * 8)
    y_host = build_corpus(rng, n_segs, SEGMENT_SIZE)

    dev = resolve_device(device)
    d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
        cfg, compute_dtype='bfloat16', device=dev)
    y_all = torch.from_numpy(y_host).to(dev)                 # on the device
    with torch.no_grad():
        mel_all = loss_mel_fn(y_all[:, 0, :])                # (N, 80, S/256)

    g = generator_to_weight_norm(init_generator_params(seed, cfg,
                                                       device=dev))
    mpd = init_mpd_params(seed + 2, device=dev)
    msd = init_msd_params(seed + 1, device=dev)
    g_opt = optim_g(g)
    d_opt = optim_d(mpd, msd)

    t0 = time.time()
    for it in range(steps):
        sel = torch.from_numpy(rng.randint(0, n_segs, size=batch)).to(dev)
        mel = mel_all[sel]
        y = y_all[sel]
        d_loss = d_step(mpd, msd, d_opt, g, mel, y)
        g_loss, mel_l1 = g_step(g, g_opt, mpd, msd, mel, y, mel)
        if it % log_every == 0 or it == steps - 1:
            print(f'  it {it}: d_loss {float(d_loss):.3f} '
                  f'g_loss {float(g_loss):.3f} mel_l1 {float(mel_l1):.3f} '
                  f'({time.time() - t0:.0f}s)', flush=True)
    return _plain_detached(g)


# ----------------------------------------------------------------------
# weights in the JAX script's format (flax paths 'a/b/c')
# ----------------------------------------------------------------------

def save_weights(path, params):
    """Generator params -> an npz of float32 arrays under '/'-joined
    paths, as the JAX script writes its ``weights.npz``."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat['/'.join(prefix + (k,))] = \
                    v.detach().float().cpu().numpy()
    walk(params, ())
    np.savez(path, **flat)


def load_weights(path, device=None):
    """A ``weights.npz`` of either package -> the port's generator params
    on ``device``."""
    tree = {}
    for key, value in np.load(path).items():
        node = tree
        *parents, leaf = key.split('/')
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return _to(generator_from_jax(tree), torch.float32, device)


# ----------------------------------------------------------------------
# perceptual proxy: multi-resolution STFT distance
# ----------------------------------------------------------------------

def _stft_mag(x, nfft, hop):
    """|STFT| of (N, S) via framed rfft, periodic hann."""
    win = np.hanning(nfft + 1)[:-1]
    n_frames = 1 + (x.shape[-1] - nfft) // hop
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.abs(np.fft.rfft(x[:, idx] * win, axis=-1))


def mrstft_distance(x, y):
    """Multi-resolution STFT distance between waveform batches (N, S):
    mean over {512, 1024, 2048}-point resolutions of the spectral
    convergence ||X|-|Y||_F / |||Y||_F and the log-magnitude L1."""
    sc, lm = [], []
    for nfft in (512, 1024, 2048):
        X = _stft_mag(x, nfft, nfft // 4)
        Y = _stft_mag(y, nfft, nfft // 4)
        sc.append(np.linalg.norm(X - Y) / (np.linalg.norm(Y) + 1e-12))
        lm.append(np.mean(np.abs(np.log(X + 1e-7) - np.log(Y + 1e-7))))
    return float(np.mean(sc)), float(np.mean(lm))


# ----------------------------------------------------------------------
# static-scale diagnostics: saturation rates + per-level error budgets
# ----------------------------------------------------------------------

def saturation_report(params, mels, scales, margin=1.1):
    """Fraction of float32-reference activations above the calibrated
    static range (cal_amax * margin) at every int8 quant point: the values
    the static kernels would clip. Returns {level: {'mean', 'max',
    'worst_point': 'rb{j}/d{ii}/conv{1|2}'}}; the traversal of
    :func:`calibrate_act_scales`, on the params' device."""
    cfg = DEFAULT_CONFIG
    dev = params['conv_pre']['w'].device
    mels = torch.as_tensor(np.asarray(mels, np.float32) if not isinstance(
        mels, torch.Tensor) else mels, dtype=torch.float32, device=dev)
    report = {}
    with torch.no_grad(), full_f32():
        x = _conv1d(mels, params['conv_pre']['w'], params['conv_pre']['b'])
        for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                       cfg['upsample_kernel_sizes'])):
            x = _conv_transpose1d(_lrelu(x), params[f'ups_{i}']['w'],
                                  params[f'ups_{i}']['b'], u, (k - u) // 2)
            xs = None
            rates = {}
            for j, dils in enumerate(cfg['resblock_dilation_sizes']):
                rb = params[f'resblock_{i}_{j}']
                s1s, s2s = scales[i][j]
                cur = x
                for ii, d in enumerate(dils):
                    t1 = _lrelu(cur)
                    thr1 = (s1s[ii] * margin)[None, :, None]
                    rates[f'rb{j}/d{ii}/conv1'] = float(
                        (t1.abs() > thr1).float().mean())
                    a = _conv1d(t1, rb[f'convs1_{ii}']['w'],
                                rb[f'convs1_{ii}']['b'], dilation=d)
                    t2 = _lrelu(a)
                    thr2 = (s2s[ii] * margin)[None, :, None]
                    rates[f'rb{j}/d{ii}/conv2'] = float(
                        (t2.abs() > thr2).float().mean())
                    cur = cur + _conv1d(t2, rb[f'convs2_{ii}']['w'],
                                        rb[f'convs2_{ii}']['b'])
                xs = cur if xs is None else xs + cur
            x = xs / len(cfg['resblock_kernel_sizes'])
            worst = max(rates, key=rates.get)
            report[f'level_{i}'] = {
                'mean': float(np.mean(list(rates.values()))),
                'max': rates[worst], 'worst_point': worst}
    return report


def _bf16(params, mel):
    return (_to(params, torch.bfloat16, params['conv_pre']['w'].device),
            mel.to(torch.bfloat16))


def level_taps(params, mel, **run_kwargs):
    """{'level_i': float32 (B, C, T)} of one ``generator_forward`` run (no
    grad) and its waveform."""
    taps = {}

    def tap(i, x):
        taps[f'level_{i}'] = x.float()

    with torch.no_grad():
        wav = generator_forward(params, mel, _tap=tap, **run_kwargs)
    return taps, wav


def per_level_budget(params, mel, scales, ptc_min_batch=1):
    """rel-L2 of the int8-static kernels' chain against the float32 plain
    route at each upsample-level boundary ((B, C, T) layout, interior
    samples), with ``fuse_post=False`` so that the last level's tap is the
    MRF output on both routes."""
    with full_f32():
        t_ref, _ = level_taps(params, mel)
    p16, m16 = _bf16(params, mel)
    print('  int8-static chain (conv_post unfused) for the per-level '
          'taps...', flush=True)
    t_q8, _ = level_taps(p16, m16, use_fast=True, int8_act_scales=scales,
                         ptc_min_batch=ptc_min_batch, fuse_post=False)
    budget = {}
    for key in sorted(t_ref):
        r = t_ref[key].cpu().numpy().astype(np.float64)
        q = t_q8[key].cpu().numpy().astype(np.float64)
        cut = max(8, r.shape[-1] // 16)
        rr, qq = r[..., cut:-cut], q[..., cut:-cut]
        budget[key] = float(np.linalg.norm(qq - rr)
                            / (np.linalg.norm(rr) + 1e-12))
    return budget


# ----------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------

def _wav(params, mel, **kw):
    with torch.no_grad():
        w = generator_forward(params, mel, **kw)
    return w.float().cpu().numpy().astype(np.float64)


def chain_outputs(params, mel, cal_mel=None, skip_bf16=False,
                  ptc_min_batch=1):
    """{name: wav} of the float32 plain route ('f32_xla'), the bf16 tier
    ('bf16_pallas'), the int8-dynamic tier ('int8_pallas') and, with a
    calibration batch ``cal_mel``, the int8-static tier
    ('int8_static_pallas'), as float64 numpy (B, 1, S)."""
    outs = {}
    with full_f32():
        outs['f32_xla'] = _wav(params, mel)
    p16, m16 = _bf16(params, mel)
    if not skip_bf16:
        print('  bf16 kernels chain...', flush=True)
        outs['bf16_pallas'] = _wav(p16, m16, use_fast=True)
    print('  int8 kernels chain...', flush=True)
    outs['int8_pallas'] = _wav(p16, m16, use_fast=True, int8=True,
                               ptc_min_batch=ptc_min_batch)
    if cal_mel is not None:
        scales = calibrate_act_scales(params, cal_mel)
        print('  int8-static kernels chain...', flush=True)
        outs['int8_static_pallas'] = _wav(
            p16, m16, use_fast=True, int8_act_scales=scales,
            ptc_min_batch=ptc_min_batch)
    return outs


def _interior(w):
    # edge samples differ by the fused chain's SAME padding: compare the
    # interior (the receptive field is a few thousand samples)
    cut = 4096
    return w[:, :, cut: w.shape[-1] - cut]


def _metrics(x, r, loss_mel_fn):
    """x, r: (N, 1, S) waveforms; ``loss_mel_fn``: (N, S) numpy -> the
    loss log-mel as numpy (:func:`numpy_loss_mel`)."""
    rel_l2 = float(np.linalg.norm(x - r) / (np.linalg.norm(r) + 1e-12))
    max_abs = float(np.abs(x - r).max())
    mel_l1 = float(np.mean(np.abs(loss_mel_fn(r[:, 0, :])
                                  - loss_mel_fn(x[:, 0, :]))))
    sc, lmag = mrstft_distance(x[:, 0, :], r[:, 0, :])
    return {'wav_rel_l2': rel_l2, 'wav_max_abs': max_abs,
            'mel_l1': mel_l1, 'mrstft_sc': sc, 'mrstft_logmag_l1': lmag}


def numpy_loss_mel(device):
    """The loss log-mel (``make_loss_mel_fn``) on ``device`` as a
    function of (N, S) numpy waveforms, numpy out."""
    fn = make_loss_mel_fn(device=device)

    def loss_mel(w):
        with torch.no_grad():
            return fn(torch.as_tensor(np.asarray(w), dtype=torch.float32,
                                      device=device)).cpu().numpy()
    return loss_mel


def _print_row(name, m):
    print(f'  {name}: wav rel-L2 {m["wav_rel_l2"]:.4f}  '
          f'max|d| {m["wav_max_abs"]:.4f}  mel-L1 {m["mel_l1"]:.4f}  '
          f'mrstft sc {m["mrstft_sc"]:.4f} '
          f'logmag-L1 {m["mrstft_logmag_l1"]:.4f}', flush=True)


def report(outs, loss_mel_fn):
    r = _interior(outs['f32_xla'])
    rows = {}
    for name, w in outs.items():
        if name == 'f32_xla':
            continue
        rows[name] = _metrics(_interior(w), r, loss_mel_fn)
        _print_row(name, rows[name])
    return rows


def mismatch_sweep(params, mel_eval, f32_ref, cal_sets, loss_mel_fn,
                   margin=1.1, ptc_min_batch=1):
    """Calibration robustness: the int8-static tier's quality and
    saturation rates with the static scales of each corpus in
    ``cal_sets``."""
    p16, m16 = _bf16(params, mel_eval)
    r = _interior(f32_ref)
    rows = {}
    for name, cal_mel in cal_sets.items():
        scales = calibrate_act_scales(params, cal_mel)
        wav = _wav(p16, m16, use_fast=True, int8_act_scales=scales,
                   ptc_min_batch=ptc_min_batch)
        m = _metrics(_interior(wav), r, loss_mel_fn)
        sat = saturation_report(params, mel_eval, scales, margin=margin)
        m['sat_mean'] = float(np.mean([v['mean'] for v in sat.values()]))
        m['sat_max'] = float(max(v['max'] for v in sat.values()))
        m['sat_worst_point'] = max(
            sat, key=lambda k: sat[k]['max']) + '/' + max(
            sat.values(), key=lambda v: v['max'])['worst_point']
        m['saturation_by_level'] = sat
        rows[f'cal_{name}'] = m
        _print_row(f'cal_{name}', m)
        print(f'    saturation: mean {m["sat_mean"]:.2e} '
              f'max {m["sat_max"]:.2e} at {m["sat_worst_point"]}',
              flush=True)
    return rows


# ----------------------------------------------------------------------
# gate: asserted thresholds -> explicit pass/fail verdict in the artifact
# ----------------------------------------------------------------------

# the JAX script's trained-weights budgets, unchanged (its measured
# int8-static wav rel-L2 0.0064 / mel-L1 0.0075 / mrstft sc 0.0047, dynamic
# 0.0081 / 0.0079 / 0.0053, with ~1.5-2x headroom)
GATE_THRESHOLDS = {
    'int8_static_pallas': {'wav_rel_l2': 0.010, 'mel_l1': 0.010,
                           'mrstft_sc': 0.010},
    'int8_pallas': {'wav_rel_l2': 0.013, 'mel_l1': 0.013,
                    'mrstft_sc': 0.013},
}
SAT_MATCHED_MAX = 1e-4        # matched-calibration clipping rate
LEVEL_FINAL_MAX = 0.010       # last-level boundary rel-L2
LEVEL_GROWTH_MAX = 3.0        # per-level error growth factor cap
NOISE_DETECT_MIN = 0.05       # the noise-calibration row must stay bad


def gate(results):
    """Pass/fail over the recorded metrics: (verdict, checks), checks
    mapping a check's name to {'ok', 'value', 'limit'}; any False makes
    the verdict 'fail'. Trained-weights quality per int8 tier,
    matched-calibration saturation, a monotone per-level error budget, and
    the calibration-mismatch detector's liveness."""
    checks = {}

    def add(name, value, limit, ok=None):
        checks[name] = {'value': value, 'limit': limit,
                        'ok': bool(value <= limit) if ok is None else ok}

    trained = results.get('trained', {})
    for tier, lims in GATE_THRESHOLDS.items():
        row = trained.get(tier)
        if row is None:
            continue
        for metric, lim in lims.items():
            add(f'trained/{tier}/{metric}', row[metric], lim)

    sweep = results.get('calibration_sweep', {})
    if 'cal_matched' in sweep:
        add('cal_matched/sat_max', sweep['cal_matched']['sat_max'],
            SAT_MATCHED_MAX)
    if 'cal_noise' in sweep:
        v = sweep['cal_noise']['wav_rel_l2']
        add('cal_noise/detector_alive', v, NOISE_DETECT_MIN,
            ok=v >= NOISE_DETECT_MIN)

    budget = results.get('per_level_rel_l2', {})
    if budget:
        keys = sorted(budget)
        add(f'per_level/{keys[-1]}', budget[keys[-1]], LEVEL_FINAL_MAX)
        for a, b in zip(keys, keys[1:]):
            if budget[a] > 1e-6:
                add(f'per_level/{b}_growth', budget[b] / budget[a],
                    LEVEL_GROWTH_MAX)

    verdict = 'pass' if all(c['ok'] for c in checks.values()) else 'fail'
    return verdict, checks


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument('--train_steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--eval_batch', type=int, default=4)
    ap.add_argument('--eval_frames', type=int, default=256)
    ap.add_argument('--weights', type=str, default='',
                    help='reuse saved trained weights (skip the GAN train)')
    ap.add_argument('--out', type=str, default='/tmp/int8_qual')
    ap.add_argument('--skip_random', action='store_true')
    ap.add_argument('--skip_bf16', action='store_true')
    ap.add_argument('--skip_diag', action='store_true',
                    help='skip the calibration-mismatch sweep and '
                         'per-level error budgets')
    ap.add_argument('--ptc_min_batch', type=int, default=1,
                    help='batch from which the static tier\'s narrow '
                         'levels take the phase-tc kernel (the route of '
                         'batched serving; the JAX script\'s '
                         'DAFT_PTC_MIN_BATCH=1)')
    add_device_flag(ap)
    return ap


def main(argv=None):
    """Runs the qualification; returns the results (written to
    ``report.json``), whose 'verdict' is 'pass' or 'fail'."""
    args = parse_args(build_parser(), argv)
    dev = torch.device(args.device)
    pmb = args.ptc_min_batch
    os.makedirs(args.out, exist_ok=True)
    loss_mel_fn = numpy_loss_mel(dev)
    print('device:', torch.cuda.get_device_name(dev) if dev.type == 'cuda'
          else dev, flush=True)

    def mel_fn(y):
        return torch.from_numpy(loss_mel_fn(y[:, 0, :])).to(dev)

    # held-out eval mels from fresh synthetic audio; a disjoint
    # calibration batch feeds the static act scales
    rng = np.random.RandomState(1234)
    seg = args.eval_frames * 256
    y_eval = build_corpus(rng, args.eval_batch, seg)
    mel_eval = mel_fn(y_eval)
    y_cal = build_corpus(rng, args.eval_batch, seg)
    mel_cal = mel_fn(y_cal)
    print('eval mel', tuple(mel_eval.shape), flush=True)

    results = {}

    if not args.skip_random:
        print('=== random-init weights ===', flush=True)
        params_rand = init_generator_params(0, device=dev)
        outs = chain_outputs(params_rand, mel_eval, ptc_min_batch=pmb)
        results['random'] = report(outs, loss_mel_fn)

    if args.weights and os.path.isfile(args.weights):
        print(f'=== loading trained weights from {args.weights} ===',
              flush=True)
        params = load_weights(args.weights, dev)
    else:
        print(f'=== GAN fine-tune ({args.train_steps} steps) ===',
              flush=True)
        params = train_generator(args.train_steps, args.batch, device=dev)
        save_weights(os.path.join(args.out, 'weights.npz'), params)
        print(f'weights saved to {args.out}/weights.npz', flush=True)

    print('=== trained weights ===', flush=True)
    outs = chain_outputs(params, mel_eval, cal_mel=mel_cal,
                         skip_bf16=args.skip_bf16, ptc_min_batch=pmb)
    results['trained'] = report(outs, loss_mel_fn)

    if not args.skip_diag:
        print('=== calibration-mismatch sweep (static scales) ===',
              flush=True)
        y_quiet = y_cal * 0.25
        rng_n = np.random.RandomState(77)
        y_noise = (rng_n.randn(*y_cal.shape) * 0.1).astype(np.float32)
        cal_sets = {
            'matched': mel_cal,
            'quiet_0.25x': mel_fn(y_quiet),
            'noise': mel_fn(y_noise),
        }
        results['calibration_sweep'] = mismatch_sweep(
            params, mel_eval, outs['f32_xla'], cal_sets, loss_mel_fn,
            ptc_min_batch=pmb)

        print('=== per-level error budget (matched static scales) ===',
              flush=True)
        budget = per_level_budget(params, mel_eval,
                                  calibrate_act_scales(params, mel_cal),
                                  ptc_min_batch=pmb)
        for k, v in budget.items():
            print(f'  {k}: rel-L2 {v:.4f}', flush=True)
        results['per_level_rel_l2'] = budget

    verdict, checks = gate(results)
    results['gate'] = checks
    results['verdict'] = verdict
    print('=== gate ===', flush=True)
    for name, c in sorted(checks.items()):
        mark = 'ok  ' if c['ok'] else 'FAIL'
        print(f'  [{mark}] {name}: {c["value"]:.3e} vs {c["limit"]:.3e}',
              flush=True)
    print(f'verdict: {verdict}', flush=True)

    with open(os.path.join(args.out, 'report.json'), 'w') as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == '__main__':
    sys.exit(0 if main()['verdict'] == 'pass' else 1)

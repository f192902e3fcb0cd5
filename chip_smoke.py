#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daft_exprt_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels of daft_exprt_torch/ops/csrc into build/ (one
   nvcc per source, all at once) and prints the build seconds.
3. Holds each kernel to its plain PyTorch version on the card, at the
   shapes the synthesis path gives it (B=8, V1 / default acoustic widths):
   rel-L2 <= 1e-2 in bf16 (summation order only), <= 1e-5 for a float32
   call of the tc kernel, <= 2e-3 for the int8-static kernels
   (fused_mrf_tc_q8 at L0/L1, fused_mrf_ptc at L2 and at L3 with
   conv_post; NUMERICS_r05.json ptc_vs_banded_int8).
4. Runs the synthesis path through the user entry points at B=8
   requests, L=128 symbols, T=1024 frames, with seeded random weights, in
   two tiers, each with every launch counter set to 0 just before it and
   read just after:
   - bf16: Synthesizer.infer + HiFiGanVocoder(fast='bf16').infer; the
     waveform against the float32 plain route, rel-L2 <= 5e-2;
   - int8-static (bench.py's headline route): Synthesizer.infer +
     HiFiGanVocoder(fast='int8', int8_calibration_mels=mel[:4]).infer,
     calibrated on the batch's first four mels as bench.py does; the
     waveform against the port's plain int8 route (the kernels' plain
     versions on the card), rel-L2 <= 1e-2, and against the bf16 tier,
     rel-L2 <= 0.25 (NUMERICS_r05.json vocoder_int8_static_vs_bf16).
   Each checks the waveform's shape and finiteness and that every kernel
   of its path was launched.
5. Times each kernel, its plain version and (attention) the library call
   with CUDA events at the path's shapes, beside the least time the card
   could take (H100 SXM: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s).
   Each wrapper counts its CUDA launches and its calls by input shape;
   the per-path totals weight each shape's time by its path's calls at
   that shape, and the run fails unless those calls times the launches
   per call add up to the path's launch count.
6. Prints the end-to-end audio-seconds per second of both tiers at B=8.

``--profile`` adds a torch.profiler pass over one synthesis call of each
tier: device time by kernel, the acoustic/vocoder split and the device's
busy share.

Any failure raises (exit code != 0). Without a CUDA device it exits 2 and
prints no result. Its last line is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
PEAK_INT8 = 1979e12          # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
B, L, T = 8, 128, 1024       # requests, symbols, frames
SEED = 1234


def log(*a):
    print(*a, flush=True)


def make_batch(hp, B, L, T, seed=0):
    """Own numpy copy of the JAX repo's __graft_entry__._make_batch
    (inference fields)."""
    rng = np.random.RandomState(seed)
    dur_int = np.full((B, L), T // L, dtype=np.int64)
    dur_int[:, -1] += T - (T // L) * L
    return dict(
        symbols=rng.randint(1, hp.n_symbols, (B, L)),
        duration_preds=(dur_int * hp.hop_length / hp.sampling_rate
                        ).astype(np.float32),
        durations_int=dur_int,
        energy_preds=rng.randn(B, L).astype(np.float32),
        pitch_preds=rng.randn(B, L).astype(np.float32),
        input_lengths=np.full((B,), L, dtype=np.int64),
        spk_embs=rng.randn(B, hp.external_emb_dim).astype(np.float32),
    )


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def time_ms(torch, fn, warmup=2, iters=10):
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops, nbytes, int8_ops=0):
    """Least time in ms: the bf16 flops and int8 operations at their peak
    rates against the bytes at the memory rate."""
    t_op = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3
    t_by = nbytes / PEAK_BYTES * 1e3
    return (t_op, 'operations') if t_op >= t_by else (t_by, 'bytes')


def level_params(torch, gen, C_in, C, ks, dils, dev, post=False):
    """One V1 level's params with unit-gain convs (std 1/sqrt(C*k)), so the
    resblock branches, not the residual, carry the checked values."""
    def norm(std, *shape):
        return (std * torch.randn(shape, generator=gen)).to(dev)
    p = {'ups_0': {'w': norm((C_in * 2) ** -0.5, C_in, C, 4),
                   'b': norm(0.05, C)}}
    for j, (k, ds) in enumerate(zip(ks, dils)):
        p[f'resblock_0_{j}'] = {
            f'{pre}_{i}': {'w': norm((C * k) ** -0.5, C, C, k),
                           'b': norm(0.05, C)}
            for pre in ('convs1', 'convs2') for i in range(len(ds))}
    if post:
        p['conv_post'] = {'w': norm((C * 7) ** -0.5, 1, C, 7),
                          'b': norm(0.05, 1)}
    return p


def level_scales(torch, F, p, x, ks, dils):
    """calibrate_act_scales' entry for one level: per-channel amax of every
    resblock conv input in the float32 per-conv forward of x (B, C, T)."""
    def lrelu(t):
        return torch.where(t >= 0, t, 0.1 * t)

    out = []
    for j, (k, ds) in enumerate(zip(ks, dils)):
        rb = p[f'resblock_0_{j}']
        cur, s1, s2 = x, [], []
        for i, d in enumerate(ds):
            t1 = lrelu(cur)
            s1.append(t1.abs().amax(dim=(0, 2)))
            c1, c2 = rb[f'convs1_{i}'], rb[f'convs2_{i}']
            t2 = lrelu(F.conv1d(t1, c1['w'], c1['b'], padding=d * (k // 2),
                                dilation=d))
            s2.append(t2.abs().amax(dim=(0, 2)))
            cur = cur + F.conv1d(t2, c2['w'], c2['b'], padding=k // 2)
        out.append((torch.stack(s1), torch.stack(s2)))
    return out


def _range(torch, name, on):
    """A named profiler range when ``on``."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def profile_path(torch, synthesize, tier):
    """Device time by kernel over one synthesis call, and the busy share
    of the device over the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    synthesize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synthesize(ranges=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, 'self_device_time_total', None) or \
            getattr(e, 'self_cuda_time_total', 0.0)

    def range_us(e):
        return getattr(e, 'device_time_total', None) or \
            getattr(e, 'cuda_time_total', 0.0)

    ranges = ('acoustic', 'vocoder')
    events = prof.key_averages()
    # device-side events only (host ops carry their kernels' time too); the
    # named ranges show up as device-side spans: not busy time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in ranges and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels)
    log(f'profile {tier}: wall {wall_us / 1e3:.3f} ms, device busy '
        f'{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)')
    for e in events:
        if e.key in ranges:
            log(f'profile {tier} range {e.key}: device '
                f'{range_us(e) / 1e3:.3f} ms, host '
                f'{e.cpu_time_total / 1e3:.3f} ms')
    groups = {}
    for e in kernels:
        g = next((p for p in ('mrf::step_kernel', 'mrf::ups_kernel',
                              'mrf::step_q8_kernel', 'mrf::ups_q8_kernel',
                              'mrf::amax_kernel', 'mrf::post_kernel',
                              'attn::', 'Memcpy')
                  if p in e.key), 'other')
        groups[g] = groups.get(g, 0.0) + dev_us(e)
    log(f'profile {tier} groups: ' + ', '.join(
        f'{g} {us / 1e3:.3f} ms' for g, us in sorted(
            groups.items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        log(f'profile {tier} kernel {dev_us(e) / 1e3:9.3f} ms '
            f'x{e.count:<4d} {e.key[:100]}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from daft_exprt_torch.generate import Synthesizer
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.daft_exprt import DaftExprt
    from daft_exprt_torch.models.hifigan import (
        DEFAULT_CONFIG, HiFiGanVocoder, generator_forward,
        init_generator_params,
    )
    from daft_exprt_torch.ops import _build
    from daft_exprt_torch.ops import vocoder_kernels as vk
    from daft_exprt_torch.ops.attention_kernels import (
        attention_plain, fused_attention,
    )
    import torch.nn.functional as F

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f'build: {time.perf_counter() - t0:.1f} s '
        + ' '.join(f'{k}={v:.1f}s' for k, v in built.items()))

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED)
    ks = tuple(DEFAULT_CONFIG['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in DEFAULT_CONFIG['resblock_dilation_sizes'])
    T_l = [T * 8, T * 64, T * 128, T * 256]       # samples after each level

    # ---- 3. each kernel against its plain version -------------------------
    errs = {}

    def check(name, out, ref, band):
        torch.cuda.synchronize()
        assert out.shape == ref.shape, (name, out.shape, ref.shape)
        assert torch.isfinite(out.float()).all(), name
        r, m = rel_l2(out.float(), ref.float()), max_abs(out.float(),
                                                          ref.float())
        log(f'check {name}: max_abs={m:.3e} rel_l2={r:.3e} (band {band:g})')
        assert r <= band, f'{name}: rel-L2 {r} above {band}'
        return m

    att_inputs = {}
    for t_att in (L, T):
        q, k, v = (torch.randn((B, 2, t_att, 64), generator=gen)
                   .to(dev, bf16) for _ in range(3))
        q = q * 64 ** -0.5
        lengths = torch.tensor([t_att - 37 * i for i in range(B)],
                               dtype=torch.int32, device=dev).clamp(min=1)
        att_inputs[tuple(q.shape)] = (q, k, v, lengths)
        errs.setdefault('fused_attention', []).append(check(
            f'fused_attention T={t_att}', fused_attention(q, k, v, lengths),
            attention_plain(q, k, v, lengths), 1e-2))

    tc_inputs, ph_inputs = {}, {}
    for lvl, (C_in, C) in enumerate(((512, 256), (256, 128))):
        p = level_params(torch, gen, C_in, C, ks, dils, dev)
        w = vk.pack_mrf_tc_weights(p, 0, ks, dils)
        x = torch.randn((B, T_l[lvl], C), generator=gen).to(dev)
        wb = [t.to(bf16) for t in w]
        mrf = vk.prepare_mrf(wb, ks, dils)
        tc_inputs[tuple(x.shape)] = (lvl, x.to(bf16), mrf)
        errs.setdefault('fused_mrf_tc', []).append(check(
            f'fused_mrf_tc L{lvl} bf16', vk.fused_mrf_tc(x.to(bf16), mrf),
            vk.mrf_tc_plain(x.to(bf16), wb, ks, dils), 1e-2))
        if lvl == 0:
            check('fused_mrf_tc L0 float32',
                  vk.fused_mrf_tc(x, vk.prepare_mrf(w, ks, dils)),
                  vk.mrf_tc_plain(x, w, ks, dils), 1e-5)
        del x, w
    for lvl, (C_in, C) in ((2, (128, 64)), (3, (64, 32))):
        post = lvl == 3
        p = level_params(torch, gen, C_in, C, ks, dils, dev, post=post)
        p = {k: {kk: (vv.to(bf16) if torch.is_tensor(vv) else
                      {a: t.to(bf16) for a, t in vv.items()})
                 for kk, vv in v.items()} for k, v in p.items()}
        w = vk.pack_mrf_tc_weights(p, 0, ks, dils)
        ups = (p['ups_0']['w'], p['ups_0']['b'], 2, 1)
        pst = (p['conv_post']['w'], p['conv_post']['b']) if post else None
        # the path hands L2 the L1 output as a transposed (B, T, C) tensor
        x = torch.randn((B, T_l[lvl - 1], C_in), generator=gen).to(
            dev, bf16).transpose(1, 2)
        mrf = vk.prepare_mrf(w, ks, dils, ups, pst)
        ph_inputs[tuple(x.shape)] = (lvl, x, mrf)
        errs.setdefault('fused_mrf_phase', []).append(check(
            f'fused_mrf_phase L{lvl}' + (' +conv_post' if post else ''),
            vk.fused_mrf_phase(x, mrf),
            vk.mrf_phase_plain(x, w, ks, dils, ups, pst), 1e-2))

    # int8-static kernels: weights packed from bf16 params as the tier
    # packs them, act scales calibrated on a slice of each level's input
    def to_bf16(p):
        return {k: {kk: (vv.to(bf16) if torch.is_tensor(vv) else
                         {a: t.to(bf16) for a, t in vv.items()})
                    for kk, vv in v.items()} for k, v in p.items()}

    q8_inputs, ptc_inputs = {}, {}
    for lvl, (C_in, C) in enumerate(((512, 256), (256, 128))):
        p = level_params(torch, gen, C_in, C, ks, dils, dev)
        x = torch.randn((B, T_l[lvl], C), generator=gen).to(dev, bf16)
        scales = level_scales(torch, F, p, x[:1, :8192].float()
                              .transpose(1, 2), ks, dils)
        mrf = vk.prepare_mrf_tc_q8(vk.pack_mrf_tc_int8_weights(
            to_bf16(p), 0, ks, dils, scales), ks, dils)
        q8_inputs[tuple(x.shape)] = (lvl, x, mrf)
        errs.setdefault('fused_mrf_tc_q8', []).append(check(
            f'fused_mrf_tc_q8 L{lvl}', vk.fused_mrf_tc_q8(x, mrf),
            vk.mrf_tc_q8_plain(x, mrf), 2e-3))
    for lvl, (C_in, C, p_in) in ((2, (128, 64, 1)), (3, (64, 32, 2))):
        post = lvl == 3
        p = level_params(torch, gen, C_in, C, ks, dils, dev, post=post)
        # the path hands L2 the L1 output (B, T, 128), L3 the L2 output
        x = torch.randn((B, T_l[lvl - 1], C_in), generator=gen).to(dev, bf16)
        x0 = F.conv_transpose1d(
            torch.where(x[:1, :4096] >= 0, x[:1, :4096], 0.1 * x[:1, :4096])
            .float().transpose(1, 2), p['ups_0']['w'], p['ups_0']['b'],
            stride=2, padding=1)
        p16 = to_bf16(p)
        u = vk.pack_ups_ptc_weights(p16['ups_0']['w'], p16['ups_0']['b'], 2,
                                    1, p_in)
        pst = vk.pack_post_ptc_weights(
            p16['conv_post']['w'], p16['conv_post']['b'], 2 * p_in,
            bf16) if post else None
        mrf = vk.prepare_mrf_ptc(vk.pack_mrf_ptc_weights(
            p16, 0, ks, dils, 2 * p_in,
            level_scales(torch, F, p, x0, ks, dils)), ks, dils, 2 * p_in,
            tuple(u) + (4, 2, 1, p_in), pst)
        tile = vk.ptc_tile(x.shape[1] // p_in)
        ptc_inputs[tuple(x.shape)] = (lvl, x, mrf, tile)
        errs.setdefault('fused_mrf_ptc', []).append(check(
            f'fused_mrf_ptc L{lvl}' + (' +conv_post' if post else '')
            + f' tile {tile}', vk.fused_mrf_ptc(x, mrf, tile),
            vk.mrf_ptc_plain(x, mrf, tile), 2e-3))

    # ---- 4. the synthesis path ------------------------------------------
    hp = HyperParams(verbose=False, training_files='unused',
                     validation_files='unused',
                     output_directory=os.path.join(ROOT, 'build', 'smoke'),
                     language='english', speakers=['lj'])
    model = DaftExprt.from_hparams(hp, seed=SEED)          # device: cuda
    synth = Synthesizer(model, hp)
    voc_params = init_generator_params(SEED)               # device: cuda
    vocoder = HiFiGanVocoder(voc_params, fast='bf16')
    batch = make_batch(hp, B, L, T, seed=SEED)
    batch['accent_emb'] = batch['spk_embs'][:, :model.hidden_dim]
    kernels = (fused_attention, vk.fused_mrf_tc, vk.fused_mrf_phase,
               vk.fused_mrf_tc_q8, vk.fused_mrf_ptc)

    def synthesizer(voc):
        def synthesize(ranges=False):
            with _range(torch, 'acoustic', ranges):
                mel, _, _ = synth.infer(**batch)
            with _range(torch, 'vocoder', ranges):
                return mel, voc.infer(mel)
        return synthesize

    def run_path(tier, synthesize, path_kernels):
        """One call of a tier's path, every launch counter at 0 before it;
        returns (mel, wav, launches, calls by shape) read just after."""
        for kern in kernels:
            kern.launches = 0
            kern.calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel, wav = synthesize()
        first_s = time.perf_counter() - t0
        n = {kern.__name__: kern.launches for kern in kernels}
        calls = {kern.__name__: dict(kern.calls) for kern in kernels}
        log(f'path {tier}: mel {mel.shape} wav {wav.shape} first call '
            f'{first_s:.2f} s; launches {n}; calls by input shape {calls}')
        assert mel.shape == (B, hp.n_mel_channels, T), mel.shape
        assert wav.shape == (B, T * 256), wav.shape
        assert np.isfinite(mel).all() and np.isfinite(wav).all()
        for kern in kernels:
            name = kern.__name__
            if kern in path_kernels:
                assert n[name] > 0, f'the {tier} path never launched {name}'
            else:
                assert n[name] == 0, f'the {tier} path launched {name}'
        return mel, wav, {k.__name__: n[k.__name__] for k in path_kernels}, \
            {k.__name__: calls[k.__name__] for k in path_kernels}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))

    synthesize = synthesizer(vocoder)
    mel, wav, launches, path_calls = run_path(
        'bf16', synthesize, kernels[:3])
    exact = HiFiGanVocoder(voc_params, fast=False).infer(mel)
    r = rel(wav, exact)
    log(f'path bf16: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), |wav| max {np.abs(exact).max():.3e}')
    assert r <= 5e-2, r

    # the int8-static tier, calibrated on the batch's first four mels as
    # bench.py does (bench.py:136-140)
    t0 = time.perf_counter()
    vocoder_q8 = HiFiGanVocoder(voc_params, fast='int8',
                                int8_calibration_mels=mel[:4])
    log(f'path int8: calibration and int8 packing '
        f'{time.perf_counter() - t0:.2f} s')
    synthesize_q8 = synthesizer(vocoder_q8)
    mel_q8, wav_q8, n_q8, calls_q8 = run_path(
        'int8', synthesize_q8, (fused_attention, vk.fused_mrf_tc_q8,
                                vk.fused_mrf_ptc))
    for name in ('fused_mrf_tc_q8', 'fused_mrf_ptc'):
        launches[name], path_calls[name] = n_q8[name], calls_q8[name]
    assert n_q8['fused_attention'] == launches['fused_attention']
    with torch.no_grad():
        plain = generator_forward(
            vocoder_q8.params, torch.as_tensor(mel_q8).to(dev, bf16),
            DEFAULT_CONFIG, use_fast=True, packed=vocoder_q8.packed,
            int8_act_scales=vocoder_q8.act_scales, plain=True)
    plain = np.clip(plain.float().cpu().numpy()[:, 0], -1.0, 1.0)
    r_plain = rel(wav_q8, plain)
    r_bf16 = rel(wav_q8, vocoder.infer(mel_q8))
    log(f'path int8: waveform vs the plain int8 route rel_l2={r_plain:.3e} '
        f'(band 1e-2), vs the bf16 tier rel_l2={r_bf16:.3e} (band 0.25), '
        f'|wav| max {np.abs(wav_q8).max():.3e}')
    assert r_plain <= 1e-2, r_plain
    assert r_bf16 <= 0.25, r_bf16

    # ---- 5. timings -----------------------------------------------------
    # at each input shape the path called a kernel with; the path's calls
    # at that shape weight the per-call times into the per-path totals
    for name, inputs in (('fused_attention', att_inputs),
                         ('fused_mrf_tc', tc_inputs),
                         ('fused_mrf_phase', ph_inputs),
                         ('fused_mrf_tc_q8', q8_inputs),
                         ('fused_mrf_ptc', ptc_inputs)):
        assert set(path_calls[name]) == set(inputs), (
            f'{name}: the path called it at {sorted(path_calls[name])}, '
            f'checked and timed at {sorted(inputs)}')
    by_name = {kern.__name__: kern for kern in kernels}
    shapes = {}

    def timed(name, key, desc, fn, plain, flops, nbytes, lib=None,
              int8_ops=0):
        n0 = by_name[name].launches
        fn()
        per_launch = by_name[name].launches - n0    # launches per call
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        lib_ms = time_ms(torch, lib) if lib is not None else None
        b_ms, b_by = bound(flops, nbytes, int8_ops)
        per_call = path_calls[name][key]
        shapes.setdefault(name, []).append(dict(
            shape=desc, per_call=per_call, launches_per_call=per_launch,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by))
        log(f'time {name} {desc}: ms={ms:.4f} plain_ms={plain_ms:.4f} '
            f'library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} '
            f'bound_ms={b_ms:.4f} ({b_by}) x{per_call} per path call, '
            f'{per_launch} launches each')

    for (_, _, t_att, _), (q, k, v, lengths) in att_inputs.items():
        mask = (torch.arange(t_att, device=dev)[None, :] < lengths[:, None]
                )[:, None, None, :]
        timed('fused_attention', tuple(q.shape),
              f'q,k,v (8,2,{t_att},64) bf16',
              lambda: fused_attention(q, k, v, lengths),
              lambda: attention_plain(q, k, v, lengths),
              4 * B * 2 * t_att * t_att * 64, 4 * B * 2 * t_att * 64 * 2,
              lib=lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask, scale=1.0))
    for key, (lvl, x, mrf) in tc_inputs.items():
        Bx, Tx, C = x.shape
        wbytes = sum(t.numel() * t.element_size() for t in mrf.packed)
        timed('fused_mrf_tc', key, f'L{lvl} x ({Bx},{Tx},{C}) bf16',
              lambda: vk.fused_mrf_tc(x, mrf),
              lambda: vk.mrf_tc_plain(x, mrf.packed, ks, dils),
              252 * Bx * Tx * C * C, 2 * Bx * Tx * C * 2 + wbytes)
    for key, (lvl, x, mrf) in ph_inputs.items():
        Bx, C_in, T_in = x.shape
        C = mrf.ups[0].shape[1]
        N = 2 * T_in
        pst = mrf.post
        c_out = 1 if pst is not None else C
        flops = 252 * Bx * N * C * C + 2 * Bx * N * C_in * C * 2 + (
            2 * Bx * N * C * 7 if pst is not None else 0)
        wbytes = sum(t.numel() * t.element_size() for t in mrf.packed) + \
            mrf.ups[0].numel() * 2
        timed('fused_mrf_phase', key,
              f'L{lvl} x ({Bx},{C_in},{T_in}) -> ({Bx},{c_out},{N}) bf16',
              lambda: vk.fused_mrf_phase(x, mrf),
              lambda: vk.mrf_phase_plain(x, mrf.packed, ks, dils, mrf.ups,
                                         pst),
              flops, Bx * C_in * T_in * 2 + Bx * c_out * N * 2 + wbytes)

    for key, (lvl, x, mrf) in q8_inputs.items():
        Bx, Tx, C = x.shape
        wbytes = sum(w[0].numel() + w[4].numel() + 4 * 5 * C
                     for steps in mrf.chains for w in steps)
        timed('fused_mrf_tc_q8', key, f'L{lvl} x ({Bx},{Tx},{C}) bf16',
              lambda: vk.fused_mrf_tc_q8(x, mrf),
              lambda: vk.mrf_tc_q8_plain(x, mrf), 0,
              2 * Bx * Tx * C * 2 + wbytes,
              int8_ops=2 * sum(len(d) * 2 * k for k, d in zip(ks, dils))
              * Bx * Tx * C * C)
    for key, (lvl, x, mrf, tile) in ptc_inputs.items():
        # operations of the output samples (each tile's halo recomputation
        # is the design's, not counted); conv_post in bf16
        Bx, T_in, C_in = x.shape
        wq_u, _, _, stride, _, k_u = mrf.ups
        C = wq_u.shape[-1]
        N = stride * T_in
        c_out = 1 if mrf.post is not None else C
        ops = 2 * sum(len(d) * 2 * k for k, d in zip(ks, dils)) \
            * Bx * N * C * C + 2 * Bx * N * C_in * C * (k_u // stride)
        wbytes = wq_u.numel() + sum(w[0].numel() + w[4].numel() + 4 * 5 * C
                                    for steps in mrf.chains for w in steps)
        timed('fused_mrf_ptc', key,
              f'L{lvl} x ({Bx},{T_in},{C_in}) -> ({Bx},'
              + (f'1,{N})' if c_out == 1 else f'{N},{C})') + ' bf16',
              lambda: vk.fused_mrf_ptc(x, mrf, tile),
              lambda: vk.mrf_ptc_plain(x, mrf, tile),
              2 * Bx * N * C * 7 if mrf.post is not None else 0,
              Bx * T_in * C_in * 2 + Bx * c_out * N * 2 + wbytes,
              int8_ops=ops)

    sources = {'fused_attention': 'daft_exprt_torch/ops/csrc/attention_fwd.cu',
               'fused_mrf_tc': 'daft_exprt_torch/ops/csrc/mrf_tc.cu',
               'fused_mrf_phase': 'daft_exprt_torch/ops/csrc/mrf_phase.cu',
               'fused_mrf_tc_q8': 'daft_exprt_torch/ops/csrc/mrf_tc_q8.cu',
               'fused_mrf_ptc': 'daft_exprt_torch/ops/csrc/mrf_ptc.cu'}
    replaces = {
        'fused_attention': 'daft_exprt_tpu/ops/attention_kernels.py:170',
        'fused_mrf_tc': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_phase': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_tc_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_ptc': 'daft_exprt_tpu/ops/vocoder_kernels.py:1999'}
    table = []
    for name, rows in shapes.items():
        counted = sum(r['per_call'] * r['launches_per_call'] for r in rows)
        assert counted == launches[name], (
            f'{name}: {launches[name]} launches on the path, {counted} from '
            'its calls by shape times launches per call')
        def total(key):
            return sum(r[key] * r['per_call'] for r in rows)
        lib = None if any(r['library_ms'] is None for r in rows) \
            else total('library_ms')
        b_ms = total('bound_ms')
        by = max(rows, key=lambda r: r['bound_ms'] * r['per_call'])['bound_by']
        table.append(dict(
            name=name, route='cuda', source=sources[name],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(errs[name]), ms=total('ms'),
            plain_ms=total('plain_ms'), bound_ms=b_ms, bound_by=by,
            library_ms=lib, per_shape=rows))

    # ---- 6. end to end ----------------------------------------------------
    audio_s = B * T * 256 / DEFAULT_CONFIG['sampling_rate']
    for tier, synth_fn in (('bf16', synthesize), ('int8', synthesize_q8)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth_fn()
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        log(f'end to end {tier}: {e2e:.3f} s for {audio_s:.2f} audio-s at '
            f'B={B}: {audio_s / e2e:.1f} audio-s/s (host clock, '
            'synchronized)')

    if '--profile' in sys.argv:
        profile_path(torch, synthesize, 'bf16')
        profile_path(torch, synthesize_q8, 'int8')

    log(json.dumps({'kernels': table}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daft_exprt_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels of daft_exprt_torch/ops/csrc into build/ (one
   nvcc per source, all at once) and prints the build seconds; holds a
   float32 call of the tc kernel to its plain version (rel-L2 <= 1e-5).
3. Drives the synthesis path through the user entry points with seeded
   random weights, each path with every launch counter set to 0 just
   before it and read just after:
   - bf16, B=8 requests x L=128 symbols x T=1024 frames: Synthesizer.infer
     + HiFiGanVocoder(fast='bf16').infer; the waveform against the float32
     plain route, rel-L2 <= 5e-2;
   - int8-static, B=8 (bench.py's headline route): HiFiGanVocoder(
     fast='int8', int8_calibration_mels=mel[:4]), calibrated as bench.py
     does; the waveform against the port's plain int8 route (the kernels'
     plain versions on the card), rel-L2 <= 1e-2, and against the bf16
     tier, rel-L2 <= 0.25 (NUMERICS_r05.json vocoder_int8_vs_bf16);
   - int8-dynamic, B=8: HiFiGanVocoder(fast='int8') without calibration
     mels (fused_mrf_ct q8 at L0/L1, the dynamic int8 fused_mrf_phase at
     L2/L3), the same two bands;
   - the serving entry point at batch 1: generate_mel_specs(batch_size=1)
     over three utterances of about 200, 640 and 1024 frames (so the ct
     tile changes) with the int8-static vocoder (its narrow levels below
     the phase-tc batch: the q8f int8 fused_mrf_phase), then with the
     int8-dynamic one; each utterance's waveform against the plain int8
     route, rel-L2 <= 1e-2; prints the RTF. With matplotlib the entry
     point saves its outputs (npz, png, wav); without it, it runs with
     save_outputs=False and the path vocodes each mel itself through
     synthesizer.vocoder.infer. It prints which.
   Each path checks its outputs' shape and finiteness and that every kernel
   of its path, and no other, was launched.
4. At every input shape a path called a kernel with: the kernel against
   its plain PyTorch version on the same inputs (unit-gain random weights):
   rel-L2 <= 1e-2 in bf16 (summation order only), <= 2e-3 for the int8
   kernels (NUMERICS_r05.json ptc_vs_banded_int8); its launches per call;
   its time, its plain version's and (attention) the library call's, with
   CUDA events, beside the least time the card could take (H100 SXM: 989
   TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s). Each wrapper counts its CUDA
   launches and its calls by input shape; the run fails unless, on every
   path, the calls times the launches per call add up to the launch count.
5. Prints the end-to-end audio-seconds per second of the three B=8 tiers.

``--profile`` adds a torch.profiler pass over one synthesis call of each
B=8 tier and one generate_mel_specs call of each batch-1 path: device
time by kernel, the acoustic/vocoder split and the device's busy share.

Any failure raises (exit code != 0). Without a CUDA device it exits 2 and
prints no result. The line before the last is the kernels' JSON; the last
is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import math
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
UTT_FRAMES = (200, 640, 1024)   # the batch-1 entry point's utterances
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


def entry_inputs(hp, seed):
    """generate_mel_specs' inputs for UTT_FRAMES: one word of phones and a
    full stop per sentence, external prosody (frames, energy, pitch) per
    symbol, and the speaker stats the prosody is normalised to."""
    rng = np.random.RandomState(seed)
    phones = [s for s in hp.symbols if s[0].isalpha()]
    sentences, prosody = [], []
    for frames in UTT_FRAMES:
        n = frames // 6
        sentences.append([[phones[i] for i in rng.randint(0, len(phones),
                                                          n)], '.'])
        dur = rng.randint(4, 9, n + 1).astype(np.float64)
        dur *= (frames - 3) / dur.sum()
        prosody.append({'symbols': list(range(n + 1)),
                        'durations_frames': dur,
                        'energy': rng.rand(n + 1) * 3.0,
                        'pitch': np.where(rng.rand(n + 1) < 0.3, 0.0,
                                          100.0 + 150.0 * rng.rand(n + 1))})
    stats = {'spk 0': {'energy': {'mean': 1.0, 'std': 1.5},
                       'pitch': {'mean': 5.0, 'std': 0.3}}}
    return sentences, prosody, stats


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


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


class KernelCases:
    """Inputs, plain version, band and work of every kernel at any input
    shape (``calls`` key) a path called it with. Weights are unit-gain
    random, made from the seed; the int8-static kernels' act scales are
    calibrated on a slice of the level input."""

    def __init__(self, torch, F, vk, mi, attn, dev, ks, dils):
        self.torch, self.F, self.vk, self.mi, self.attn = torch, F, vk, mi, \
            attn
        self.dev, self.ks, self.dils = dev, ks, dils
        self.gen = torch.Generator().manual_seed(SEED + 7)
        self.n_ops = 2 * sum(len(d) * 2 * k for k, d in zip(ks, dils))

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen).to(
            self.dev, self.torch.bfloat16)

    def params(self, C_in, C, post=False):
        return level_params(self.torch, self.gen, C_in, C, self.ks, self.dils,
                            self.dev, post=post)

    def bf16(self, p):
        return {k: {kk: (vv.to(self.torch.bfloat16) if self.torch.is_tensor(vv)
                         else {a: t.to(self.torch.bfloat16)
                               for a, t in vv.items()})
                    for kk, vv in v.items()} for k, v in p.items()}

    def q8_wbytes(self, mrf, C, ups=0):
        return ups + sum(w[0].numel() + w[-3].numel() + 4 * 5 * C
                         for steps in mrf.chains for w in steps)

    def case(self, name, key):
        return getattr(self, name)(key)

    def fused_attention(self, key):
        torch = self.torch
        Bx, H, t, D = key
        q, k, v = (self.randn(Bx, H, t, D) for _ in range(3))
        q = q * D ** -0.5
        lengths = torch.tensor([t - 37 * i for i in range(Bx)],
                               dtype=torch.int32, device=self.dev).clamp(min=1)
        mask = (torch.arange(t, device=self.dev)[None, :] < lengths[:, None]
                )[:, None, None, :]
        return dict(desc=f'q,k,v ({Bx},{H},{t},{D}) bf16', band=1e-2,
                    fn=lambda: self.attn[0](q, k, v, lengths),
                    plain=lambda: self.attn[1](q, k, v, lengths),
                    lib=lambda: self.F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=1.0),
                    flops=4 * Bx * H * t * t * D, nbytes=4 * Bx * H * t * D * 2)

    def fused_mrf_tc(self, key):
        vk = self.vk
        Bx, Tx, C = key
        wb = [t.to(self.torch.bfloat16) for t in vk.pack_mrf_tc_weights(
            self.params(2 * C, C), 0, self.ks, self.dils)]
        mrf = vk.prepare_mrf(wb, self.ks, self.dils)
        x = self.randn(Bx, Tx, C)
        wbytes = sum(t.numel() * t.element_size() for t in wb)
        return dict(desc=f'x ({Bx},{Tx},{C}) bf16', band=1e-2,
                    fn=lambda: vk.fused_mrf_tc(x, mrf),
                    plain=lambda: vk.mrf_tc_plain(x, wb, self.ks, self.dils),
                    flops=252 * Bx * Tx * C * C,
                    nbytes=2 * Bx * Tx * C * 2 + wbytes)

    def fused_mrf_phase(self, key):
        vk = self.vk
        Bx, C_in, T_in = key
        C, post = C_in // 2, C_in == 64
        p = self.bf16(self.params(C_in, C, post=post))
        w = vk.pack_mrf_tc_weights(p, 0, self.ks, self.dils)
        ups = (p['ups_0']['w'], p['ups_0']['b'], 2, 1)
        pst = (p['conv_post']['w'], p['conv_post']['b']) if post else None
        # the path hands a narrow level a transposed (B, T, C) tensor
        x = self.randn(Bx, T_in, C_in).transpose(1, 2)
        mrf = vk.prepare_mrf(w, self.ks, self.dils, ups, pst)
        N = 2 * T_in
        c_out = 1 if post else C
        wbytes = sum(t.numel() * t.element_size() for t in w) + \
            ups[0].numel() * 2
        return dict(desc=f'x ({Bx},{C_in},{T_in}) -> ({Bx},{c_out},{N}) bf16',
                    band=1e-2, fn=lambda: vk.fused_mrf_phase(x, mrf),
                    plain=lambda: vk.mrf_phase_plain(x, w, self.ks, self.dils,
                                                     ups, pst),
                    flops=252 * Bx * N * C * C + 2 * Bx * N * C_in * C * 2
                    + (2 * Bx * N * C * 7 if post else 0),
                    nbytes=Bx * C_in * T_in * 2 + Bx * c_out * N * 2 + wbytes)

    def fused_mrf_tc_q8(self, key):
        vk = self.vk
        Bx, Tx, C = key
        p = self.params(2 * C, C)
        x = self.randn(Bx, Tx, C)
        scales = level_scales(self.torch, self.F, p, x[:1, :8192].float()
                              .transpose(1, 2), self.ks, self.dils)
        mrf = vk.prepare_mrf_tc_q8(vk.pack_mrf_tc_int8_weights(
            self.bf16(p), 0, self.ks, self.dils, scales), self.ks, self.dils)
        return dict(desc=f'x ({Bx},{Tx},{C}) bf16', band=2e-3,
                    fn=lambda: vk.fused_mrf_tc_q8(x, mrf),
                    plain=lambda: vk.mrf_tc_q8_plain(x, mrf), flops=0,
                    nbytes=2 * Bx * Tx * C * 2 + self.q8_wbytes(mrf, C),
                    int8_ops=self.n_ops * Bx * Tx * C * C)

    def _narrow(self, key):
        """(x, bf16 params, float32 params, p_in, post, q8f scales)."""
        torch = self.torch
        Bx, T_in, C_in = key[:3]
        C, post = C_in // 2, C_in == 64
        p_in = 1 if C_in == 128 else 2
        p = self.params(C_in, C, post=post)
        x = self.randn(Bx, T_in, C_in)
        xs = x[:1, :4096]
        x0 = self.F.conv_transpose1d(
            torch.where(xs >= 0, xs, 0.1 * xs).float().transpose(1, 2),
            p['ups_0']['w'], p['ups_0']['b'], stride=2, padding=1)
        return x, self.bf16(p), p_in, post, level_scales(
            torch, self.F, p, x0, self.ks, self.dils)

    def _narrow_work(self, key, mrf, post):
        Bx, T_in, C_in = key[:3]
        C = C_in // 2
        N = 2 * T_in
        c_out = 1 if post else C
        return dict(flops=2 * Bx * N * C * 7 if post else 0,
                    nbytes=Bx * T_in * C_in * 2 + Bx * c_out * N * 2
                    + self.q8_wbytes(mrf, C, mrf.ups[0].numel()),
                    int8_ops=self.n_ops * Bx * N * C * C
                    + 2 * Bx * N * C_in * C * 2)

    def fused_mrf_ptc(self, key):
        vk = self.vk
        x, p16, p_in, post, scales = self._narrow(key)
        u = vk.pack_ups_ptc_weights(p16['ups_0']['w'], p16['ups_0']['b'], 2,
                                    1, p_in)
        pst = vk.pack_post_ptc_weights(
            p16['conv_post']['w'], p16['conv_post']['b'], 2 * p_in,
            self.torch.bfloat16) if post else None
        mrf = vk.prepare_mrf_ptc(vk.pack_mrf_ptc_weights(
            p16, 0, self.ks, self.dils, 2 * p_in, scales), self.ks,
            self.dils, 2 * p_in, tuple(u) + (4, 2, 1, p_in), pst)
        tile = vk.ptc_tile(x.shape[1] // p_in)
        Bx, T_in, C_in = key
        out = f'({Bx},1,{2 * T_in})' if post else \
            f'({Bx},{2 * T_in},{C_in // 2})'
        return dict(desc=f'x ({Bx},{T_in},{C_in}) -> {out} bf16 tile {tile}',
                    band=2e-3, fn=lambda: vk.fused_mrf_ptc(x, mrf, tile),
                    plain=lambda: vk.mrf_ptc_plain(x, mrf, tile),
                    **self._narrow_work(key, mrf, post))

    def fused_mrf_ct_q8(self, key):
        mi = self.mi
        Bx, Tx, C = key
        p16 = self.bf16(self.params(2 * C, C))
        mrf = mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
            mi.pack_mrf_weights(p16, 0, self.ks, self.dils)), self.ks,
            self.dils)
        x = self.randn(Bx, Tx, C)
        tile = mi.ct_tile(Tx, C)
        return dict(desc=f'x ({Bx},{Tx},{C}) bf16 tile {tile}', band=2e-3,
                    fn=lambda: mi.fused_mrf_ct_q8(x, mrf, tile),
                    plain=lambda: mi.mrf_ct_q8_plain(x, mrf, tile), flops=0,
                    nbytes=2 * Bx * Tx * C * 2 + self.q8_wbytes(mrf, C),
                    int8_ops=self.n_ops * Bx * Tx * C * C)

    def fused_mrf_phase_q8(self, key):
        mi = self.mi
        x, p16, p_in, post, scales = self._narrow(key)
        mode = key[3]
        p = 2 * p_in
        ph = None if mode == 'dynamic' else [
            s[i] for s1, s2 in scales for i in range(s1.shape[0])
            for s in (s1, s2)]
        qw = mi.quantize_mrf_phase_weights(
            mi.pack_mrf_phase_weights(p16, 0, self.ks, self.dils, p), self.ks,
            self.dils, p, ph)
        C_in = key[2]
        wb, bu, _, _ = mi.pack_ups_phase_weights(
            p16['ups_0']['w'], p16['ups_0']['b'], 2, 1, p_in)
        ups = mi.quantize_ups_phase_weights(
            wb, bu, mi.ups_used_blocks(4, 2, 1, p_in), C_in)
        pst = mi.pack_post_phase_weights(p16['conv_post']['w'],
                                         p16['conv_post']['b'], p) \
            if post else None
        mrf = mi.prepare_mrf_phase_q8(qw, self.ks, self.dils, p,
                                      tuple(ups) + (4, 2, 1, p_in), pst)
        tile = self.vk.ptc_tile(x.shape[1] // p_in)
        Bx, T_in = key[:2]
        out = f'({Bx},1,{2 * T_in})' if post else \
            f'({Bx},{2 * T_in},{C_in // 2})'
        return dict(desc=f'{mode} x ({Bx},{T_in},{C_in}) -> {out} bf16 '
                    f'tile {tile}', band=2e-3,
                    fn=lambda: mi.fused_mrf_phase_q8(x, mrf, tile),
                    plain=lambda: mi.mrf_phase_q8_plain(x, mrf, tile),
                    **self._narrow_work(key, mrf, post))


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
                              'mrf::step_q8_kernel', 'mrf::conv_dyn_kernel',
                              'mrf::ups_q8_kernel', 'mrf::amax_kernel',
                              'mrf::post_kernel', 'attn::', 'Memcpy')
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
    from daft_exprt_torch.generate import Synthesizer, generate_mel_specs
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.daft_exprt import DaftExprt
    from daft_exprt_torch.models.hifigan import (
        DEFAULT_CONFIG, HiFiGanVocoder, generator_forward,
        init_generator_params,
    )
    from daft_exprt_torch.ops import _build
    from daft_exprt_torch.ops import mrf_int8 as mi
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
    errs = {}

    # the float32 route of the tc kernel (not on a serving path)
    w32 = vk.pack_mrf_tc_weights(level_params(torch, gen, 512, 256, ks, dils,
                                              dev), 0, ks, dils)
    x32 = torch.randn((B, T * 8, 256), generator=gen).to(dev)
    out32 = vk.fused_mrf_tc(x32, vk.prepare_mrf(w32, ks, dils))
    ref32 = vk.mrf_tc_plain(x32, w32, ks, dils)
    torch.cuda.synchronize()
    r32 = rel_l2(out32.float(), ref32.float())
    log(f'check fused_mrf_tc L0 float32: max_abs='
        f'{max_abs(out32.float(), ref32.float()):.3e} rel_l2={r32:.3e} '
        '(band 1e-05)')
    assert r32 <= 1e-5, r32
    del w32, x32, out32, ref32

    # ---- 3. the paths ------------------------------------------------------
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
               vk.fused_mrf_tc_q8, vk.fused_mrf_ptc, mi.fused_mrf_ct_q8,
               mi.fused_mrf_phase_q8)
    paths = []          # (tier, launches by kernel, calls by kernel and key)

    def synthesizer(voc):
        def synthesize(ranges=False):
            with _range(torch, 'acoustic', ranges):
                mel, _, _ = synth.infer(**batch)
            with _range(torch, 'vocoder', ranges):
                return mel, voc.infer(mel)
        return synthesize

    def run_path(tier, body, path_kernels):
        """One call of ``body`` with every launch counter at 0 before it;
        records the launches and calls read just after."""
        for kern in kernels:
            kern.launches = 0
            kern.calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = body()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        n = {kern.__name__: kern.launches for kern in kernels}
        calls = {kern.__name__: dict(kern.calls) for kern in kernels}
        log(f'path {tier}: first call {first_s:.2f} s; launches {n}; calls '
            f'by input shape {calls}')
        for kern in kernels:
            name = kern.__name__
            if kern in path_kernels:
                assert n[name] > 0, f'the {tier} path never launched {name}'
            else:
                assert n[name] == 0, f'the {tier} path launched {name}'
        paths.append((tier, {k.__name__: n[k.__name__] for k in path_kernels},
                      {k.__name__: calls[k.__name__] for k in path_kernels}))
        return out

    def check_b8(tier, mel, wav):
        assert mel.shape == (B, hp.n_mel_channels, T), mel.shape
        assert wav.shape == (B, T * 256), wav.shape
        assert np.isfinite(mel).all() and np.isfinite(wav).all()

    def plain_int8(voc, mel):
        """The vocoder's int8 route through the kernels' plain versions on
        the card, padded and cropped as HiFiGanVocoder.infer does."""
        m = torch.as_tensor(np.asarray(mel, np.float32))
        if m.ndim == 2:
            m = m[None]
        T0 = m.shape[-1]
        m = F.pad(m, (0, -(-T0 // 128) * 128 - T0), value=math.log(1e-5))
        with torch.no_grad():
            w = generator_forward(voc.params, m.to(dev, bf16), DEFAULT_CONFIG,
                                  use_fast=True, packed=voc.packed,
                                  int8=voc.int8,
                                  int8_act_scales=voc.act_scales, plain=True)
        return np.clip(w.float().cpu().numpy()[:, 0, :T0 * 256], -1.0, 1.0)

    synthesize = synthesizer(vocoder)
    mel, wav = run_path('bf16', synthesize, kernels[:3])
    check_b8('bf16', mel, wav)
    exact = HiFiGanVocoder(voc_params, fast=False).infer(mel)
    r = rel(wav, exact)
    log(f'path bf16: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), |wav| max {np.abs(exact).max():.3e}')
    assert r <= 5e-2, r

    def int8_path(tier, voc, path_kernels):
        fn = synthesizer(voc)
        mel_q, wav_q = run_path(tier, fn, path_kernels)
        check_b8(tier, mel_q, wav_q)
        r_plain = rel(wav_q, plain_int8(voc, mel_q))
        r_bf16 = rel(wav_q, vocoder.infer(mel_q))
        log(f'path {tier}: waveform vs the plain int8 route rel_l2='
            f'{r_plain:.3e} (band 1e-2), vs the bf16 tier rel_l2='
            f'{r_bf16:.3e} (band 0.25), |wav| max {np.abs(wav_q).max():.3e}')
        assert r_plain <= 1e-2, r_plain
        assert r_bf16 <= 0.25, r_bf16
        return fn

    # the int8-static tier, calibrated on the batch's first four mels as
    # bench.py does (bench.py:136-140)
    t0 = time.perf_counter()
    vocoder_q8 = HiFiGanVocoder(voc_params, fast='int8',
                                int8_calibration_mels=mel[:4])
    log(f'path int8: calibration and int8 packing '
        f'{time.perf_counter() - t0:.2f} s')
    synthesize_q8 = int8_path('int8', vocoder_q8, (
        fused_attention, vk.fused_mrf_tc_q8, vk.fused_mrf_ptc))
    t0 = time.perf_counter()
    vocoder_dyn = HiFiGanVocoder(voc_params, fast='int8')
    log(f'path int8-dynamic: int8 packing {time.perf_counter() - t0:.2f} s')
    synthesize_dyn = int8_path('int8-dynamic', vocoder_dyn, (
        fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8))

    # the serving entry point at batch 1, each tier
    sentences, prosody, stats = entry_inputs(hp, SEED)
    hp.stats = stats
    emb = np.random.RandomState(SEED).randn(hp.external_emb_dim).astype(
        np.float32)
    try:
        import matplotlib  # noqa: F401
        save = True
    except ImportError:
        save = False
    log('entry point: ' + ('matplotlib present: generate_mel_specs saves '
                           'npz, png and wav' if save else 'no matplotlib: '
                           'save_outputs=False, the path vocodes each mel '
                           'through synthesizer.vocoder.infer'))
    names = [f'utt{i}' for i in range(len(UTT_FRAMES))]

    class RangedSynthesizer(Synthesizer):
        """The acoustic model's calls in the profiler's 'acoustic' range and
        the vocoder's in its 'vocoder' range."""

        def infer(self, *a, **kw):
            with _range(torch, 'acoustic', True):
                return super().infer(*a, **kw)

    class RangedVocoder:
        def __init__(self, voc):
            self.voc = voc

        def infer(self, mel):
            with _range(torch, 'vocoder', True):
                return self.voc.infer(mel)

    entry_fns = {}
    for tier, voc, kern in (
            ('entry-int8-static', vocoder_q8, (
                fused_attention, vk.fused_mrf_tc_q8, mi.fused_mrf_phase_q8)),
            ('entry-int8-dynamic', vocoder_dyn, (
                fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8))):
        out_dir = os.path.join(ROOT, 'build', 'smoke', tier)

        def entry(ranges=False, out_dir=out_dir, voc=voc):
            entry_synth = RangedSynthesizer(
                model, hp, vocoder=RangedVocoder(voc)) if ranges else \
                Synthesizer(model, hp, vocoder=voc)
            preds = generate_mel_specs(
                entry_synth, sentences, names, [0] * len(names), out_dir,
                hp, batch_size=1, get_time_perf=True,
                external_prosody=prosody, external_embeddings=emb,
                external_accent_emb=emb[:model.hidden_dim],
                save_outputs=save)
            wavs = None if save else {
                k: entry_synth.vocoder.infer(v[4]) for k, v in preds.items()
                if k != '__rtf__'}
            return preds, wavs

        preds, wavs = run_path(tier, entry, kern)
        frames = [preds[f'{n}_spk_0'][4].shape[1] for n in names]
        log(f'path {tier}: {len(names)} utterances of {frames} frames, RTF '
            f'{preds["__rtf__"]:.2f} (host clock, first call)')
        for n in names:
            key = f'{n}_spk_0'
            m = preds[key][4]
            if save:
                for ext in ('npz', 'png', 'wav'):
                    assert os.path.isfile(os.path.join(out_dir,
                                                       f'{key}.{ext}'))
            w = wavs[key] if wavs else voc.infer(m)
            assert w.shape == (m.shape[1] * 256,) and np.isfinite(w).all()
            r = rel(w, plain_int8(voc, m)[0])
            log(f'path {tier} {key}: {m.shape[1]} frames, waveform vs the '
                f'plain int8 route rel_l2={r:.3e} (band 1e-2)')
            assert r <= 1e-2, r
        entry_fns[tier] = entry
        t0 = time.perf_counter()
        again = entry()[0]['__rtf__']
        log(f'path {tier}: RTF {again:.2f} on a second call '
            f'({time.perf_counter() - t0:.2f} s, host clock)')

    # ---- 4. each kernel at each shape a path called it with ----------------
    cases = KernelCases(torch, F, vk, mi, (fused_attention, attention_plain),
                        dev, ks, dils)
    by_name = {kern.__name__: kern for kern in kernels}
    measured = {}

    def measure(name, key):
        c = cases.case(name, key)
        n0 = by_name[name].launches
        out = c['fn']()
        per_launch = by_name[name].launches - n0     # launches per call
        ref = c['plain']()
        torch.cuda.synchronize()
        assert out.shape == ref.shape, (name, key, out.shape, ref.shape)
        assert torch.isfinite(out.float()).all(), (name, key)
        r, m = rel_l2(out.float(), ref.float()), max_abs(out.float(),
                                                          ref.float())
        del out, ref
        log(f'check {name} {c["desc"]}: max_abs={m:.3e} rel_l2={r:.3e} '
            f'(band {c["band"]:g})')
        assert r <= c['band'], f'{name} {key}: rel-L2 {r} above {c["band"]}'
        errs.setdefault(name, []).append(m)
        ms = time_ms(torch, c['fn'])
        plain_ms = time_ms(torch, c['plain'])
        lib_ms = time_ms(torch, c['lib']) if 'lib' in c else None
        b_ms, b_by = bound(c['flops'], c['nbytes'], c.get('int8_ops', 0))
        log(f'time {name} {c["desc"]}: ms={ms:.4f} plain_ms={plain_ms:.4f} '
            f'library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} '
            f'bound_ms={b_ms:.4f} ({b_by}), {per_launch} launches per call')
        return dict(shape=c['desc'], launches_per_call=per_launch, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs=m, rel_l2=r)

    per_path = {}
    for tier, launches, calls in paths:
        for name, by_key in calls.items():
            rows = []
            for key, n in sorted(by_key.items(), key=str):
                if (name, key) not in measured:
                    measured[name, key] = measure(name, key)
                rows.append(dict(measured[name, key], path=tier,
                                 per_call=n))
            counted = sum(r['per_call'] * r['launches_per_call']
                          for r in rows)
            assert counted == launches[name], (
                f'{tier} {name}: {launches[name]} launches on the path, '
                f'{counted} from its calls by shape times launches per call')

            def total(k, rows=rows):
                return sum(r[k] * r['per_call'] for r in rows)
            per_path.setdefault(name, {})[tier] = dict(
                launches=launches[name], ms=total('ms'),
                plain_ms=total('plain_ms'), bound_ms=total('bound_ms'),
                library_ms=None if any(r['library_ms'] is None for r in rows)
                else total('library_ms'),
                bound_by=max(rows, key=lambda r: r['bound_ms'] * r['per_call']
                             )['bound_by'], rows=rows)

    sources = {'fused_attention': 'daft_exprt_torch/ops/csrc/attention_fwd.cu',
               'fused_mrf_tc': 'daft_exprt_torch/ops/csrc/mrf_tc.cu',
               'fused_mrf_phase': 'daft_exprt_torch/ops/csrc/mrf_phase.cu',
               'fused_mrf_tc_q8': 'daft_exprt_torch/ops/csrc/mrf_tc_q8.cu',
               'fused_mrf_ptc': 'daft_exprt_torch/ops/csrc/mrf_ptc.cu',
               'fused_mrf_ct_q8': 'daft_exprt_torch/ops/csrc/mrf_ct_q8.cu',
               'fused_mrf_phase_q8':
               'daft_exprt_torch/ops/csrc/mrf_phase_q8.cu'}
    replaces = {
        'fused_attention': 'daft_exprt_tpu/ops/attention_kernels.py:170',
        'fused_mrf_tc': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_phase': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_tc_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_ptc': 'daft_exprt_tpu/ops/vocoder_kernels.py:1999',
        'fused_mrf_ct_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:450',
        'fused_mrf_phase_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431'}
    # each kernel's main path: the first B=8 path that runs it
    table = []
    for kern in kernels:
        name = kern.__name__
        main_tier = next(t for t, _, c in paths if name in c)
        m = per_path[name][main_tier]
        table.append(dict(
            name=name, route='cuda', source=sources[name],
            replaces=replaces[name], launches=m['launches'],
            max_abs_err=max(errs[name]), ms=m['ms'], plain_ms=m['plain_ms'],
            bound_ms=m['bound_ms'], bound_by=m['bound_by'],
            library_ms=m['library_ms'], main_path=main_tier,
            paths={t: {k: v for k, v in d.items() if k != 'rows'}
                   for t, d in per_path[name].items()},
            per_shape=[r for d in per_path[name].values()
                       for r in d['rows']]))

    # ---- 5. end to end ----------------------------------------------------
    audio_s = B * T * 256 / DEFAULT_CONFIG['sampling_rate']
    for tier, synth_fn in (('bf16', synthesize), ('int8', synthesize_q8),
                           ('int8-dynamic', synthesize_dyn)):
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
        profile_path(torch, synthesize_dyn, 'int8-dynamic')
        for tier, fn in entry_fns.items():
            profile_path(torch, fn, tier)

    log(json.dumps({'kernels': table}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

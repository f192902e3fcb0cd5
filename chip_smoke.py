#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daft_exprt_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels of daft_exprt_torch/ops/csrc into build/ (one
   nvcc per source, all at once) and prints the build seconds.
3. Drives the synthesis path through the user entry points with seeded
   random weights, each path with every launch counter set to 0 just
   before it and read just after:
   - bf16, B=8 requests x L=128 symbols x T=1024 frames: Synthesizer.infer
     + HiFiGanVocoder(fast='bf16').infer (fused_mrf_tc at L0/L1, one
     launch per chain, and fused_mrf_phase at L2/L3, one launch a level,
     both on the block-resident bf16 engine of ops/csrc/mrf_chain_bf16.cuh);
     the waveform against the float32 plain route, rel-L2 <= 5e-2;
   - int8-static, B=8 (bench.py's headline route): HiFiGanVocoder(
     fast='int8', int8_calibration_mels=mel[:4]), calibrated as bench.py
     does; the waveform against the port's plain int8 route (the kernels'
     plain versions on the card), rel-L2 <= 1e-2, and against the bf16
     tier, rel-L2 <= 0.25 (NUMERICS_r05.json vocoder_int8_vs_bf16);
   - int8-dynamic, B=8: HiFiGanVocoder(fast='int8') without calibration
     mels (fused_mrf_ct q8 at L0/L1, the dynamic int8 fused_mrf_phase at
     L2/L3, all four on the segment-synchronised engine of
     ops/csrc/mrf_dyn_blk.cuh), the same two bands;
   - int8-partial, B=8: generator_forward on the bf16 path's mel with the
     int8-static calibration restricted to L0 and L1 (and pack_levels
     with the same dict): fused_mrf_tc q8 at L0/L1, fused_mrf_ptc in its
     dyn mode at L2/L3; the same two bands;
   - bf16-ptc, B=8: HiFiGanVocoder(fast='bf16', ptc_bf16=True) (the JAX
     package's DAFT_MRF_PTC_BF16=1) behind the Synthesizer: fused_mrf_tc
     at L0/L1, fused_mrf_ptc's fdot mode at L2/L3; the waveform against
     the float32 plain route (rel-L2 <= 5e-2) and the banded bf16 tier
     (<= 3e-2, NUMERICS_r05.json ptc_bf16_vs_banded_bf16);
   - HiFi-GAN V2 (jik876/hifi-gan config_v2.json: V1 at 128 initial
     channels, levels of C = 64/32/16/8) behind the same Synthesizer at
     B=8 x 1024 frames, each tier: bf16 (fused_mrf_ct at L0,
     fused_mrf_phase without prologue at L1-L3), int8-static (mel[:4]
     calibration: fused_mrf_ct q8f at L0, the int8 fused_mrf_phase q8f
     without prologue at L1, bf16 at L2/L3) and int8-dynamic (the same in
     q8); each waveform against the float32 plain route (bf16, 5e-2) or
     the plain int8 route and the V2 bf16 tier (1e-2, 0.25); then
     v2-int8-unfused, the int8-static tier with int8_fused=False (the JAX
     package's DAFT_INT8_FUSED_EPI=0): fused_mrf_ct q8s at L0, the int8
     fused_mrf_phase q8s without prologue at L1, the same bands;
   - v2-ct-fallback: generator_forward at 12 frames (no phase tile divides
     L1 and L2, which take fused_mrf_ct) in each V2 tier, against the
     kernels' plain versions (rel-L2 <= 1e-2);
   - the serving entry point at batch 1: generate_mel_specs(batch_size=1)
     over three utterances of about 200, 640 and 1024 frames (so the ct
     tile changes) with the int8-static vocoder (its narrow levels below
     the phase-tc batch: the q8f int8 fused_mrf_phase), then with the
     int8-dynamic one; each utterance's waveform against the plain int8
     route, rel-L2 <= 1e-2; prints the RTF; then entry-int8-unfused, the
     same with the int8-static vocoder at int8_fused=False (the q8s int8
     fused_mrf_phase with its prologue at L2/L3). With matplotlib the entry
     point saves its outputs (npz, png, wav); without it, it runs with
     save_outputs=False and the path vocodes each mel itself through
     synthesizer.vocoder.infer. It prints which.
   - resblock1: fused_resblock1 (one ResBlock1 chain; no path of the JAX
     package calls it) through its wrapper at (8, 8192, 256) and (8,
     65536, 128), k in {3, 7, 11}, dilations (1, 3, 5), bf16 and float32:
     one launch a call (tc_bf_kernel in bf16, tc_f32_kernel in float32,
     3xTF32 on the tensor cores), 6 + 6 launches, checked;
   - tc-f32: fused_mrf_tc in float32 at V1's L0 shape (8, 8192, 256), one
     tc_f32_kernel launch per chain (3, checked), against its plain
     version (TF32 off), rel-L2 <= 1e-5.
   Each path checks its outputs' shape and finiteness and that every kernel
   of its path, and no other, was launched.
   Then training, default HyperParams (4+4+4 FFT blocks, width 128, 2
   heads of 64, conv 1024, dropout 0.1, bf16 compute, all five loss terms
   with a seeded random PitchPredictor), seeded random weights:
   - train-step: bench_train_step.py's shape, B=16 x L=128 x T=1024, five
     steps of make_train_step (every loss and the grad norm finite;
     attention forward 12 launches a step, backward 12 calls a step, no
     vocoder kernel); then the first step again from the same parameters
     and seed with the plain attention on the card (fused=False; the masks
     are the same by construction): loss rel <= 1e-2, grad norm rel <=
     5e-2 (bf16 rounds at other points in the two routes);
   - train-step-f32: the same with compute_dtype='float32', three steps:
     every FFT block's attention on the float32 kernels (3xTF32 on the
     tensor cores; 12 forward launches and 12 backward calls a step, every
     call float32, no vocoder kernel); the first step again with the plain
     attention: loss rel <= 1e-3, grad norm rel <= 5e-3 (10x tighter than
     bf16: the kernels agree with the plain attention to about 1e-6, and
     the rest of the step is the same float32 code, cuDNN TF32 in the convs
     on both sides);
   - train: the train() entry point on its own synthetic dataset under
     build/smoke/train (two speakers, 40 utterances of 100-128 symbols and
     800-1024 frames): batch 16, 4 iterations, a validation at 4, a
     checkpoint; then a resume from it to iteration 6, checking the
     iteration and the optimizer state.
4. At every input shape a path called a kernel with: the kernel against
   its plain PyTorch version on the same inputs (unit-gain random weights):
   rel-L2 <= 1e-2 in bf16 (summation order only), <= 1e-5 in float32,
   <= 2e-3 for the int8 kernels (NUMERICS_r05.json ptc_vs_banded_int8),
   and max-abs 0 for the dynamic engine (fused_mrf_ct q8 at C = 256/128,
   fused_mrf_phase q8 at V1's L2/L3) and fused_mrf_phase's q8f calls on
   ptc_fused_q8_kernel (a conv_post waveform: within one bf16 ulp);
   its launches per call; its time (median of 10 calls), its plain
   version's (median of 3) and (attention) the library call's, with CUDA
   events, beside the least time the card could take (H100 SXM: 989
   TFLOP/s bf16, 494.7/3 TFLOP/s for float32 on the tensor cores in
   3xTF32 (the float32 attention, fused_mrf_tc and fused_resblock1; their
   bound at the 67 TFLOP/s float32 FMA rate is printed beside it,
   fma_bound_ms), 1979 TOP/s int8, 3.35 TB/s) and, for the attention, the
   names of the kernels the library call launched (its backend). Each
   wrapper counts its CUDA launches and its calls by input shape (the
   attention wrappers by shape, dropout rate and type, the multi-mode MRF
   wrappers by shape and mode); the run fails unless, on every path, the
   calls times the launches per call add up to the launch count. The
   attention forward and backward are also checked and timed at p = 0 at
   each training shape, in bf16 and in float32, and in float32 at T =
   2500, past the old limit of 2048 (their "off_path" rows in the JSON,
   beside SDPA's time); two calls of the backward must be bit-identical.
   The kernels' JSON has one entry per kernel and mode ("name[mode]"; the
   float32 calls of the attention and of fused_mrf_tc are their "float32"
   mode, main paths train-step-f32 and tc-f32).
5. Prints the end-to-end audio-seconds per second of the B=8 synthesis
   paths and the train-step path's steps/s and utterances/s (host clock,
   synchronised after each step).

``--profile`` adds a torch.profiler pass over one synthesis call of each
B=8 tier, one generate_mel_specs call of each batch-1 path and one train
step in bf16 and one in float32: device time by kernel, the acoustic/
vocoder (forward/backward/optimizer) split, the device's busy share and
the attention kernels' share of the busy time.

The float32 calls of fused_mrf_ct at V2's L0 and L3 shapes are held to
their plain version at rel-L2 <= 1e-5 before the paths run.

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
PEAK_F32 = 67e12             # H100 SXM float32 outside the tensor cores
PEAK_TF32 = 494.7e12         # H100 SXM dense TF32 tensor-core rate
PEAK_INT8 = 1979e12          # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
B, L, T = 8, 128, 1024       # requests, symbols, frames
UTT_FRAMES = (200, 640, 1024)   # the batch-1 entry point's utterances
SEED = 1234
# HiFi-GAN V2 (jik876/hifi-gan config_v2.json): V1 at 128 initial channels
V2_CHANNELS = 128
V2_FALLBACK_FRAMES = 12      # no phase tile divides L1 and L2: fused_mrf_ct
TB, TL, TT = 16, 128, 1024   # bench_train_step.py's batch, symbols, frames
TRAIN_STEPS = 5
TRAIN_STEPS_F32 = 3          # train-step-f32: compute_dtype='float32'
ATTN_LONG_F32 = (4, 2, 2500, 64, 0.1, 'float32')   # past the old T <= 2048


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


def make_train_batch(hp, B, L, T, seed=0):
    """Own numpy copy of the JAX repo's __graft_entry__._make_batch (all
    training fields)."""
    rng = np.random.RandomState(seed)
    dur_int = np.full((B, L), T // L, dtype=np.int64)
    dur_int[:, -1] += T - (T // L) * L
    return dict(
        symbols=rng.randint(1, hp.n_symbols, (B, L)),
        durations_float=(dur_int * hp.hop_length / hp.sampling_rate
                         ).astype(np.float32),
        durations_int=dur_int,
        symbols_energy=rng.randn(B, L).astype(np.float32),
        symbols_pitch=rng.randn(B, L).astype(np.float32),
        input_lengths=np.full((B,), L, dtype=np.int64),
        frames_energy=rng.randn(B, T).astype(np.float32),
        frames_pitch=rng.randn(B, T).astype(np.float32),
        mel_specs=rng.randn(B, hp.n_mel_channels, T).astype(np.float32),
        output_lengths=np.full((B,), T, dtype=np.int64),
        speaker_ids=np.zeros((B,), dtype=np.int64),
        spk_embs=rng.randn(B, hp.external_emb_dim).astype(np.float32),
    )


def write_train_dataset(root, symbols, n_per_speaker=20, seed=SEED):
    """A synthetic feature dataset in the layout of the JAX repo's
    tests/synth_data.py: two speakers, utterances of 100-128 symbols and
    800-1024 frames; every tenth line goes to the validation list.
    Returns (train list, validation list)."""
    rng = np.random.RandomState(seed)
    hop_s = 256 / 22050
    lines = []
    for spk in range(2):
        spk_dir = os.path.join(root, 'features', f'speaker_{spk}')
        os.makedirs(spk_dir, exist_ok=True)
        for i in range(n_per_speaker):
            name = f'utt_{i:03d}'
            base = os.path.join(spk_dir, name)
            L, T = rng.randint(100, 129), rng.randint(800, 1025)
            dur = np.full(L, T // L, dtype=np.int64)
            dur[rng.choice(L, T - dur.sum(), replace=False)] += 1
            np.save(f'{base}.npy', (rng.randn(80, T) * 0.5 - 4.0).astype(
                np.float32))
            ids = rng.randint(7, len(symbols), size=L)
            with open(f'{base}.markers', 'w') as f:
                t = 0.0
                for j in range(L):
                    d = dur[j] * hop_s
                    f.write(f'{t:.3f}\t{t + d:.3f}\t{dur[j]}\t'
                            f'{symbols[ids[j]]}\tword\t{j}\n')
                    t += d
            tracks = {
                'frames_nrg': np.abs(rng.randn(T)) * 5 + 8,
                'frames_f0': np.where(rng.rand(T) < 0.8,
                                      rng.randn(T) * 0.2 + 5.0, 0.0),
                'symbols_nrg': np.abs(rng.randn(L)) * 5 + 8,
                'symbols_f0': np.where(rng.rand(L) < 0.8,
                                       rng.randn(L) * 0.2 + 5.0, 0.0)}
            for ext, track in tracks.items():
                with open(f'{base}.{ext}', 'w') as f:
                    f.writelines(f'{v:.3f}\n' for v in track)
            np.save(f'{base}.spk_emb.npy', rng.randn(192).astype(np.float32))
            lines.append(f'{spk_dir}|{name}|{spk}\n')
    train_list = os.path.join(root, 'train.txt')
    val_list = os.path.join(root, 'val.txt')
    with open(train_list, 'w') as f:
        f.writelines(l for i, l in enumerate(lines) if i % 10 != 9)
    with open(val_list, 'w') as f:
        f.writelines(lines[9::10])
    return train_list, val_list


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


def bound(flops, nbytes, int8_ops=0, f32_flops=0, tf32x3_flops=0):
    """Least time in ms: the bf16 flops, float32 flops (outside the tensor
    cores), float32-accurate flops on the tensor cores (3xTF32: a third of
    the TF32 rate) and int8 operations at their peak rates against the
    bytes at the memory rate."""
    t_op = (flops / PEAK_FLOPS + f32_flops / PEAK_F32
            + tf32x3_flops / (PEAK_TF32 / 3) + int8_ops / PEAK_INT8) * 1e3
    t_by = nbytes / PEAK_BYTES * 1e3
    return (t_op, 'operations') if t_op >= t_by else (t_by, 'bytes')


def library_kernels(torch, fn):
    """The CUDA kernels one call of ``fn`` launches (torch.profiler): the
    backend of a library call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


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

    def __init__(self, torch, F, vk, mi, mc, attn, dev, ks, dils):
        self.torch, self.F, self.vk, self.mi, self.mc = torch, F, vk, mi, mc
        self.attn = attn   # (fused_attention, attention_plain, the backward's)
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

    def _attention_inputs(self, key, n):
        """Inputs of an attention key (B, H, T, D, p[, 'float32']): bf16
        unless the key names float32."""
        torch = self.torch
        Bx, H, t, D, p = key[:5]
        dt = torch.float32 if key[5:] == ('float32',) else torch.bfloat16
        q, *rest = (torch.randn((Bx, H, t, D), generator=self.gen).to(
            self.dev, dt) for _ in range(n))
        lengths = torch.tensor([t - 37 * i for i in range(Bx)],
                               dtype=torch.int32, device=self.dev).clamp(min=1)
        mask = (torch.arange(t, device=self.dev)[None, :] < lengths[:, None]
                )[:, None, None, :]
        seed = torch.tensor([SEED], dtype=torch.int64, device=self.dev)
        return [q * D ** -0.5] + rest, lengths, mask, seed

    @staticmethod
    def _attention_work(key, products, tensors):
        """desc suffix, band and bound keywords of an attention key: bf16 on
        the tensor cores at the bf16 rate, or float32 on the tensor cores in
        3xTF32 (three TF32 products per product: 494.7/3 TFLOP/s)."""
        Bx, H, t, D, p = key[:5]
        f32 = key[5:] == ('float32',)
        flops = 2 * products * Bx * H * t * t * D
        return (f'({Bx},{H},{t},{D}) {"float32" if f32 else "bf16"} p={p:g}',
                1e-5 if f32 else 1e-2,
                dict(flops=0, tf32x3_flops=flops) if f32
                else dict(flops=flops),
                tensors * Bx * H * t * D * (4 if f32 else 2))

    def fused_attention(self, key):
        p = key[4]
        (q, k, v), lengths, mask, seed = self._attention_inputs(key, 3)
        desc, band, work, nbytes = self._attention_work(key, 2, 4)
        return dict(desc=f'q,k,v {desc}', band=band,
                    fn=lambda: self.attn[0](q, k, v, lengths, seed, p),
                    plain=lambda: self.attn[1](q, k, v, lengths, seed, p),
                    lib=lambda: self.F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, dropout_p=p, scale=1.0),
                    nbytes=nbytes, **work)

    def fused_attention_bwd(self, key):
        """(dq, dk, dv) for a random output gradient; the library call is
        the autograd backward of scaled_dot_product_attention (one
        forward, its graph kept)."""
        torch = self.torch
        p = key[4]
        (q, k, v, do), lengths, mask, seed = self._attention_inputs(key, 4)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = self.F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, dropout_p=p, scale=1.0)
        desc, band, work, nbytes = self._attention_work(key, 5, 7)
        return dict(desc=f'q,k,v,do {desc}', band=band, repeat_equal=True,
                    fn=lambda: self.attn[2](q, k, v, do, lengths, seed, p),
                    plain=lambda: self.attn[3](q, k, v, do, lengths, seed, p),
                    lib=lambda: torch.autograd.grad(out, leaves, do,
                                                    retain_graph=True),
                    nbytes=nbytes, **work)

    def fused_mrf_tc(self, key):
        """key: x's shape, and 'float32' for a float32 call (on the tensor
        cores in 3xTF32: its flops at a third of the TF32 rate)."""
        torch, vk = self.torch, self.vk
        Bx, Tx, C = key[:3]
        f32 = key[3:] == ('float32',)
        dt = torch.float32 if f32 else torch.bfloat16
        wb = [t.to(dt) for t in vk.pack_mrf_tc_weights(
            self.params(2 * C, C), 0, self.ks, self.dils)]
        mrf = vk.prepare_mrf(wb, self.ks, self.dils)
        x = self.randn(Bx, Tx, C).to(dt)
        wbytes = sum(t.numel() * t.element_size() for t in wb)
        flops = 252 * Bx * Tx * C * C
        return dict(desc=f'x ({Bx},{Tx},{C}) {"float32" if f32 else "bf16"}',
                    band=1e-5 if f32 else 1e-2,
                    fn=lambda: vk.fused_mrf_tc(x, mrf),
                    plain=lambda: vk.mrf_tc_plain(x, wb, self.ks, self.dils),
                    **(dict(flops=0, tf32x3_flops=flops) if f32
                       else dict(flops=flops)),
                    nbytes=2 * Bx * Tx * C * x.element_size() + wbytes)

    def _phase_float(self, key, mrf, fn, plain):
        """A float narrow level's case: x a transposed (B, T, C) tensor, as
        the path hands it over."""
        Bx, C_in, T_in = key[:3]
        C, post = C_in // 2, mrf.post is not None
        x = self.randn(Bx, T_in, C_in).transpose(1, 2)
        N = 2 * T_in
        c_out = 1 if post else C
        wbytes = sum(t.numel() * t.element_size() for t in mrf.packed) + \
            mrf.ups[0].numel() * 2
        return dict(desc=f'x ({Bx},{C_in},{T_in}) -> ({Bx},{c_out},{N}) bf16',
                    band=1e-2, fn=lambda: fn(x, mrf), plain=lambda: plain(x, mrf),
                    flops=252 * Bx * N * C * C + 2 * Bx * N * C_in * C * 2
                    + (2 * Bx * N * C * 7 if post else 0),
                    nbytes=Bx * C_in * T_in * 2 + Bx * c_out * N * 2 + wbytes)

    def fused_mrf_phase(self, key):
        vk = self.vk
        C_in = key[1]
        C, post = C_in // 2, C_in == 64
        p = self.bf16(self.params(C_in, C, post=post))
        mrf = vk.prepare_mrf(
            vk.pack_mrf_tc_weights(p, 0, self.ks, self.dils), self.ks,
            self.dils, (p['ups_0']['w'], p['ups_0']['b'], 2, 1),
            (p['conv_post']['w'], p['conv_post']['b']) if post else None)
        return self._phase_float(key, mrf, vk.fused_mrf_phase,
                                 lambda x, m: vk.mrf_phase_plain(
                                     x, m.packed, m.kernel_sizes, m.dilations,
                                     m.ups, m.post))

    def fused_mrf_ptc_f(self, key):
        """fused_mrf_ptc's fdot mode (key: x's shape and 'fdot')."""
        vk = self.vk
        C_in, T_in = key[1:3]
        C, post = C_in // 2, C_in == 64
        p_in = 1 if C_in == 128 else 2
        p16 = self.bf16(self.params(C_in, C, post=post))
        mrf = vk.prepare_mrf_ptc_f(
            vk.pack_mrf_ptc_f_weights(p16, 0, self.ks, self.dils, 2 * p_in),
            self.ks, self.dils, 2 * p_in, tuple(vk.pack_ups_ptc_f_weights(
                p16['ups_0']['w'], p16['ups_0']['b'], 2, 1, p_in))
            + (4, 2, 1, p_in), vk.pack_post_ptc_weights(
                p16['conv_post']['w'], p16['conv_post']['b'], 2 * p_in,
                self.torch.bfloat16) if post else None)
        tile = vk.ptc_tile(T_in // p_in, 4096)
        c = self._phase_float(key, mrf,
                              lambda x, m: vk.fused_mrf_ptc_f(x, m, tile),
                              lambda x, m: vk.mrf_ptc_f_plain(x, m, tile))
        c['desc'] = f'fdot {c["desc"]} tile {tile}'
        return c

    def fused_resblock1(self, key):
        """One ResBlock1 chain (key: x's shape, k, dilations, dtype)."""
        torch, vk = self.torch, self.vk
        Bx, Tx, C, k, dils, dname = key
        dt = getattr(torch, dname)
        rb = {f'{pre}_{i}': {'w': ((C * k) ** -0.5 * torch.randn(
            (C, C, k), generator=self.gen)).to(self.dev),
            'b': (0.05 * torch.randn(C, generator=self.gen)).to(self.dev)}
            for pre in ('convs1', 'convs2') for i in range(len(dils))}
        w = [t.to(dt) for t in vk.pack_resblock_weights(rb, len(dils))]
        x = torch.randn((Bx, Tx, C), generator=self.gen).to(self.dev, dt)
        tile = min(4096, Tx)
        f32 = dt == torch.float32
        flops = 4 * len(dils) * k * Bx * Tx * C * C
        esz = x.element_size()
        # float32: on the tensor cores in 3xTF32 (a third of the TF32 rate)
        return dict(desc=f'x ({Bx},{Tx},{C}) {dname} k={k} d={dils}',
                    band=1e-5 if f32 else 1e-2,
                    fn=lambda: vk.fused_resblock1(x, *w, k, dils, tile),
                    plain=lambda: vk.resblock1_plain(x, *w, k, dils, tile),
                    flops=0 if f32 else flops,
                    tf32x3_flops=flops if f32 else 0,
                    nbytes=2 * Bx * Tx * C * esz
                    + sum(t.numel() * esz for t in w))

    def _ct_float(self, key, fn, plain):
        vk = self.vk
        Bx, Tx, C = key
        wb = [t.to(self.torch.bfloat16) for t in vk.pack_mrf_tc_weights(
            self.params(2 * C, C), 0, self.ks, self.dils)]
        mrf = vk.prepare_mrf(wb, self.ks, self.dils)
        x = self.randn(Bx, Tx, C)
        wbytes = sum(t.numel() * t.element_size() for t in wb)
        return dict(desc=f'x ({Bx},{Tx},{C}) bf16', band=1e-2,
                    fn=lambda: fn(x, mrf), plain=lambda: plain(x, mrf),
                    flops=252 * Bx * Tx * C * C,
                    nbytes=2 * Bx * Tx * C * 2 + wbytes)

    def fused_mrf_ct(self, key):
        return self._ct_float(key, self.mc.fused_mrf_ct, self.mc.mrf_ct_plain)

    def fused_mrf_phase_noups(self, key):
        return self._ct_float(key, self.mc.fused_mrf_phase_noups,
                              self.mc.mrf_phase_noups_plain)

    def _ct_int8(self, key, mode):
        """(x, weights) of a V2 int8 level, per-tap ct-packed weights: q8f
        or q8s (act scales calibrated on a slice of x) or dynamic."""
        mi = self.mi
        Bx, Tx, C = key[:3]
        p = self.params(2 * C, C)
        x = self.randn(Bx, Tx, C)
        w = mi.pack_mrf_weights(self.bf16(p), 0, self.ks, self.dils)
        if mode == 'dynamic':
            return x, mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(w),
                                           self.ks, self.dils)
        scales = level_scales(self.torch, self.F, p, x[:1, :8192].float()
                              .transpose(1, 2), self.ks, self.dils)
        scales = [s for s1, s2 in scales for s in (s1, s2)]
        if mode == 'q8s':
            return x, mi.prepare_mrf_ct_q8s(mi.quantize_mrf_ct_q8s_weights(
                w, scales), self.ks, self.dils)
        return x, mi.prepare_mrf_ct_q8f(mi.quantize_mrf_ct_q8f_weights(
            w, scales), self.ks, self.dils)

    def _int8_work(self, key, mrf):
        Bx, Tx, C = key[:3]
        return dict(flops=0, int8_ops=self.n_ops * Bx * Tx * C * C,
                    nbytes=2 * Bx * Tx * C * 2 + self.q8_wbytes(mrf, C))

    def fused_mrf_ct_q8f(self, key):
        mi = self.mi
        x, mrf = self._ct_int8(key, 'q8f')
        return dict(desc='x ({},{},{}) bf16'.format(*key), band=2e-3,
                    fn=lambda: mi.fused_mrf_ct_q8f(x, mrf),
                    plain=lambda: mi.mrf_ct_q8f_plain(x, mrf),
                    **self._int8_work(key, mrf))

    def fused_mrf_ct_q8s(self, key):
        mi = self.mi
        x, mrf = self._ct_int8(key, 'q8s')
        return dict(desc='q8s x ({},{},{}) bf16'.format(*key), band=2e-3,
                    fn=lambda: mi.fused_mrf_ct_q8s(x, mrf),
                    plain=lambda: mi.mrf_ct_q8s_plain(x, mrf),
                    **self._int8_work(key, mrf))

    def fused_mrf_phase_q8_noups(self, key):
        mi = self.mi
        Bx, Tx, C, mode = key
        x, mrf = self._ct_int8(key, mode)
        p = 128 // C
        tile = mi.phase_tile(Tx, p)
        return dict(desc=f'{mode} x ({Bx},{Tx},{C}) bf16 p {p} tile {tile}',
                    band=2e-3,
                    fn=lambda: mi.fused_mrf_phase_q8_noups(x, mrf, p, tile),
                    plain=lambda: mi.mrf_phase_q8_noups_plain(x, mrf, p,
                                                              tile),
                    **self._int8_work(key, mrf))

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
        """Static (q8f) or dyn mode, as the key's mode says."""
        vk, mi = self.vk, self.mi
        x, p16, p_in, post, scales = self._narrow(key)
        Bx, T_in, C_in, mode = key
        u = vk.pack_ups_ptc_weights(p16['ups_0']['w'], p16['ups_0']['b'], 2,
                                    1, p_in)
        pst = vk.pack_post_ptc_weights(
            p16['conv_post']['w'], p16['conv_post']['b'], 2 * p_in,
            self.torch.bfloat16) if post else None
        mrf = vk.prepare_mrf_ptc(vk.pack_mrf_ptc_weights(
            p16, 0, self.ks, self.dils, 2 * p_in,
            None if mode == 'dynamic' else scales), self.ks,
            self.dils, 2 * p_in, tuple(u) + (4, 2, 1, p_in), pst)
        tile = vk.ptc_tile(x.shape[1] // p_in)
        out = f'({Bx},1,{2 * T_in})' if post else \
            f'({Bx},{2 * T_in},{C_in // 2})'
        return dict(desc=f'{mode} x ({Bx},{T_in},{C_in}) -> {out} bf16 '
                    f'tile {tile}', band=2e-3,
                    fn=lambda: mi.fused_mrf_ptc(x, mrf, tile),
                    plain=lambda: mi.mrf_ptc_plain(x, mrf, tile),
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
                    exact=0.0 if (C, C) in mi.DYN_BLK_CFG else None,
                    fn=lambda: mi.fused_mrf_ct_q8(x, mrf, tile),
                    plain=lambda: mi.mrf_ct_q8_plain(x, mrf, tile), flops=0,
                    args=(x, mrf, tile),
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
            self.dils, p, ph, fused=mode != 'q8s')
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
        blk = mode != 'q8s' and (C_in, C_in // 2) in mi.DYN_BLK_CFG
        return dict(desc=f'{mode} x ({Bx},{T_in},{C_in}) -> {out} bf16 '
                    f'tile {tile}', band=2e-3,
                    exact=(2.0 ** -8 if post else 0.0) if blk else None,
                    fn=lambda: mi.fused_mrf_phase_q8(x, mrf, tile),
                    plain=lambda: mi.mrf_phase_q8_plain(x, mrf, tile),
                    args=(x, mrf, tile),
                    **self._narrow_work(key, mrf, post))


def _range(torch, name, on):
    """A named profiler range when ``on``."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def profile_path(torch, synthesize, tier, ranges=('acoustic', 'vocoder')):
    """Device time by kernel over one call of ``synthesize`` (a synthesis
    call or a train step), the device spans of its named ``ranges``, and
    the busy share of the device over the call's wall time."""
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
        g = next((p for p in ('mrf::blk::tc_chain_q8_kernel',
                              'mrf::blk::ptc_fused_q8_kernel',
                              'mrf::blk::dyn_blk_kernel',
                              'mrf::step_kernel', 'mrf::ups_kernel',
                              'mrf::step_q8_kernel', 'mrf::conv_dyn_kernel',
                              'mrf::ups_q8_kernel', 'mrf::amax_kernel',
                              'mrf::post_kernel', 'attn::bwd',
                              'attn::', 'Memcpy')
                  if p in e.key), 'other')
        groups[g] = groups.get(g, 0.0) + dev_us(e)
    log(f'profile {tier} groups: ' + ', '.join(
        f'{g} {us / 1e3:.3f} ms' for g, us in sorted(
            groups.items(), key=lambda kv: -kv[1])))
    attn = sum(us for g, us in groups.items() if g.startswith('attn::'))
    log(f'profile {tier}: attention kernels {attn / 1e3:.3f} ms of '
        f'{busy / 1e3:.3f} ms busy ({100 * attn / max(busy, 1e-9):.1f}%); '
        f'device idle {100 - 100 * busy / wall_us:.1f}% of the wall time')
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
        init_generator_params, pack_levels,
    )
    from daft_exprt_torch.ops import _build
    from daft_exprt_torch.ops import mrf_ct as mc
    from daft_exprt_torch.ops import mrf_int8 as mi
    from daft_exprt_torch.ops import vocoder_kernels as vk
    from daft_exprt_torch.ops.attention_kernels import (
        attention_bwd_plain, attention_plain, fused_attention,
        fused_attention_bwd,
    )
    from daft_exprt_torch import checkpoint as ckpt
    from daft_exprt_torch.loss import loss_cfg_from_hparams
    from daft_exprt_torch.models.modules import MultiHeadSelfAttention
    from daft_exprt_torch.models.pitch_predictor import PitchPredictor
    from daft_exprt_torch.parallel.train_step import (
        make_optimizer, make_train_step, to_device,
    )
    from daft_exprt_torch.train import train
    import shutil
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

    # the float32 route of the ct kernel at V2's L0 and L3 shapes
    for C, n in ((64, 8192), (8, 262144)):
        w32 = vk.pack_mrf_tc_weights(level_params(torch, gen, 2 * C, C, ks,
                                                  dils, dev), 0, ks, dils)
        x32 = torch.randn((B, n, C), generator=gen).to(dev)
        out32 = mc.fused_mrf_ct(x32, vk.prepare_mrf(w32, ks, dils))
        ref32 = mc.mrf_ct_plain(x32, vk.prepare_mrf(w32, ks, dils))
        torch.cuda.synchronize()
        r32 = rel_l2(out32.float(), ref32.float())
        log(f'check fused_mrf_ct ({B},{n},{C}) float32: max_abs='
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
               vk.fused_mrf_tc_q8, mi.fused_mrf_ptc, mi.fused_mrf_ct_q8,
               mi.fused_mrf_phase_q8, fused_attention_bwd, mc.fused_mrf_ct,
               mc.fused_mrf_phase_noups, mi.fused_mrf_ct_q8f,
               mi.fused_mrf_phase_q8_noups, vk.fused_mrf_ptc_f,
               mi.fused_mrf_ct_q8s, vk.fused_resblock1)
    cases = KernelCases(torch, F, vk, mi, mc, (
        fused_attention, attention_plain, fused_attention_bwd,
        attention_bwd_plain), dev, ks, dils)
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
            w = generator_forward(voc.params, m.to(dev, bf16), voc.config,
                                  use_fast=True, packed=voc.packed,
                                  int8=voc.int8,
                                  int8_act_scales=voc.act_scales, plain=True,
                                  **voc.switches)
        return np.clip(w.float().cpu().numpy()[:, 0, :T0 * 256], -1.0, 1.0)

    synthesize = synthesizer(vocoder)
    mel, wav = run_path('bf16', synthesize, kernels[:3])
    check_b8('bf16', mel, wav)
    exact = HiFiGanVocoder(voc_params, fast=False).infer(mel)
    r = rel(wav, exact)
    log(f'path bf16: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), |wav| max {np.abs(exact).max():.3e}')
    assert r <= 5e-2, r
    mel_v1 = mel

    # the bf16 tier's phase-tc form (the JAX package's DAFT_MRF_PTC_BF16=1)
    vocoder_ptc = HiFiGanVocoder(voc_params, fast='bf16', ptc_bf16=True)
    synthesize_ptc = synthesizer(vocoder_ptc)
    mel_f, wav_f = run_path('bf16-ptc', synthesize_ptc, (
        fused_attention, vk.fused_mrf_tc, vk.fused_mrf_ptc_f))
    check_b8('bf16-ptc', mel_f, wav_f)
    r, r_banded = rel(wav_f, exact), rel(wav_f, wav)
    log(f'path bf16-ptc: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), vs the banded bf16 tier rel_l2={r_banded:.3e} (band '
        '3e-2)')
    assert r <= 5e-2 and r_banded <= 3e-2, (r, r_banded)

    def int8_path(tier, voc, path_kernels, bf16_voc=vocoder):
        fn = synthesizer(voc)
        mel_q, wav_q = run_path(tier, fn, path_kernels)
        check_b8(tier, mel_q, wav_q)
        r_plain = rel(wav_q, plain_int8(voc, mel_q))
        r_bf16 = rel(wav_q, bf16_voc.infer(mel_q))
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
        fused_attention, vk.fused_mrf_tc_q8, mi.fused_mrf_ptc))
    t0 = time.perf_counter()
    vocoder_dyn = HiFiGanVocoder(voc_params, fast='int8')
    log(f'path int8-dynamic: int8 packing {time.perf_counter() - t0:.2f} s')
    synthesize_dyn = int8_path('int8-dynamic', vocoder_dyn, (
        fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8))
    # the static tier's round-3 boundary (DAFT_INT8_FUSED_EPI=0), for the
    # batch-1 entry point below
    vocoder_q8_uf = HiFiGanVocoder(voc_params, fast='int8',
                                   int8_calibration_mels=mel_v1[:4],
                                   int8_fused=False)

    # calibration entries for L0 and L1 only: L2 and L3 take fused_mrf_ptc's
    # dyn mode (the JAX generator's route for a partial act-scale dict)
    partial = {i: vocoder_q8.act_scales[i] for i in (0, 1)}
    packed_partial = pack_levels(vocoder_q8.params, DEFAULT_CONFIG, partial,
                                 int8=True)
    mel_dev = torch.as_tensor(mel_v1).to(dev, bf16)

    def partial_forward(plain=False):
        with torch.no_grad():
            return generator_forward(vocoder_q8.params, mel_dev,
                                     DEFAULT_CONFIG, use_fast=True,
                                     packed=packed_partial,
                                     int8_act_scales=partial, plain=plain)

    wav_p = run_path('int8-partial', partial_forward,
                     (vk.fused_mrf_tc_q8, mi.fused_mrf_ptc))
    assert wav_p.shape == (B, 1, T * 256) and torch.isfinite(
        wav_p.float()).all()
    r_plain = rel_l2(wav_p.float(), partial_forward(plain=True).float())
    r_bf16 = rel(np.clip(wav_p.float().cpu().numpy()[:, 0], -1.0, 1.0), wav)
    log(f'path int8-partial: waveform vs the plain int8 route rel_l2='
        f'{r_plain:.3e} (band 1e-2), vs the bf16 tier rel_l2={r_bf16:.3e} '
        '(band 0.25)')
    assert r_plain <= 1e-2 and r_bf16 <= 0.25, (r_plain, r_bf16)
    del wav_p, packed_partial

    # HiFi-GAN V2 behind the same acoustic model, each tier
    v2 = dict(DEFAULT_CONFIG, upsample_initial_channel=V2_CHANNELS)
    v2_params = init_generator_params(SEED + 3, v2)        # device: cuda
    vocoder_v2 = HiFiGanVocoder(v2_params, v2, fast='bf16')
    synthesize_v2 = synthesizer(vocoder_v2)
    mel, wav = run_path('v2-bf16', synthesize_v2, (
        fused_attention, mc.fused_mrf_ct, mc.fused_mrf_phase_noups))
    check_b8('v2-bf16', mel, wav)
    exact = HiFiGanVocoder(v2_params, v2, fast=False).infer(mel)
    r = rel(wav, exact)
    log(f'path v2-bf16: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), |wav| max {np.abs(exact).max():.3e}')
    assert r <= 5e-2, r
    t0 = time.perf_counter()
    vocoder_v2_q8 = HiFiGanVocoder(v2_params, v2, fast='int8',
                                   int8_calibration_mels=mel[:4])
    log(f'path v2-int8: calibration and int8 packing '
        f'{time.perf_counter() - t0:.2f} s')
    synthesize_v2_q8 = int8_path('v2-int8', vocoder_v2_q8, (
        fused_attention, mi.fused_mrf_ct_q8f, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)
    vocoder_v2_dyn = HiFiGanVocoder(v2_params, v2, fast='int8')
    synthesize_v2_dyn = int8_path('v2-int8-dynamic', vocoder_v2_dyn, (
        fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)
    vocoder_v2_uf = HiFiGanVocoder(v2_params, v2, fast='int8',
                                   int8_calibration_mels=mel[:4],
                                   int8_fused=False)
    synthesize_v2_uf = int8_path('v2-int8-unfused', vocoder_v2_uf, (
        fused_attention, mi.fused_mrf_ct_q8s, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)

    def v2_fallback():
        """generator_forward at 12 frames in each V2 tier, and its plain
        route on the card."""
        m = torch.as_tensor(mel[:, :, :V2_FALLBACK_FRAMES]).to(dev, bf16)
        out = []
        with torch.no_grad():
            for voc in (vocoder_v2, vocoder_v2_q8, vocoder_v2_dyn):
                kw = dict(use_fast=True, packed=voc.packed, int8=voc.int8,
                          int8_act_scales=voc.act_scales)
                out.append((generator_forward(voc.params, m, v2, **kw),
                            voc))
        return out

    for w, voc in run_path('v2-ct-fallback', v2_fallback, (
            mc.fused_mrf_ct, mc.fused_mrf_phase_noups, mi.fused_mrf_ct_q8f,
            mi.fused_mrf_ct_q8)):
        m = torch.as_tensor(mel[:, :, :V2_FALLBACK_FRAMES]).to(dev, bf16)
        with torch.no_grad():
            ref = generator_forward(voc.params, m, v2, use_fast=True,
                                    packed=voc.packed, int8=voc.int8,
                                    int8_act_scales=voc.act_scales,
                                    plain=True)
        assert w.shape == (B, 1, V2_FALLBACK_FRAMES * 256)
        assert torch.isfinite(w.float()).all()
        r = rel_l2(w.float(), ref.float())
        tier = 'bf16' if not voc.int8 else (
            'int8' if voc.act_scales is not None else 'int8-dynamic')
        log(f'path v2-ct-fallback {tier}: waveform vs the plain route '
            f'rel_l2={r:.3e} (band 1e-2)')
        assert r <= 1e-2, r

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
                fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8)),
            ('entry-int8-unfused', vocoder_q8_uf, (
                fused_attention, vk.fused_mrf_tc_q8, mi.fused_mrf_phase_q8))):
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

    # fused_resblock1, through its wrapper (no JAX path calls it)
    def resblock1_checks():
        for key in ((B, n, C, k, (1, 3, 5), dn) for n, C in ((8192, 256),
                                                          (65536, 128))
                    for k in ks for dn in ('bfloat16', 'float32')):
            y = cases.case('fused_resblock1', key)['fn']()
            assert y.shape == key[:3] and torch.isfinite(y.float()).all()

    run_path('resblock1', resblock1_checks, (vk.fused_resblock1,))
    # one launch of the chain kernel per call, six calls in each dtype
    assert paths[-1][1]['fused_resblock1'] == 12, paths[-1][1]
    assert sorted(sum(n for key, n in paths[-1][2]['fused_resblock1'].items()
                      if key[-1] == dn) for dn in ('bfloat16', 'float32')
                  ) == [6, 6], paths[-1][2]

    # fused_mrf_tc in float32 (no serving path; V1's L0 shape), one launch
    # of the float32 chain kernel per chain
    def tc_f32_check():
        w32 = vk.pack_mrf_tc_weights(level_params(
            torch, gen, 512, 256, ks, dils, dev), 0, ks, dils)
        x32 = torch.randn((B, T * 8, 256), generator=gen).to(dev)
        out32 = vk.fused_mrf_tc(x32, vk.prepare_mrf(w32, ks, dils))
        ref32 = vk.mrf_tc_plain(x32, w32, ks, dils)
        torch.cuda.synchronize()
        r32 = rel_l2(out32.float(), ref32.float())
        log(f'check fused_mrf_tc L0 float32: max_abs='
            f'{max_abs(out32.float(), ref32.float()):.3e} rel_l2={r32:.3e} '
            '(band 1e-05)')
        assert r32 <= 1e-5, r32

    run_path('tc-f32', tc_f32_check, (vk.fused_mrf_tc,))
    assert paths[-1][1]['fused_mrf_tc'] == 3, paths[-1][1]

    # ---- 3b. training ------------------------------------------------------
    attn_kernels = (fused_attention, fused_attention_bwd)
    hp_t = HyperParams(verbose=False, training_files='unused',
                       validation_files='unused',
                       output_directory=os.path.join(ROOT, 'build', 'smoke'),
                       language='english', speakers=['lj'])

    def random_pitch_predictor(seed):
        """Seeded random weights: convs with std 1/sqrt(fan-in), BatchNorm
        scales 1 + N(0, 0.1), biases N(0, 0.02), statistics (0, 1)."""
        pp = PitchPredictor(hp_t.n_mel_channels)
        gen_pp = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, prm in pp.named_parameters():
                z = torch.randn(prm.shape, generator=gen_pp)
                if prm.dim() > 1:
                    prm.copy_(z / prm[0].numel() ** 0.5)
                elif name.startswith('bn') and name.endswith('weight'):
                    prm.copy_(1.0 + 0.1 * z)
                else:
                    prm.copy_(0.02 * z)
        return pp

    pitch_pp = random_pitch_predictor(SEED + 1).to(dev).frozen()
    loss_cfg = loss_cfg_from_hparams(hp_t)
    tbatch = make_train_batch(hp_t, TB, TL, TT, seed=SEED)
    dev_batch = to_device(tbatch, dev)
    dev_raw = to_device({'frames_energy': tbatch['frames_energy'],
                         'frames_pitch': tbatch['frames_pitch']}, dev)
    log(f'train-step: loss terms {sorted(loss_cfg)}; pitch predictor '
        f'random, weight {loss_cfg["pitch_consistency_weight"]}; energy '
        f'{loss_cfg["energy_consistency_weight"]}; dropout '
        f'{hp_t.phoneme_encoder["attn_dropout"]}; {hp_t.compute_dtype}')

    def train_step_path(tier, hp_x, n_steps, bands):
        """``n_steps`` steps of make_train_step on a seeded model of
        ``hp_x`` as a path (12 attention forward launches and 12 backward
        calls a step), then its first step again from the same parameters
        and seed with the plain attention on the card (the masks are the
        same by construction): loss and grad norm within ``bands``.
        Returns the steps' metrics and host seconds."""
        xmodel = DaftExprt.from_hparams(hp_x, seed=SEED).train()   # cuda
        x_init = {k: v.clone() for k, v in xmodel.state_dict().items()}

        def new_step():
            return make_train_step(xmodel, make_optimizer(xmodel, hp_x),
                                   loss_cfg, pitch_pp)

        step, step_s = new_step(), []

        def steps():
            out = []
            for i in range(n_steps):
                t0 = time.perf_counter()
                m = step(dev_batch, dev_raw, float(i), SEED)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                out.append({k: float(v) for k, v in m.items()})
            return out

        metrics = run_path(tier, steps, attn_kernels)
        for i, m in enumerate(metrics):
            log(f'path {tier}: step {i}: ' + ' '.join(
                f'{k}={v:.6g}' for k, v in m.items()))
            assert all(math.isfinite(v) for v in m.values()), m
        n_fwd = paths[-1][1]['fused_attention']
        n_bwd = paths[-1][1]['fused_attention_bwd']
        assert n_fwd == 12 * n_steps, n_fwd
        assert n_bwd == 2 * 12 * n_steps, n_bwd
        log(f'path {tier}: host s/step {[round(x, 4) for x in step_s]}')
        xmodel.load_state_dict(x_init)
        for m in xmodel.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.fused = False
        plain = {k: float(v) for k, v in new_step()(
            dev_batch, dev_raw, 0.0, SEED).items()}
        torch.cuda.synchronize()
        r_loss = abs(plain['loss'] - metrics[0]['loss']) / abs(plain['loss'])
        r_norm = abs(plain['grad_norm'] - metrics[0]['grad_norm']) / abs(
            plain['grad_norm'])
        log(f'path {tier}: first step with the plain attention: loss '
            f'{plain["loss"]:.8g} (rel {r_loss:.3e}, band {bands[0]:g}), '
            f'grad norm {plain["grad_norm"]:.8g} (rel {r_norm:.3e}, band '
            f'{bands[1]:g})')
        assert r_loss <= bands[0] and r_norm <= bands[1], (r_loss, r_norm)
        del xmodel, x_init, step
        torch.cuda.empty_cache()
        return metrics, step_s

    # bf16 rounds at other points in the two routes
    _, step_s = train_step_path('train-step', hp_t, TRAIN_STEPS, (1e-2, 5e-2))
    per_step = float(np.median(step_s[1:]))
    # float32: every FFT block's attention on the float32 kernels. Bands 10x
    # tighter than bf16's: the kernels agree with the plain attention to
    # about 1e-6 (band 1e-5) and the rest of the step is the same float32
    # code on both sides (cuDNN TF32 in the convs on both sides, where the
    # attention's differences can flip a TF32 rounding, 2^-11 of a value)
    hp_f = HyperParams(verbose=False, training_files='unused',
                       validation_files='unused',
                       output_directory=os.path.join(ROOT, 'build', 'smoke'),
                       language='english', speakers=['lj'],
                       compute_dtype='float32')
    train_step_path('train-step-f32', hp_f, TRAIN_STEPS_F32, (1e-3, 5e-3))
    assert all(k[-1] == 'float32' for calls in paths[-1][2].values()
               for k in calls), paths[-1][2]
    del dev_batch, dev_raw

    # the train() entry point, then a resume from its checkpoint
    root = os.path.join(ROOT, 'build', 'smoke', 'train')
    shutil.rmtree(root, ignore_errors=True)
    train_list, val_list = write_train_dataset(root, hp_t.symbols)
    pp_path = os.path.join(root, 'pitch_predictor.pt')
    torch.save(random_pitch_predictor(SEED + 2).state_dict(), pp_path)
    train_kw = dict(verbose=False, training_files=train_list,
                    validation_files=val_list,
                    output_directory=os.path.join(root, 'out'),
                    language='english', speakers=['speaker_0', 'speaker_1'],
                    batch_size=TB, iters_check_for_model_improvement=4,
                    pitch_predictor_path=pp_path)
    ck_dir = os.path.join(root, 'out', 'checkpoints')

    def train_and_resume():
        _, m4 = train(HyperParams(**train_kw), num_iterations=4)
        ck4 = os.path.join(ck_dir, 'DaftExprt_4')
        payload4, meta4 = ckpt.load_checkpoint(ck4)
        _, m6 = train(HyperParams(**train_kw, checkpoint=ck4),
                      num_iterations=6)
        return m4, payload4, meta4, m6

    m4, payload4, meta4, m6 = run_path('train', train_and_resume,
                                       attn_kernels)
    payload6, meta6 = ckpt.load_checkpoint(os.path.join(ck_dir,
                                                        'DaftExprt_6'))
    log(f'path train: iteration 4 loss {m4["loss"]:.6g}, best validation '
        f'loss {meta4["best_val_loss"]:.6g}; resumed to iteration '
        f'{meta6["iteration"]}, loss {m6["loss"]:.6g}; checkpoints '
        f'{sorted(os.listdir(ck_dir))}')
    assert math.isfinite(m4['loss']) and math.isfinite(m6['loss'])
    assert meta4['iteration'] == 4 and math.isfinite(meta4['best_val_loss'])
    assert os.path.isfile(os.path.join(ck_dir, 'best_model'))
    assert payload4['optimizer']['updates'] == 4
    assert meta6['iteration'] == 6 and payload6['optimizer']['updates'] == 6
    for i, st in payload4['optimizer']['state'].items():
        assert int(payload6['optimizer']['state'][i]['step']) == \
            int(st['step']) + 2

    # ---- 4. each kernel at each shape a path called it with ----------------
    by_name = {kern.__name__: kern for kern in kernels}
    measured = {}

    def measure(name, key):
        c = cases.case(name, key)
        n0 = by_name[name].launches
        out = c['fn']()
        per_launch = by_name[name].launches - n0     # launches per call
        ref = c['plain']()
        if isinstance(out, tuple):                   # (dq, dk, dv)
            if c.get('repeat_equal'):
                again = c['fn']()
                assert all(torch.equal(a, b) for a, b in zip(out, again)), \
                    f'{name} {key}: two calls differ'
                del again
            out, ref = torch.stack(out), torch.stack(ref)
        torch.cuda.synchronize()
        assert out.shape == ref.shape, (name, key, out.shape, ref.shape)
        assert torch.isfinite(out.float()).all(), (name, key)
        r, m = rel_l2(out.float(), ref.float()), max_abs(out.float(),
                                                          ref.float())
        del out, ref
        log(f'check {name} {c["desc"]}: max_abs={m:.3e} rel_l2={r:.3e} '
            f'(band {c["band"]:g})')
        assert r <= c['band'], f'{name} {key}: rel-L2 {r} above {c["band"]}'
        # the block-resident int8 kernels: every sample bit-identical, a
        # conv_post waveform within one bf16 ulp (its sum order)
        assert c.get('exact') is None or m <= c['exact'], \
            f'{name} {key}: max-abs {m} above {c["exact"]}'
        ms = time_ms(torch, c['fn'])
        plain_ms = time_ms(torch, c['plain'], warmup=1, iters=3)
        lib_ms = time_ms(torch, c['lib']) if 'lib' in c else None
        lib_kernels = library_kernels(torch, c['lib']) if 'lib' in c else None
        b_ms, b_by = bound(c['flops'], c['nbytes'], c.get('int8_ops', 0),
                           c.get('f32_flops', 0), c.get('tf32x3_flops', 0))
        # float32 on the tensor cores: the bound at the FMA rate beside it
        fma = bound(0, c['nbytes'], f32_flops=c['tf32x3_flops'])[0] \
            if c.get('tf32x3_flops') else None
        log(f'time {name} {c["desc"]}: ms={ms:.4f} plain_ms={plain_ms:.4f} '
            f'library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} '
            f'bound_ms={b_ms:.4f} ({b_by})'
            + (f' fma_bound_ms={fma:.4f}' if fma is not None else '')
            + f', {per_launch} launches per call'
            + (f'; library kernels {lib_kernels}' if lib_kernels else ''))
        return dict(shape=c['desc'], launches_per_call=per_launch, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs=m, rel_l2=r,
                    library_kernels=lib_kernels,
                    **({'fma_bound_ms': fma} if fma is not None else {}))

    def mode_of(key):
        """The mode a multi-mode wrapper keys its calls by ('' if none)."""
        return key[-1] if isinstance(key[-1], str) else ''

    def total(rows):
        """A path's numbers over its calls (``rows``: one per shape)."""
        def tot(k):
            return sum(r[k] * r['per_call'] for r in rows)
        return dict(
            launches=tot('launches_per_call'), ms=tot('ms'),
            plain_ms=tot('plain_ms'), bound_ms=tot('bound_ms'),
            library_ms=None if any(r['library_ms'] is None for r in rows)
            else tot('library_ms'),
            bound_by=max(rows, key=lambda r: r['bound_ms'] * r['per_call']
                         )['bound_by'],
            **({'fma_bound_ms': tot('fma_bound_ms')}
               if all('fma_bound_ms' in r for r in rows) else {}))

    per_path = {}         # (name, mode) -> {tier: rows}
    for tier, launches, calls in paths:
        for name, by_key in calls.items():
            rows = []
            for key, n in sorted(by_key.items(), key=str):
                if (name, key) not in measured:
                    measured[name, key] = measure(name, key)
                rows.append(dict(measured[name, key], path=tier,
                                 per_call=n, mode=mode_of(key)))
                per_path.setdefault((name, mode_of(key)), {}).setdefault(
                    tier, []).append(rows[-1])
            counted = total(rows)['launches']
            assert counted == launches[name], (
                f'{tier} {name}: {launches[name]} launches on the path, '
                f'{counted} from its calls by shape times launches per call')

    # the forward and the backward at p = 0 too, at each training shape, in
    # bf16 and in float32, and a float32 call past the old T <= 2048 limit
    off_path = {'fused_attention': [], 'fused_attention_bwd': []}
    train_keys = sorted({k[:4] for _, _, calls in paths
                         for k in calls.get('fused_attention_bwd', {})})
    for key in [k + (0.0,) for k in train_keys] + [
            k + (0.0, 'float32') for k in train_keys] + [ATTN_LONG_F32]:
        for name, rows in off_path.items():
            if (name, key) not in measured:
                measured[name, key] = measure(name, key)
                rows.append((mode_of(key), measured[name, key]))

    sources = {'fused_attention': 'daft_exprt_torch/ops/csrc/attention_fwd.cu',
               'fused_attention_bwd':
               'daft_exprt_torch/ops/csrc/attention_bwd.cu',
               'fused_mrf_tc': 'daft_exprt_torch/ops/csrc/mrf_tc.cu',
               'fused_mrf_phase': 'daft_exprt_torch/ops/csrc/mrf_phase.cu',
               'fused_mrf_tc_q8': 'daft_exprt_torch/ops/csrc/mrf_tc_q8.cu',
               'fused_mrf_ptc': 'daft_exprt_torch/ops/csrc/mrf_ptc.cu',
               'fused_mrf_ct_q8': 'daft_exprt_torch/ops/csrc/mrf_ct_q8.cu',
               'fused_mrf_phase_q8':
               'daft_exprt_torch/ops/csrc/mrf_phase_q8.cu',
               'fused_mrf_ct': 'daft_exprt_torch/ops/csrc/mrf_ct.cu',
               'fused_mrf_phase_noups': 'daft_exprt_torch/ops/csrc/mrf_ct.cu',
               'fused_mrf_ct_q8f': 'daft_exprt_torch/ops/csrc/mrf_ct_q8.cu',
               'fused_mrf_phase_q8_noups':
               'daft_exprt_torch/ops/csrc/mrf_phase_q8.cu',
               'fused_mrf_ptc_f': 'daft_exprt_torch/ops/csrc/mrf_phase.cu',
               'fused_mrf_ct_q8s': 'daft_exprt_torch/ops/csrc/mrf_ct_q8.cu',
               'fused_resblock1': 'daft_exprt_torch/ops/csrc/mrf_tc.cu'}
    replaces = {
        'fused_attention': 'daft_exprt_tpu/ops/attention_kernels.py:170',
        'fused_attention_bwd': 'daft_exprt_tpu/ops/attention_kernels.py:195',
        'fused_mrf_tc': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_phase': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_tc_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:657',
        'fused_mrf_ptc': 'daft_exprt_tpu/ops/vocoder_kernels.py:1999',
        'fused_mrf_ct_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:450',
        'fused_mrf_phase_q8': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_ct': 'daft_exprt_tpu/ops/vocoder_kernels.py:450',
        'fused_mrf_phase_noups': 'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_ct_q8f': 'daft_exprt_tpu/ops/vocoder_kernels.py:450',
        'fused_mrf_phase_q8_noups':
        'daft_exprt_tpu/ops/vocoder_kernels.py:1431',
        'fused_mrf_ptc_f': 'daft_exprt_tpu/ops/vocoder_kernels.py:1999',
        'fused_mrf_ct_q8s': 'daft_exprt_tpu/ops/vocoder_kernels.py:450',
        'fused_resblock1': 'daft_exprt_tpu/ops/vocoder_kernels.py:209'}
    # one entry per kernel and mode; its main path: the first path that
    # runs it in that mode
    table = []
    for (name, mode), by_tier in sorted(per_path.items(), key=lambda kv: (
            [k.__name__ for k in kernels].index(kv[0][0]), kv[0][1])):
        main_tier = next(t for t, _, _ in paths if t in by_tier)
        m = total(by_tier[main_tier])
        table.append(dict(
            name=f'{name}[{mode}]' if mode else name, route='cuda',
            source=sources[name], replaces=replaces[name],
            launches=m['launches'],
            max_abs_err=max(r['max_abs'] for rows in by_tier.values()
                            for r in rows),
            ms=m['ms'], plain_ms=m['plain_ms'], bound_ms=m['bound_ms'],
            bound_by=m['bound_by'], library_ms=m['library_ms'],
            **({'fma_bound_ms': m['fma_bound_ms']} if 'fma_bound_ms' in m
               else {}),
            main_path=main_tier,
            paths={t: total(rows) for t, rows in by_tier.items()},
            per_shape=[r for rows in by_tier.values() for r in rows]))
        if name in off_path:
            table[-1]['off_path'] = [r for m, r in off_path[name] if m == mode]
    assert {e['name'].split('[')[0] for e in table} == set(by_name)

    # ---- 5. end to end ----------------------------------------------------
    audio_s = B * T * 256 / DEFAULT_CONFIG['sampling_rate']
    for tier, synth_fn in (('bf16', synthesize), ('int8', synthesize_q8),
                           ('int8-dynamic', synthesize_dyn),
                           ('bf16-ptc', synthesize_ptc),
                           ('v2-bf16', synthesize_v2),
                           ('v2-int8', synthesize_v2_q8),
                           ('v2-int8-dynamic', synthesize_v2_dyn),
                           ('v2-int8-unfused', synthesize_v2_uf)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth_fn()
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        log(f'end to end {tier}: {e2e:.3f} s for {audio_s:.2f} audio-s at '
            f'B={B}: {audio_s / e2e:.1f} audio-s/s (host clock, '
            'synchronized)')
    log(f'end to end train-step: {per_step:.4f} s/step (median of steps '
        f'2-{TRAIN_STEPS}) at B={TB}, L={TL}, T={TT}: {1 / per_step:.3f} '
        f'steps/s, {TB / per_step:.2f} utterances/s (host clock, '
        'synchronized)')

    if '--profile' in sys.argv:
        profile_path(torch, synthesize, 'bf16')
        profile_path(torch, synthesize_q8, 'int8')
        profile_path(torch, synthesize_dyn, 'int8-dynamic')
        profile_path(torch, synthesize_ptc, 'bf16-ptc')
        profile_path(torch, synthesize_v2, 'v2-bf16')
        profile_path(torch, synthesize_v2_q8, 'v2-int8')
        profile_path(torch, synthesize_v2_dyn, 'v2-int8-dynamic')
        profile_path(torch, synthesize_v2_uf, 'v2-int8-unfused')
        for tier, fn in entry_fns.items():
            profile_path(torch, fn, tier)
        tmodel = DaftExprt.from_hparams(hp_t, seed=SEED).train()
        step = make_train_step(tmodel, make_optimizer(tmodel, hp_t), loss_cfg,
                               pitch_pp)
        b_dev = to_device(tbatch, dev)
        r_dev = to_device({'frames_energy': tbatch['frames_energy'],
                           'frames_pitch': tbatch['frames_pitch']}, dev)
        profile_path(torch, lambda ranges=False: step(b_dev, r_dev, 0.0,
                                                      SEED),
                     'train-step', ranges=('forward', 'backward',
                                           'optimizer'))
        fmodel = DaftExprt.from_hparams(hp_f, seed=SEED).train()
        fstep = make_train_step(fmodel, make_optimizer(fmodel, hp_f),
                                loss_cfg, pitch_pp)
        profile_path(torch, lambda ranges=False: fstep(b_dev, r_dev, 0.0,
                                                       SEED),
                     'train-step-f32', ranges=('forward', 'backward',
                                               'optimizer'))

    log(json.dumps({'kernels': table}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

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
     dyn mode at L2/L3 (amax + one launch of the segment-synchronised
     engine a level: 4 launches, checked); the same two bands;
   - bf16-ptc, B=8: HiFiGanVocoder(fast='bf16', ptc_bf16=True) (the JAX
     package's DAFT_MRF_PTC_BF16=1) behind the Synthesizer: fused_mrf_tc
     at L0/L1, fused_mrf_ptc's fdot mode at L2/L3 (the bf16 engine's
     phase_bf_kernel with its upsample output in float32, one launch a
     level: 2, checked; it prints the block_m of each level); the waveform
     against the float32 plain route (rel-L2 <= 5e-2) and the banded bf16
     tier (<= 3e-2, NUMERICS_r05.json ptc_bf16_vs_banded_bf16);
   - HiFi-GAN V2 (jik876/hifi-gan config_v2.json: V1 at 128 initial
     channels, levels of C = 64/32/16/8) behind the same Synthesizer at
     B=8 x 1024 frames, each tier: bf16 (fused_mrf_ct at L0,
     fused_mrf_phase without prologue at L1-L3, one launch a level of
     ops/csrc/mrf_ct.cu's ct_kernel over CtBf: 1 + 3, checked; it prints each
     level's block_m), int8-static (mel[:4] calibration: fused_mrf_ct q8f
     at L0, the int8 fused_mrf_phase q8f without prologue at L1, one
     launch a level of ptc_fused_q8_kernel without prologue: 1 + 1,
     checked; bf16 at L2/L3: 2 launches, checked) and int8-dynamic (the
     same in q8, each int8 level the window amax and one launch of the
     segment-synchronised engine: 2 + 2, checked); each
     waveform against the float32 plain route (bf16, 5e-2) or the plain
     int8 route and the V2 bf16 tier (1e-2, 0.25); then v2-int8-unfused,
     the int8-static tier with int8_fused=False (the JAX package's
     DAFT_INT8_FUSED_EPI=0): fused_mrf_ct q8s at L0, the int8
     fused_mrf_phase q8s without prologue at L1 (1 + 1, checked), the
     same bands;
   - v2-ct-fallback: generator_forward at 12 frames (no phase tile divides
     L1 and L2, which take fused_mrf_ct) in each V2 tier, against the
     kernels' plain versions (rel-L2 <= 1e-2), one launch a float call and
     a q8f call, two a q8 call (checked);
   - v2-fast-f32: generator_forward(use_fast=True) on the float32 V2 params
     over the v2-bf16 path's mel (pack_levels of the same params):
     fused_mrf_ct at L0 and fused_mrf_phase without prologue at L1-L3 on
     ct_kernel over CtF32 (3xTF32 on the tensor cores), 1 + 3 launches,
     checked; the waveform against the float32 plain route of the same
     function, rel-L2 <= 1e-4, and against the per-conv float32 route
     (HiFiGanVocoder(fast=False)), rel-L2 <= 5e-2, as fast-f32; it prints
     each level's block_m;
   - the serving entry point at batch 1: generate_mel_specs(batch_size=1)
     over three utterances of about 200, 640 and 1024 frames (so the ct
     tile changes) with the int8-static vocoder (its narrow levels below
     the phase-tc batch: the q8f int8 fused_mrf_phase), then with the
     int8-dynamic one; each utterance's waveform against the plain int8
     route, rel-L2 <= 1e-2; prints the RTF; then entry-int8-unfused, the
     same with the int8-static vocoder at int8_fused=False (the q8s int8
     fused_mrf_phase with its prologue at L2/L3: the amax and the q8s form
     of fused_mrf_ptc's ptc_fused_q8_kernel, 2 launches a level, 12 for
     the three utterances, checked). With matplotlib the entry
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
     version (TF32 off), rel-L2 <= 1e-5;
   - fast-f32: generator_forward(use_fast=True) on the float32 V1 params
     over the bf16 path's mel (B=8 x 1024 frames; pack_levels of the same
     params): fused_mrf_tc at L0/L1 (tc_f32_kernel, 6 launches) and
     fused_mrf_phase at L2/L3 (phase_f32_kernel, one launch a level: 2),
     both 3xTF32 on the tensor cores, checked; the waveform against the
     float32 plain route of the same function (generator_forward(...,
     plain=True): the kernels' plain versions, TF32 off), rel-L2 <= 1e-4,
     and against the per-conv float32 route (HiFiGanVocoder(fast=False),
     which pads each conv at the utterance edges), rel-L2 <= 5e-2 as the
     bf16 path.
   Each path checks its outputs' shape and finiteness and that every kernel
   of its path, and no other, was launched.
   Then the audio front end (no kernel of its own: plain PyTorch on the
   card, float32 matmuls without TF32, the pitch scores in float64):
   - preprocess: a corpus under build/smoke/preprocess, 2 speakers x 4
     utterances of 1.8-3 s (a pulse train at a seeded F0 through a
     resonator, markers, .lab files, metadata.csv) through
     extract_features(pitch_method='device') on the card, create_sets and
     extract_features_stats; no kernel launched. Checks: every utterance
     extracted (the count, so no silent skips), each file's durations sum
     to its mel frames, the median voiced F0 within 8% of the known F0,
     each .npy within max-abs 1e-3 of the port's CPU run of the same
     corpus and .frames_f0 equal to it on >= 99% of lines; the corpus's
     markers written as Montreal Forced Aligner TextGrids and read back
     through frontend/mfa.extract_markers(n_jobs=2) must give the same
     .markers;
   - preprocess-batch: scripts/bench_preprocess.py's shape, B=32 x 11.9 s,
     through MelExtractor.batched + frame_energy +
     PitchTracker.batched_frame_f0; batched_frame_f0 must equal frame_f0
     on every row. Prints each stage's host seconds (synchronised), the
     Viterbi's share, the NCCF's time and its depthwise correlation's
     (CUDA events) and the audio-seconds per second, each beside the
     card's name and power limit;
   - reference (accent conversion from audio): a seeded 3 s recording
     through extract_reference_parameters(device='cuda') (the card's
     pitch tracker), padded to a frame bucket as scripts/synthesize.py
     does, model.encode_accent, the embedding tiled to B=8 as accent_emb,
     then Synthesizer.infer and HiFiGanVocoder(fast='bf16').infer:
     fused_attention (every FFT block: accent encoder, phoneme encoder,
     frame decoder; counted), fused_mrf_tc and fused_mrf_phase. Checks:
     the npz's lengths agree, the accent embedding within rel-L2 1e-2 of
     the same call with the plain attention, the waveform finite and of
     its shape.
   Then vocoder GAN fine-tuning and the text front end (no kernel of their
   own: the GAN steps run the plain generator and cuDNN's convs):
   - finetune-dataset: fine_tuning(params=a seeded random acoustic state,
     device='cuda') over preprocess's features (all 8 utterances in one
     list, batch 4; seeded stand-ins for the external ECAPA embeddings):
     8/8 pairs and no skip counted, each .wav the marker crop of its
     corpus wav, fused_attention 12 launches a batch and no vocoder
     kernel; then the same call with the plain attention (its .npy rel-L2
     printed: in bf16, one ulp of an attention output moves a random
     model's mel as much as bf16 rounding does) and both again in float32
     (the float32 kernels): each .npy within rel-L2 1e-2;
   - gan-step (scripts/bench_gan_step.py's shape): make_gan_steps on the
     V1 generator at full width (DEFAULT_CONFIG), MPD + MSD, B=16 x 8192
     samples, seeded random weights, five iterations (d_step + g_step) in
     float32, then five in bf16, TF32 as train.py (cuDNN's default for
     float32 convs; the matmuls and the loss mel without); prints the
     median s/iteration of iterations 2-5 and the segments/s. Checks:
     every loss finite, parameters and optimizer states float32, scale_0's
     power-iteration state moved, no hand-written kernel launched, the
     first bf16 iteration's losses within |a - b| < 0.1 max(|a|, 1) of the
     float32 ones, and the first float32 iteration on the card (TF32 off)
     against the port's CPU run of it at B=2 x 8192: d_loss rel <= 1e-4,
     g_loss and mel_l1 rel <= 1e-3;
   - finetune: the finetune() entry point on finetune-dataset's speaker_0
     pairs at full V1 width, batch 2, 'utt_0' held out, 4 steps,
     checkpoints at 2 and 4 (each reloaded), a finite validation mel L1;
     then the generator of g_00000004 through HiFiGanVocoder(fast='bf16')
     on one mel: fused_mrf_tc 6 and fused_mrf_phase 2 launches, the
     waveform within rel-L2 5e-2 of the float32 plain route;
   - text: a sentences file (numbers, a year, dollar amounts, ordinals,
     'Dr.', mixed punctuation) through prepare_sentences_for_inference
     with an MFA-style dictionary of every word under a home of the smoke's
     own, at n_jobs 2 and 1 (equal files, no <unk>, an 'mfa' on PATH never
     called), then generate_mel_specs(batch_size=1) with the int8-static
     vocoder on seeded prosody per symbol: fused_attention 8 a sentence,
     the narrow levels' fused_mrf_phase_q8 4 a sentence, each waveform
     within rel-L2 1e-2 of the plain int8 route.
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
   Then scale-out (parallel/{mesh,train_step,vocoder_sharding}.py,
   vocoder_finetune's mesh; no kernel of their own):
   - ddp-train-step: make_train_step(mesh=...) over a mesh of one rank
     (NCCL, world 1, in this process) on train-step's model, batch and
     seed, five steps: 12 attention forward launches and 24 backward a
     step (60 / 120), every metric of every step equal bit for bit to a
     single-process run of the same steps (both with cuDNN's deterministic
     algorithms); prints s/step beside train-step's;
   - ddp-2rank: two spawned ranks sharing the card over gloo, default
     HyperParams in float32, TF32 off, dropout 0, the B=16 x L=128 x
     T=1024 batch split 8 + 8 (the second half's rows 48-384 frames
     shorter and voiced on ~30% of frames against ~90%: the global
     denominators matter), two steps: both ranks' metrics identical, loss
     within rel 1e-5 and grad norm within 1e-4 of the single-process step
     on the whole batch; each rank's float32 attention launches (24 / 48)
     checked in the rank; prints each rank's s/step and the gloo
     all-reduce time of the gradient's size;
   - gan-dp: make_gan_steps(mesh=...) over the world-1 mesh at gan-step's
     shape in float32: the first iteration's losses equal bit for bit to
     a single-process iteration (both with cuDNN deterministic), then four
     more; prints s/iteration beside gan-step's;
   - voc-tp: make_sharded_vocoder on a 1 x 2 mesh (two ranks over gloo),
     V1 at full width, B=2 x 256 frames, float32 with TF32 off: both ranks'
     waveforms identical and within rel-L2 1e-5 of the plain float32
     generator_forward;
   - profile-trace: utils/profiling.profiler_trace around one bf16
     synthesis call (the bf16 path's kernels, counted) writes
     build/smoke/trace/trace.json; prints its events, its device kernels
     and ThroughputCounter's rate.
   Every spawned rank is joined under a deadline (launch.run_ranks): a
   rank that fails or hangs fails the phase.
4. At every input shape a path called a kernel with: the kernel against
   its plain PyTorch version on the same inputs (unit-gain random weights):
   rel-L2 <= 1e-2 in bf16 (summation order only), <= 1e-5 in float32,
   <= 2e-3 for the int8 kernels (NUMERICS_r05.json ptc_vs_banded_int8),
   and max-abs 0 for the dynamic engine (fused_mrf_ct q8, fused_mrf_phase
   q8 with and without prologue, fused_mrf_ptc dyn) and the calls on
   ptc_fused_q8_kernel (fused_mrf_phase's q8f and q8s with and without
   prologue, fused_mrf_ct q8f and q8s, fused_mrf_ptc static; a conv_post
   waveform: within one bf16 ulp);
   its launches per call; its time (median of 10 calls), its plain
   version's (median of 3) and (attention) the library call's, with CUDA
   events, beside the least time the card could take (H100 SXM: 989
   TFLOP/s bf16, 494.7/3 TFLOP/s for float32 on the tensor cores in
   3xTF32 (the float32 attention, fused_mrf_tc, fused_mrf_phase and
   fused_resblock1; their
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
   float32 calls of the attention, fused_mrf_tc, fused_mrf_phase,
   fused_mrf_ct and fused_mrf_phase_noups are their "float32" mode, main
   paths train-step-f32, tc-f32, fast-f32 and v2-fast-f32).
5. Prints the end-to-end audio-seconds per second of the B=8 synthesis
   paths and of preprocess-batch, the train-step path's steps/s and
   utterances/s and the gan-step path's s/iteration and segments/s (host
   clock, synchronised after each step).

``--profile`` adds a torch.profiler pass over one synthesis call of each
B=8 tier, one generate_mel_specs call of each batch-1 path, one
preprocess-batch call, one train step in bf16 and one in float32, and one
GAN iteration in each: device time by kernel and kernel family, the
acoustic/vocoder (forward/backward/optimizer, d_step/g_step) split, the
device's busy share and the attention kernels' share of the busy time.

The float32 calls of fused_mrf_ct at V2's L0 and L3 shapes are held to
their plain version at rel-L2 <= 1e-5 before the paths run, one launch a
call (checked), and timed there (the "off_path" rows of the
fused_mrf_ct[float32] JSON entry, with their bound in 3xTF32 and at the
FMA rate).

Any failure raises (exit code != 0). Without a CUDA device it exits 2 and
prints no result. The line before the last is the kernels' JSON; the last
is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import logging
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
PRE_SPEAKERS, PRE_UTTERANCES = 2, 4   # the preprocess path's corpus
PRE_B, PRE_SECONDS = 32, 11.9         # scripts/bench_preprocess.py's shape
REF_SECONDS = 3.0                     # the reference path's recording
FT_B = 4                              # finetune-dataset's batch
GAN_B, GAN_SEG = 16, 8192             # bench_gan_step.py's batch, samples
GAN_ITERS = 5                         # gan-step: iterations a dtype
GAN_CPU_B = 2                         # gan-step's card-vs-CPU check
FT_STEPS = 4                          # the finetune path's steps
DDP_STEPS = 2                         # ddp-2rank: steps of the float32 step
TP_B, TP_FRAMES = 2, 256              # voc-tp: utterances, frames
TEXT_SENTENCES = (
    'Dr. Smith paid $5.50 for 3 books in 1984!',
    'On the 2nd of May, it rained -- a lot; really?',
    'Wait... what?! The 21st "test" costs $1,250.',
)


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


def voice_like(rng, f0, n, begin, end, sr=22050):
    """A pulse train at ``f0`` Hz over samples [begin, end) through a 500
    Hz resonator (tests/test_frontend.py's voice-like audio), silence
    around it, a little seeded noise on top; peak 1/1.3."""
    from scipy.signal import lfilter
    sig = np.zeros(n)
    idx = np.arange(begin, end, sr / f0).astype(int)
    sig[idx[idx < n]] = 1.0
    y = lfilter([1.0], [1, -1.8 * np.cos(2 * np.pi * 500 / sr), 0.81], sig)
    y = y / (np.abs(y).max() * 1.3) + 1e-4 * rng.randn(n)
    return y.astype(np.float32)


def write_preprocess_corpus(root, save_wav, seed=SEED, sr=22050):
    """PRE_SPEAKERS x PRE_UTTERANCES utterances of 1.8-3 s under
    ``root``/dataset, in the layout extract_features reads: wavs/*.wav,
    align/*.markers ('hello world': HH OW1, a silence, W D, spread over
    the voiced span) and *.lab, metadata.csv. Returns [(speaker, name,
    F0 in Hz)]."""
    rng = np.random.RandomState(seed)
    frac = (0.0, 1 / 6, 1 / 3, 7 / 15, 11 / 15, 1.0)
    phones = (('HH', 'hello', 0), ('OW1', 'hello', 0), ('SIL', '<sil>', 1),
              ('W', 'world', 2), ('D', 'world', 2))
    corpus = []
    for s in range(PRE_SPEAKERS):
        spk = f'speaker_{s}'
        for sub in ('wavs', 'align'):
            os.makedirs(os.path.join(root, 'dataset', spk, sub))
        meta = []
        for u in range(PRE_UTTERANCES):
            name, f0 = f'utt_{u}', float(rng.uniform(100.0, 250.0))
            dur = rng.uniform(1.8, 3.0)
            begin, end = 0.2, dur - 0.1
            n = int(dur * sr)
            save_wav(os.path.join(root, 'dataset', spk, 'wavs',
                                  f'{name}.wav'),
                     voice_like(rng, f0, n, int(begin * sr), int(end * sr)),
                     sr)
            t = [begin + f * (end - begin) for f in frac]
            with open(os.path.join(root, 'dataset', spk, 'align',
                                   f'{name}.markers'), 'w') as f:
                f.writelines(f'{t[i]:.3f}\t{t[i + 1]:.3f}\t{p}\t{w}\t{wi}\n'
                             for i, (p, w, wi) in enumerate(phones))
            with open(os.path.join(root, 'dataset', spk, 'align',
                                   f'{name}.lab'), 'w') as f:
                f.write('hello world')
            meta.append(f'{name}|hello world\n')
            corpus.append((spk, name, f0))
        with open(os.path.join(root, 'dataset', spk, 'metadata.csv'),
                  'w') as f:
            f.writelines(meta)
    return corpus


def markers_to_textgrid(rows, xmax):
    """A Montreal Forced Aligner TextGrid (long text format) of ``.markers``
    rows [begin, end, phone, word, word index]: a words tier (the silent
    word '<sil>' as MFA's '') and a phones tier ('SIL' as MFA's 'sil')."""
    words = []
    for b, e, phone, word, idx in rows:
        if words and words[-1][3] == idx:
            words[-1][1] = e
        else:
            words.append([b, e, '' if word == '<sil>' else word, idx])
    phones = [(b, e, 'sil' if p == 'SIL' else p) for b, e, p, _, _ in rows]
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', '',
           'xmin = 0', f'xmax = {xmax}', 'tiers? <exists>', 'size = 2',
           'item []:']
    for i, (name, tier) in enumerate((('words', [w[:3] for w in words]),
                                      ('phones', phones)), 1):
        out += [f'    item [{i}]:', '        class = "IntervalTier"',
                f'        name = "{name}"', '        xmin = 0',
                f'        xmax = {xmax}',
                f'        intervals: size = {len(tier)}']
        for j, (b, e, text) in enumerate(tier, 1):
            out += [f'        intervals [{j}]:', f'            xmin = {b}',
                    f'            xmax = {e}', f'            text = "{text}"']
    return '\n'.join(out) + '\n'


def write_mfa_dictionary(path, sentences, cleaner, phones, seed=SEED):
    """An MFA-style dictionary: one pronunciation (1-5 phones) for every
    word of ``sentences`` after ``cleaner``. Returns the words."""
    import re
    rng = np.random.RandomState(seed)
    words = sorted({w for s in sentences for w in re.findall(
        r"[\w']+", cleaner(s)) if re.search('[a-z]', w)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        for w in words:
            f.write(f'{w}\t{" ".join(rng.choice(phones, rng.randint(1, 6)))}'
                    '\n')
    return words


def random_pitch_predictor(n_mel, seed):
    """A PitchPredictor with seeded random weights: convs with std
    1/sqrt(fan-in), BatchNorm scales 1 + N(0, 0.1), biases N(0, 0.02),
    statistics (0, 1); on the CPU."""
    import torch
    from daft_exprt_torch.models.pitch_predictor import PitchPredictor
    pp = PitchPredictor(n_mel)
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


def ddp_hparams(**kw):
    """Default HyperParams in float32 with every dropout at 0 (the
    data-parallel checks: a rank's masks cannot be the single process's)."""
    from daft_exprt_torch.hparams import HyperParams
    hp = HyperParams(verbose=False, training_files='unused',
                     validation_files='unused',
                     output_directory=os.path.join(ROOT, 'build', 'smoke'),
                     language='english', speakers=['lj'],
                     compute_dtype='float32', **kw)
    for name in ('phoneme_encoder', 'accent_encoder', 'frame_decoder'):
        setattr(hp, name, dict(getattr(hp, name), attn_dropout=0.0,
                               conv_dropout=0.0))
    return hp


def ddp_batch(hp, B, L, T, seed=SEED):
    """The training batch of ``dryrun.make_batch`` with halves that differ:
    rows of the second half 48 frames shorter each (durations spread over
    the symbols, summing to each row's frames) and voiced on ~30% of their
    frames against ~90% in the first half. Returns (batch, raw frames)."""
    from daft_exprt_torch.parallel.dryrun import make_batch as train_batch
    b = train_batch(hp, B, L, T, seed)
    half = B // 2
    lens = np.array([T] * half + [T - 48 * (i + 1) for i in range(B - half)])
    dur = np.zeros((B, L), np.int64)
    dur[:] = (lens // L)[:, None]
    dur[:, -1] += lens - (lens // L) * L
    b.update(output_lengths=lens, durations_int=dur, durations_float=(
        dur * hp.hop_length / hp.sampling_rate).astype(np.float32))
    rng = np.random.RandomState(seed + 7)
    dens = np.array([0.9] * half + [0.3] * (B - half))[:, None]
    raw = {'frames_energy': (np.abs(b['frames_energy']) * 3).astype(
        np.float32),
           'frames_pitch': np.where(rng.rand(B, T) < dens,
                                    np.abs(b['frames_pitch']) + 5,
                                    0).astype(np.float32)}
    return b, raw


def ddp_rank(rank, batch, raw, n_steps, device='cuda'):
    """One rank of ddp-2rank: ``n_steps`` of the data-parallel float32 step
    (TF32 off, dropout 0, cuDNN's deterministic algorithms, as the
    single-process reference) on this rank's rows of the global batch,
    with the attention counters zeroed before; then three all-reduces of
    a buffer the size of the gradient. Returns metrics, host seconds a
    step, the attention launches and calls, and the all-reduce seconds."""
    import torch
    import torch.distributed as dist
    from daft_exprt_torch.loss import loss_cfg_from_hparams
    from daft_exprt_torch.models.daft_exprt import DaftExprt
    from daft_exprt_torch.ops.attention_kernels import (
        fused_attention, fused_attention_bwd,
    )
    from daft_exprt_torch.ops.vocoder_kernels import full_f32
    from daft_exprt_torch.parallel.mesh import (
        data_rows, make_mesh, shard_batch,
    )
    from daft_exprt_torch.parallel.train_step import (
        make_optimizer, make_train_step,
    )
    hp = ddp_hparams()
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    torch.backends.cudnn.deterministic = True
    with full_f32():
        model = DaftExprt.from_hparams(hp, device=device, seed=SEED).train()
        pp = random_pitch_predictor(hp.n_mel_channels,
                                    SEED + 1).to(device).frozen()
        mesh = make_mesh(device=device)
        step = make_train_step(model, make_optimizer(model, hp),
                               loss_cfg_from_hparams(hp), pp, mesh=mesh)
        lo, hi = data_rows(len(batch['mel_specs']), mesh)
        b = shard_batch({k: v[lo:hi] for k, v in batch.items()}, mesh)
        r = shard_batch({k: v[lo:hi] for k, v in raw.items()}, mesh)
        attn = (fused_attention, fused_attention_bwd)
        for kern in attn:
            kern.launches = 0
            kern.calls.clear()
        metrics, secs = [], []
        for i in range(n_steps):
            sync()
            t0 = time.perf_counter()
            m = step(b, r, float(i), SEED)
            sync()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = {k.__name__: (k.launches, dict(k.calls)) for k in attn}
        n_grad = sum(p.numel() for p in model.parameters()
                     if p.requires_grad)
        flat = torch.zeros(n_grad, device=mesh.device)
        ar_s = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=mesh.data_group)
            sync()
            ar_s.append(time.perf_counter() - t0)
    return dict(metrics=metrics, secs=secs, counts=counts, n_grad=n_grad,
                allreduce_s=ar_s, rows=int(b['mel_specs'].shape[0]))


def tp_rank(rank, mel, device='cuda'):
    """One rank of voc-tp: V1 at full width, seeded weights, channels over
    a 1 x 2 mesh, float32 with TF32 off; returns the waveform and its host
    seconds."""
    import torch
    from daft_exprt_torch.models.hifigan import init_generator_params
    from daft_exprt_torch.ops.vocoder_kernels import full_f32
    from daft_exprt_torch.parallel.mesh import make_mesh
    from daft_exprt_torch.parallel.vocoder_sharding import (
        make_sharded_vocoder, shard_generator_params,
    )
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    mesh = make_mesh(n_data=1, n_model=2, device=device)
    params = shard_generator_params(init_generator_params(SEED,
                                                          device=device),
                                    mesh)
    voc = make_sharded_vocoder(mesh)
    secs = []
    with full_f32(), torch.no_grad():
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            wav = voc(params, torch.from_numpy(mel))
            sync()
            secs.append(time.perf_counter() - t0)
    return dict(wav=wav.cpu().numpy(), secs=secs,
                shapes={k: tuple(v['w'].shape) for k, v in params.items()
                        if 'w' in v})


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
        the path hands it over. A float32 call (key 'float32') runs on the
        tensor cores in 3xTF32: its flops at a third of the TF32 rate."""
        torch = self.torch
        Bx, C_in, T_in = key[:3]
        f32 = key[3:] == ('float32',)
        C, post = C_in // 2, mrf.post is not None
        x = (torch.randn((Bx, T_in, C_in), generator=self.gen).to(self.dev)
             if f32 else self.randn(Bx, T_in, C_in)).transpose(1, 2)
        N = 2 * T_in
        c_out = 1 if post else C
        esz = x.element_size()
        wbytes = sum(t.numel() * t.element_size() for t in mrf.packed) + \
            mrf.ups[0].numel() * esz
        flops = (252 * Bx * N * C * C + 2 * Bx * N * C_in * C * 2
                 + (2 * Bx * N * C * 7 if post else 0))
        return dict(desc=f'x ({Bx},{C_in},{T_in}) -> ({Bx},{c_out},{N}) '
                    f'{"float32" if f32 else "bf16"}',
                    band=1e-5 if f32 else 1e-2, fn=lambda: fn(x, mrf),
                    plain=lambda: plain(x, mrf),
                    **(dict(flops=0, tf32x3_flops=flops) if f32
                       else dict(flops=flops)),
                    nbytes=Bx * C_in * T_in * esz + Bx * c_out * N * esz
                    + wbytes)

    def fused_mrf_phase(self, key):
        """key: x's shape, and 'float32' for a float32 call."""
        vk = self.vk
        C_in = key[1]
        C, post = C_in // 2, C_in == 64
        p = self.params(C_in, C, post=post)
        if key[3:] != ('float32',):
            p = self.bf16(p)
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
                    fn=lambda: fn(x, mrf), plain=lambda: plain(x, mrf),
                    **(dict(flops=0, tf32x3_flops=flops) if f32
                       else dict(flops=flops)),
                    nbytes=2 * Bx * Tx * C * x.element_size() + wbytes)

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
                    exact=0.0, fn=lambda: mi.fused_mrf_ct_q8f(x, mrf),
                    plain=lambda: mi.mrf_ct_q8f_plain(x, mrf),
                    **self._int8_work(key, mrf))

    def fused_mrf_ct_q8s(self, key):
        mi = self.mi
        x, mrf = self._ct_int8(key, 'q8s')
        return dict(desc='q8s x ({},{},{}) bf16'.format(*key), band=2e-3,
                    exact=0.0, fn=lambda: mi.fused_mrf_ct_q8s(x, mrf),
                    plain=lambda: mi.mrf_ct_q8s_plain(x, mrf),
                    **self._int8_work(key, mrf))

    def fused_mrf_phase_q8_noups(self, key):
        mi = self.mi
        Bx, Tx, C, mode = key
        x, mrf = self._ct_int8(key, mode)
        p = 128 // C
        tile = mi.phase_tile(Tx, p)
        return dict(desc=f'{mode} x ({Bx},{Tx},{C}) bf16 p {p} tile {tile}',
                    band=2e-3, exact=0.0,
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
        # dyn: the segment-synchronised engine, bit-exact (a conv_post
        # waveform within one bf16 ulp)
        return dict(desc=f'{mode} x ({Bx},{T_in},{C_in}) -> {out} bf16 '
                    f'tile {tile}', band=2e-3,
                    exact=(2.0 ** -8 if post else 0.0)
                    if mode == 'dynamic' else None,
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
                    exact=0.0, fn=lambda: mi.fused_mrf_ct_q8(x, mrf, tile),
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
        blk = (C_in, C_in // 2) in mi.PTC_Q8_BM
        return dict(desc=f'{mode} x ({Bx},{T_in},{C_in}) -> {out} bf16 '
                    f'tile {tile}', band=2e-3,
                    exact=(2.0 ** -8 if post else 0.0) if blk else None,
                    fn=lambda: mi.fused_mrf_phase_q8(x, mrf, tile),
                    plain=lambda: mi.mrf_phase_q8_plain(x, mrf, tile),
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
                              'mrf::bfe::phase_bf_kernel',
                              'mrf::bfe::tc_bf_kernel',
                              'mrf::ct::ct_kernel', 'mrf::amax_kernel',
                              'attn::bwd',
                              'attn::', 'fprop', 'dgrad', 'wgrad', 'gemm',
                              'elementwise', 'reduce', 'Memcpy')
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
    from daft_exprt_torch.parallel.dryrun import (
        make_batch as make_train_batch,
    )
    from daft_exprt_torch.parallel.train_step import (
        make_optimizer, make_train_step, to_device,
    )
    from daft_exprt_torch.train import train
    from daft_exprt_torch.parallel.launch import run_ranks
    from daft_exprt_torch.parallel.mesh import init_distributed, make_mesh
    from daft_exprt_torch.utils.profiling import (
        ThroughputCounter, profiler_trace,
    )
    import shutil
    import torch.distributed as dist
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

    # the float32 route of the ct kernel at V2's L0 and L3 shapes, checked
    # and timed (its JSON entry's off_path rows)
    ct_f32 = []
    for C, n in ((64, 8192), (8, 262144)):
        w32 = vk.pack_mrf_tc_weights(level_params(torch, gen, 2 * C, C, ks,
                                                  dils, dev), 0, ks, dils)
        x32 = torch.randn((B, n, C), generator=gen).to(dev)
        mrf32 = vk.prepare_mrf(w32, ks, dils)
        n0 = mc.fused_mrf_ct.launches
        out32 = mc.fused_mrf_ct(x32, mrf32)
        per_call = mc.fused_mrf_ct.launches - n0
        ref32 = mc.mrf_ct_plain(x32, mrf32)
        torch.cuda.synchronize()
        r32 = rel_l2(out32.float(), ref32.float())
        m32 = max_abs(out32.float(), ref32.float())
        log(f'check fused_mrf_ct ({B},{n},{C}) float32: max_abs='
            f'{m32:.3e} rel_l2={r32:.3e} (band 1e-05), block_m='
            f'{vk.ct_block(C, True, ks, dils, B, n, vk.sm_count(dev))}')
        assert r32 <= 1e-5, r32
        assert per_call == 1, per_call
        ms = time_ms(torch, lambda: mc.fused_mrf_ct(x32, mrf32))
        plain_ms = time_ms(torch, lambda: mc.mrf_ct_plain(x32, mrf32),
                           warmup=1, iters=3)
        flops = 252 * B * n * C * C
        nbytes = 2 * B * n * C * 4 + sum(t.numel() * 4 for t in w32)
        b_ms, b_by = bound(0, nbytes, tf32x3_flops=flops)
        fma = bound(0, nbytes, f32_flops=flops)[0]
        log(f'time fused_mrf_ct x ({B},{n},{C}) float32: ms={ms:.4f} '
            f'plain_ms={plain_ms:.4f} library_ms=None bound_ms={b_ms:.4f} '
            f'({b_by}) fma_bound_ms={fma:.4f}, {per_call} launches per call')
        ct_f32.append(dict(shape=f'x ({B},{n},{C}) float32',
                           launches_per_call=per_call, ms=ms,
                           plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                           bound_by=b_by, fma_bound_ms=fma, max_abs=m32,
                           rel_l2=r32))
        del w32, x32, out32, ref32, mrf32

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
    mel_v1, exact_v1 = mel, exact

    # the bf16 tier's phase-tc form (the JAX package's DAFT_MRF_PTC_BF16=1)
    vocoder_ptc = HiFiGanVocoder(voc_params, fast='bf16', ptc_bf16=True)
    synthesize_ptc = synthesizer(vocoder_ptc)
    mel_f, wav_f = run_path('bf16-ptc', synthesize_ptc, (
        fused_attention, vk.fused_mrf_tc, vk.fused_mrf_ptc_f))
    # fdot: one phase_bf_kernel launch a level, float32 X0
    assert paths[-1][1]['fused_mrf_ptc_f'] == 2, paths[-1][1]
    for lvl, (C_in, T_in) in ((2, (128, T * 64)), (3, (64, T * 128))):
        pl = vk._phase_bf_plan(
            torch.empty((B, C_in, T_in), dtype=bf16, device='meta'),
            vocoder_ptc.packed[lvl].ptc,
            lambda shape, dt: torch.empty(shape, dtype=dt, device='meta'),
            vk.sm_count(dev), fdot=True)
        log(f'path bf16-ptc: L{lvl} fdot phase_bf_kernel block_m='
            f'{pl.block_m} hx={pl.hx} ({pl.n_blocks} blocks an utterance)')
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
    # fused_mrf_ptc dyn: amax + one engine launch a level
    assert paths[-1][1]['fused_mrf_ptc'] == 4, paths[-1][1]
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
    # one level kernel launch a level: L0, then L1-L3
    assert (paths[-1][1]['fused_mrf_ct'], paths[-1][1]['fused_mrf_phase_noups']
            ) == (1, 3), paths[-1][1]
    v2_levels = ((64, T * 8), (32, T * 64), (16, T * 128), (8, T * 256))

    def v2_blocks(tier, f32):
        for lvl, (C, n) in enumerate(v2_levels):
            bm = vk.ct_block(C, f32, ks, dils, B, n, vk.sm_count(dev))
            log(f'path {tier}: L{lvl} ct_kernel<{"CtF32" if f32 else "CtBf"}> '
                f'block_m={bm} ({-(-n // bm)} blocks an utterance, '
                f'{B * -(-n // bm)} items)')

    v2_blocks('v2-bf16', False)
    check_b8('v2-bf16', mel, wav)
    exact = HiFiGanVocoder(v2_params, v2, fast=False).infer(mel)
    r = rel(wav, exact)
    log(f'path v2-bf16: waveform vs float32 plain route rel_l2={r:.3e} '
        f'(band 5e-2), |wav| max {np.abs(exact).max():.3e}')
    assert r <= 5e-2, r
    mel_v2, exact_v2 = mel, exact
    t0 = time.perf_counter()
    vocoder_v2_q8 = HiFiGanVocoder(v2_params, v2, fast='int8',
                                   int8_calibration_mels=mel[:4])
    log(f'path v2-int8: calibration and int8 packing '
        f'{time.perf_counter() - t0:.2f} s')

    def v2_int8_launches(ct_name, per_level):
        """L0 and L1 in int8, ``per_level`` launches each (the static
        levels one launch of ptc_fused_q8_kernel without prologue, the
        dynamic ones the window amax and one engine launch); L2 and L3 (C %
        32 != 0) in bf16, one launch a level."""
        n = paths[-1][1]
        assert (n[ct_name], n['fused_mrf_phase_q8_noups'],
                n['fused_mrf_phase_noups']) == (per_level, per_level, 2), n

    synthesize_v2_q8 = int8_path('v2-int8', vocoder_v2_q8, (
        fused_attention, mi.fused_mrf_ct_q8f, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)
    v2_int8_launches('fused_mrf_ct_q8f', 1)
    vocoder_v2_dyn = HiFiGanVocoder(v2_params, v2, fast='int8')
    synthesize_v2_dyn = int8_path('v2-int8-dynamic', vocoder_v2_dyn, (
        fused_attention, mi.fused_mrf_ct_q8, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)
    v2_int8_launches('fused_mrf_ct_q8', 2)
    vocoder_v2_uf = HiFiGanVocoder(v2_params, v2, fast='int8',
                                   int8_calibration_mels=mel[:4],
                                   int8_fused=False)
    synthesize_v2_uf = int8_path('v2-int8-unfused', vocoder_v2_uf, (
        fused_attention, mi.fused_mrf_ct_q8s, mi.fused_mrf_phase_q8_noups,
        mc.fused_mrf_phase_noups), vocoder_v2)
    v2_int8_launches('fused_mrf_ct_q8s', 1)

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

    fallback_out = run_path('v2-ct-fallback', v2_fallback, (
        mc.fused_mrf_ct, mc.fused_mrf_phase_noups, mi.fused_mrf_ct_q8f,
        mi.fused_mrf_ct_q8))
    # the float and the q8f levels: one launch a call; q8: the window amax
    # and one engine launch
    for name, per_call in (('fused_mrf_ct', 1), ('fused_mrf_phase_noups', 1),
                           ('fused_mrf_ct_q8f', 1), ('fused_mrf_ct_q8', 2)):
        assert paths[-1][1][name] == per_call * sum(
            paths[-1][2][name].values()), paths[-1]
    for w, voc in fallback_out:
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
    del fallback_out

    # the float32 fast route on the float32 V2 params over the v2-bf16
    # path's mel: fused_mrf_ct at L0, fused_mrf_phase_noups at L1-L3, all on
    # the float32 level kernel
    packed_v2_f32 = pack_levels(v2_params, v2)
    mel_v2_f32 = torch.as_tensor(mel_v2).to(dev)

    def v2_fast_f32(plain=False):
        with torch.no_grad(), vk.full_f32():
            return generator_forward(v2_params, mel_v2_f32, v2, use_fast=True,
                                     packed=packed_v2_f32, plain=plain)

    wav_v2_32 = run_path('v2-fast-f32', v2_fast_f32, (
        mc.fused_mrf_ct, mc.fused_mrf_phase_noups))
    assert paths[-1][1] == {'fused_mrf_ct': 1, 'fused_mrf_phase_noups': 3}, \
        paths[-1][1]
    assert all(k[-1] == 'float32' for calls in paths[-1][2].values()
               for k in calls), paths[-1][2]
    v2_blocks('v2-fast-f32', True)
    assert wav_v2_32.shape == (B, 1, T * 256)
    assert wav_v2_32.dtype == torch.float32
    assert torch.isfinite(wav_v2_32).all()
    r_plain = rel_l2(wav_v2_32, v2_fast_f32(plain=True))
    r_exact = rel(wav_v2_32.cpu().numpy()[:, 0], exact_v2)
    log(f'path v2-fast-f32: waveform vs the float32 plain route rel_l2='
        f'{r_plain:.3e} (band 1e-4), vs the per-conv float32 route rel_l2='
        f'{r_exact:.3e} (band 5e-2)')
    assert r_plain <= 1e-4 and r_exact <= 5e-2, (r_plain, r_exact)
    del packed_v2_f32, mel_v2_f32, wav_v2_32

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
        # the narrow levels of the static tiers: the amax and
        # ptc_fused_q8_kernel (q8f, or q8s when unfused) a level
        if tier != 'entry-int8-dynamic':
            assert paths[-1][1]['fused_mrf_phase_q8'] == 4 * len(names), \
                paths[-1][1]
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

    # the float32 fast route on the float32 V1 params over the bf16 path's
    # mel: fused_mrf_tc at L0/L1, fused_mrf_phase at L2/L3, all float32
    packed_f32 = pack_levels(voc_params, DEFAULT_CONFIG)
    mel_f32 = torch.as_tensor(mel_v1).to(dev)

    def fast_f32(plain=False):
        # float32 throughout: TF32 off in the library ops around the kernels
        with torch.no_grad(), vk.full_f32():
            return generator_forward(voc_params, mel_f32, DEFAULT_CONFIG,
                                     use_fast=True, packed=packed_f32,
                                     plain=plain)

    wav_32 = run_path('fast-f32', fast_f32, (vk.fused_mrf_tc,
                                             vk.fused_mrf_phase))
    assert paths[-1][1] == {'fused_mrf_tc': 6, 'fused_mrf_phase': 2}, \
        paths[-1][1]
    assert all(k[-1] == 'float32' for calls in paths[-1][2].values()
               for k in calls), paths[-1][2]
    assert wav_32.shape == (B, 1, T * 256) and wav_32.dtype == torch.float32
    assert torch.isfinite(wav_32).all()
    r_plain = rel_l2(wav_32, fast_f32(plain=True))
    r_exact = rel(wav_32.cpu().numpy()[:, 0], exact_v1)
    log(f'path fast-f32: waveform vs the float32 plain route rel_l2='
        f'{r_plain:.3e} (band 1e-4), vs the per-conv float32 route rel_l2='
        f'{r_exact:.3e} (band 5e-2)')
    assert r_plain <= 1e-4 and r_exact <= 5e-2, (r_plain, r_exact)
    # the planned blocks of phase_f32_kernel at L2 and L3 (output samples a
    # block owns, of a window of block_m + 2*hx)
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device='meta')

    for lvl, (C_in, T_in) in ((2, (128, T * 64)), (3, (64, T * 128))):
        pl = vk._phase_f32_plan(meta((B, C_in, T_in), torch.float32),
                                packed_f32[lvl], meta, 132)
        log(f'path fast-f32: L{lvl} phase_f32_kernel block_m={pl.block_m} '
            f'hx={pl.hx} ({pl.n_blocks} blocks an utterance)')
    del packed_f32, mel_f32, wav_32

    # ---- 3a. the audio front end ------------------------------------------
    # preprocess: a corpus through extract_features on the card, then the
    # set lists and the stats; the same corpus on the port's CPU route
    from daft_exprt_torch.data.sets import (
        create_sets, extract_features_stats, save_stats,
    )
    from daft_exprt_torch.frontend.audio import save_wav
    from daft_exprt_torch.frontend.extract_features import extract_features
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.generate import (
        _round_to_bucket, extract_reference_parameters,
    )
    from daft_exprt_torch.ops.mel import MelExtractor, frame_energy
    from daft_exprt_torch.ops.pitch import PitchTracker, _nccf, _viterbi

    pre_root = os.path.join(ROOT, 'build', 'smoke', 'preprocess')
    shutil.rmtree(pre_root, ignore_errors=True)
    corpus = write_preprocess_corpus(pre_root, save_wav)
    dataset = os.path.join(pre_root, 'dataset')
    speakers = sorted({spk for spk, _, _ in corpus})

    def pre_hp(tag):
        lists = os.path.join(pre_root, tag, 'lists')
        return HyperParams(verbose=False, language='english',
                           speakers=speakers,
                           training_files=os.path.join(lists, 'train.txt'),
                           validation_files=os.path.join(lists, 'val.txt'),
                           output_directory=os.path.join(pre_root, tag))

    def preprocess(tag, device=None):
        hp_p = pre_hp(tag)
        feats = os.path.join(pre_root, tag, 'features')
        got = extract_features(dataset, feats, hp_p, pitch_method='device',
                               device=device)
        create_sets(feats, hp_p)
        return got, save_stats(extract_features_stats(hp_p),
                               hp_p.output_directory)

    got, stats_path = run_path('preprocess', lambda: preprocess('card'), ())
    got_cpu, _ = preprocess('cpu', device='cpu')
    n_done = sum(len(v) for v in got.values())
    assert n_done == len(corpus) == sum(len(v) for v in got_cpu.values()), \
        (got, got_cpu)
    with open(stats_path) as f:
        pre_stats = json.load(f)
    assert all(math.isfinite(v[k]['mean']) and v[k]['std'] > 0
               for spk, v in pre_stats.items() if spk != 'symbols'
               for k in ('energy', 'pitch')), pre_stats
    with open(pre_hp('card').training_files) as f_t, \
            open(pre_hp('card').validation_files) as f_v:
        n_lists = (len(f_t.readlines()), len(f_v.readlines()))
    assert sum(n_lists) == len(corpus) and n_lists[1] == len(speakers)
    worst_mel, f0_agree, f0_dev = 0.0, [], []
    for spk, name, f0 in corpus:
        card = os.path.join(pre_root, 'card', 'features', spk, name)
        cpu = os.path.join(pre_root, 'cpu', 'features', spk, name)
        mel_c, mel_h = np.load(f'{card}.npy'), np.load(f'{cpu}.npy')
        assert mel_c.shape == mel_h.shape and np.isfinite(mel_c).all()
        worst_mel = max(worst_mel, float(np.abs(mel_c - mel_h).max()))
        with open(f'{card}.markers') as f:
            durs = [int(line.split('\t')[2]) for line in f]
        assert sum(durs) == mel_c.shape[1], (name, sum(durs), mel_c.shape)
        with open(f'{card}.frames_f0') as f_c, open(f'{cpu}.frames_f0') as f_h:
            lc, lh = f_c.read().split(), f_h.read().split()
        assert len(lc) == len(lh) == mel_c.shape[1]
        f0_agree.append(np.mean([a == b for a, b in zip(lc, lh)]))
        track = np.array([float(v) for v in lc])
        f0_dev.append(abs(np.exp(np.median(track[track > 0])) - f0) / f0)
    log(f'path preprocess: {n_done}/{len(corpus)} utterances extracted on '
        f'the card, sets {n_lists[0]} train / {n_lists[1]} validation; card '
        f'vs CPU: log-mel max-abs {worst_mel:.3e} (band 1e-3), frames_f0 '
        f'lines equal {min(f0_agree):.4f} at worst (band 0.99); median '
        f'voiced F0 vs the known F0 {max(f0_dev):.4f} at worst (band 0.08)')
    assert worst_mel <= 1e-3 and min(f0_agree) >= 0.99 and \
        max(f0_dev) <= 0.08, (worst_mel, f0_agree, f0_dev)
    # the corpus's alignments as the aligner's TextGrids, read back through
    # frontend/mfa.extract_markers: the .markers the corpus was written with
    from daft_exprt_torch.frontend.mfa import extract_markers
    grid_root = os.path.join(pre_root, 'textgrid')
    for spk, name, _ in corpus:
        with open(os.path.join(dataset, spk, 'align',
                               f'{name}.markers')) as f:
            rows = [line.rstrip('\n').split('\t') for line in f]
        os.makedirs(os.path.join(grid_root, spk), exist_ok=True)
        with open(os.path.join(grid_root, spk, f'{name}.TextGrid'),
                  'w') as f:
            f.write(markers_to_textgrid(rows, rows[-1][1]))
    for spk in speakers:
        extract_markers(os.path.join(grid_root, spk), n_jobs=2)
    for spk, name, _ in corpus:
        with open(os.path.join(grid_root, spk, f'{name}.markers')) as f_g, \
                open(os.path.join(dataset, spk, 'align',
                                  f'{name}.markers')) as f_m:
            assert f_g.read() == f_m.read(), (spk, name)
    log(f'path preprocess: {len(corpus)} TextGrids through '
        'extract_markers(n_jobs=2) give the corpus\'s .markers')

    # scripts/bench_preprocess.py's shape: B = 32 x 11.9 s through
    # MelExtractor.batched + frame_energy + PitchTracker.batched_frame_f0
    rng_p = np.random.RandomState(SEED)
    n_pre = int(PRE_SECONDS * hp.sampling_rate)
    t_pre = np.arange(n_pre) / hp.sampling_rate
    wavs_pre = (0.3 * np.sin(2 * np.pi * rng_p.uniform(100, 300, (PRE_B, 1))
                             * t_pre[None, :])
                + 0.02 * rng_p.randn(PRE_B, n_pre)).astype(np.float32)
    mel_ex, tracker = MelExtractor(hp), PitchTracker(hp)
    w_pre = torch.from_numpy(wavs_pre).to(dev)

    def features(ranges=False):
        with _range(torch, 'mel', ranges):
            mel_b = mel_ex.batched(list(wavs_pre))
        with _range(torch, 'energy', ranges):
            nrg_b = frame_energy(mel_b)
        with _range(torch, 'pitch', ranges):
            f0_b = tracker.batched_frame_f0(w_pre)
        return mel_b, nrg_b, f0_b

    mel_b, nrg_b, f0_b = run_path('preprocess-batch', features, ())
    n_f = tracker.n_frames(n_pre)
    total = -(-(n_pre + 2 * mel_ex.pad) // mel_ex.bucket) * mel_ex.bucket
    assert mel_b.shape == (PRE_B, hp.n_mel_channels,
                           1 + (total - mel_ex.n_fft) // mel_ex.hop)
    assert nrg_b.shape == (PRE_B, mel_b.shape[-1])
    assert f0_b.shape == (PRE_B, n_f) and torch.isfinite(mel_b).all()
    for i in range(PRE_B):
        assert np.array_equal(f0_b[i].cpu().numpy(),
                              tracker.frame_f0(wavs_pre[i])), \
            f'batched_frame_f0 row {i} differs from frame_f0'
    log(f'path preprocess-batch: batched_frame_f0 equals frame_f0 on all '
        f'{PRE_B} rows ({n_f} frames each); voiced '
        f'{float((f0_b > 0).float().mean()):.4f}')

    def timed(fn):
        """``fn()`` and its host seconds, synchronised before and after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    stage_s = {}
    _, stage_s['mel'] = timed(lambda: mel_ex.batched(list(wavs_pre)))
    _, stage_s['energy'] = timed(lambda: frame_energy(mel_b))
    prep, stage_s['highpass'] = timed(lambda: tracker._prepare(w_pre))
    scores, stage_s['nccf'] = timed(lambda: tracker._scores(*prep))
    _, stage_s['viterbi'] = timed(lambda: _viterbi(
        scores[0], tracker.log_lags, tracker.uv_cost, tracker.n_lags,
        local_uv=scores[1]))
    del prep, scores
    _, pre_s = timed(features)
    # the NCCF's depthwise correlation alone (B x F groups, float64)
    x_pre = tracker._prepare(w_pre)[0]
    G = PRE_B * n_f
    idx_p = (torch.arange(n_f, device=dev)[:, None] * tracker.frame_step
             + torch.arange(tracker.win + tracker.max_lag + 1,
                            device=dev)[None, :])
    ext_p = x_pre[:, idx_p].reshape(1, G, -1)
    frames_p = ext_p[0, :, :tracker.win].reshape(G, 1, tracker.win)
    conv_ms = time_ms(torch, lambda: F.conv1d(ext_p, frames_p, groups=G),
                      warmup=1, iters=3)
    nccf_ms = time_ms(torch, lambda: _nccf(
        x_pre, tracker.frame_step, tracker.win, tracker.min_lag,
        tracker.max_lag, n_f, 0.0), warmup=1, iters=3)
    del x_pre, ext_p, frames_p
    pre_audio_s = PRE_B * n_pre / hp.sampling_rate
    total_stage = sum(stage_s.values())
    log(f'path preprocess-batch: stages (host s, synchronised) ' + ', '.join(
        f'{k} {v:.4f}' for k, v in stage_s.items()) + f'; Viterbi '
        f'{stage_s["viterbi"] / total_stage:.4f} of {total_stage:.4f} s '
        f'({n_f - 1} frames, {(n_f - 1) / stage_s["viterbi"]:.0f} '
        f'frames/s); NCCF {nccf_ms:.4f} ms (events), its depthwise '
        f'correlation alone {conv_ms:.4f} ms over {G} groups '
        f'[{smi.splitlines()[0]}]')
    log(f'path preprocess-batch: {pre_audio_s:.2f} audio-s in {pre_s:.4f} s: '
        f'{pre_audio_s / pre_s:.2f} audio-s/s (host clock, synchronised) '
        f'[{smi.splitlines()[0]}]')

    # reference: accent conversion from a recording
    ref_root = os.path.join(ROOT, 'build', 'smoke', 'reference')
    shutil.rmtree(ref_root, ignore_errors=True)
    os.makedirs(ref_root)
    rng_r = np.random.RandomState(SEED + 3)
    n_ref = int(REF_SECONDS * hp.sampling_rate)
    ref_wav = os.path.join(ref_root, 'reference.wav')
    save_wav(ref_wav, voice_like(rng_r, float(rng_r.uniform(100.0, 250.0)),
                                 n_ref, int(0.1 * hp.sampling_rate),
                                 n_ref - int(0.1 * hp.sampling_rate)),
             hp.sampling_rate)
    acc_attn = [m for m in model.accent_encoder.modules()
                if isinstance(m, MultiHeadSelfAttention)]

    def reference_inputs(npz):
        """The npz padded to a frame bucket as scripts/synthesize.py does."""
        ref = np.load(npz)
        T_r = min(ref['mel_spec'].shape[1], len(ref['energy']),
                  len(ref['pitch']))
        T_p = _round_to_bucket(T_r, hp.frame_buckets)

        def pad_t(x):
            return torch.as_tensor(np.pad(x[:T_r], (0, T_p - T_r))[None],
                                   dtype=torch.float32, device=dev)
        mel_p = np.full((1, ref['mel_spec'].shape[0], T_p), np.log(1e-5),
                        dtype=np.float32)
        mel_p[0, :, :T_r] = ref['mel_spec'][:, :T_r]
        return ref, (pad_t(ref['energy']), pad_t(ref['pitch']),
                     torch.as_tensor(mel_p, device=dev),
                     torch.tensor([T_r], device=dev))

    def encode(inputs):
        with torch.no_grad():
            return model.encode_accent(*inputs).float()

    def reference_path():
        npz = extract_reference_parameters(
            ref_wav, ref_root, hp, device='cuda',
            pitch_extractor=lambda w, sr, h: extract_pitch(
                w, sr, h, method='device', device='cuda'))
        ref, inputs = reference_inputs(npz)
        emb_r = encode(inputs)
        mel_r, _, _ = synth.infer(**dict(
            batch, accent_emb=np.tile(emb_r.cpu().numpy(), (B, 1))))
        return ref, inputs, emb_r, mel_r, vocoder.infer(mel_r)

    ref, ref_in, emb_r, mel_r, wav_r = run_path('reference', reference_path,
                                                kernels[:3])
    n_blocks = sum(getattr(hp, m)['nb_blocks'] for m in (
        'accent_encoder', 'phoneme_encoder', 'frame_decoder'))
    assert paths[-1][1]['fused_attention'] == n_blocks, paths[-1][1]
    assert len(ref['energy']) == len(ref['pitch']) == \
        ref['mel_spec'].shape[1], {k: ref[k].shape for k in ref.files}
    for m in acc_attn:
        m.fused = False
    n0 = fused_attention.launches
    emb_plain = encode(ref_in)
    assert fused_attention.launches == n0, 'the plain call used the kernel'
    for m in acc_attn:
        m.fused = True
    r_emb = rel_l2(emb_r, emb_plain)
    check_b8('reference', mel_r, wav_r)
    log(f'path reference: {ref["mel_spec"].shape[1]} frames of '
        f'{REF_SECONDS} s (voiced {float(np.mean(ref["pitch"] > 0)):.3f}), '
        f'padded to {ref_in[2].shape[-1]}; accent embedding vs the plain '
        f'attention rel_l2={r_emb:.3e} (band 1e-2); waveform {wav_r.shape}')
    assert r_emb <= 1e-2, r_emb
    del mel_b, nrg_b, f0_b, mel_r, wav_r

    # ---- 3c. vocoder fine-tuning and the text front end -------------------
    from scipy.io import wavfile
    from daft_exprt_torch.fine_tune import fine_tuning
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.generate import prepare_sentences_for_inference
    from daft_exprt_torch.models.discriminators import (
        init_mpd_params, init_msd_params,
    )
    from daft_exprt_torch.text.cleaners import text_cleaner
    from daft_exprt_torch.text.symbols import arpabet_stressed
    from daft_exprt_torch.vocoder_finetune import (
        finetune, generator_to_weight_norm, load_discriminators,
        make_gan_steps, param_leaves,
    )

    # finetune-dataset: the preprocess corpus's features (every utterance
    # in one list; seeded stand-ins for the external ECAPA embeddings)
    # through fine_tuning with a seeded random acoustic model
    feats = os.path.join(pre_root, 'card', 'features')
    rng_e = np.random.RandomState(SEED + 4)
    lines_ft = []
    for spk, name, _ in corpus:
        np.save(os.path.join(feats, spk, f'{name}.spk_emb.npy'),
                rng_e.randn(hp.external_emb_dim).astype(np.float32))
        lines_ft.append(f'{os.path.join(feats, spk)}|{name}|'
                        f'{speakers.index(spk)}\n')

    def ft_hp(tag, fused, dtype='bfloat16'):
        lists = os.path.join(pre_root, tag)
        os.makedirs(lists, exist_ok=True)
        with open(os.path.join(lists, 'all.txt'), 'w') as f:
            f.writelines(lines_ft)
        return HyperParams(verbose=False, language='english',
                           speakers=speakers,
                           training_files=os.path.join(lists, 'all.txt'),
                           validation_files=os.path.join(lists, 'all.txt'),
                           output_directory=lists, batch_size=FT_B,
                           fused_attention='auto' if fused else False,
                           compute_dtype=dtype)

    hp_ft = ft_hp('finetune', True)
    ft_params = DaftExprt.from_hparams(hp_ft, seed=SEED).state_dict()
    ft_root = run_path('finetune-dataset', lambda: fine_tuning(
        hp_ft, dataset, params=ft_params, device='cuda'), kernels[:1])
    ft_counts = dict(fine_tuning.counts)
    n_ft_batches = len(corpus) // FT_B
    assert ft_counts == {'written': len(corpus), 'shape_mismatch': 0,
                         'too_short': 0}, ft_counts
    assert paths[-1][1]['fused_attention'] == 12 * n_ft_batches, paths[-1][1]
    # against the plain attention: in bf16 as information (one bf16 ulp
    # of an attention output, amplified through the 12 blocks of a random
    # model, moves a mel as much as bf16 rounding does), checked in float32
    # (the float32 kernels, 3xTF32)
    n0 = fused_attention.launches
    ft_plain = fine_tuning(ft_hp('finetune-plain', False), dataset,
                           params=ft_params, device='cuda')
    ft_f32 = {fused: fine_tuning(ft_hp(f'finetune-f32-{fused}', fused,
                                       'float32'), dataset,
                                 params=ft_params, device='cuda')
              for fused in (True, False)}
    assert fused_attention.launches == n0 + 12 * n_ft_batches, \
        'only the float32 fused call launches the kernel'
    worst_ft = worst_bf = 0.0
    for spk, name, _ in corpus:
        mel_k = np.load(os.path.join(ft_root, spk, f'{name}.npy'))
        mel_p = np.load(os.path.join(ft_plain, spk, f'{name}.npy'))
        mel_k32, mel_p32 = (np.load(os.path.join(ft_f32[fused], spk,
                                                 f'{name}.npy'))
                            for fused in (True, False))
        assert mel_k.shape == mel_p.shape == mel_k32.shape
        assert np.isfinite(mel_k).all() and np.isfinite(mel_k32).all()
        worst_bf = max(worst_bf, rel(mel_k, mel_p))
        worst_ft = max(worst_ft, rel(mel_k32, mel_p32))
        wav_c, sr_c = load_wav(os.path.join(dataset, spk, 'wavs',
                                            f'{name}.wav'),
                               target_sr=hp.sampling_rate)
        with open(os.path.join(feats, spk, f'{name}.markers')) as f:
            mk = [line.split('\t') for line in f]
        crop = wav_c[int(float(mk[0][0]) * sr_c):int(float(mk[-1][1]) * sr_c)]
        _, saved = wavfile.read(os.path.join(ft_root, spk, f'{name}.wav'))
        assert np.array_equal(saved, (crop * 32767.5).clip(
            -32768, 32767).astype(np.int16)), (spk, name)
        assert mel_k.shape[1] == sum(int(m[2]) for m in mk)
    log(f'path finetune-dataset: {ft_counts}; {n_ft_batches} batches of '
        f'{FT_B}, fused_attention {paths[-1][1]["fused_attention"]} '
        f'launches; each .wav the marker crop of its corpus wav; .npy vs the '
        f'plain attention rel_l2 {worst_bf:.3e} at worst in bf16 (no band), '
        f'{worst_ft:.3e} in float32 (band 1e-2)')
    assert worst_ft <= 1e-2, worst_ft

    # gan-step: scripts/bench_gan_step.py's shape at full width, V1 + MPD +
    # MSD, five iterations a dtype (TF32 as train.py: cuDNN's default for
    # float32 convs, none in the matmuls; the loss mel in full float32)
    rng_g = np.random.RandomState(SEED + 5)
    gan_mel = (0.5 * rng_g.randn(GAN_B, hp.n_mel_channels,
                                 GAN_SEG // 256) - 4.0).astype(np.float32)
    gan_y = (0.1 * rng_g.randn(GAN_B, 1, GAN_SEG)).astype(np.float32)

    def gan_setup(dtype, b, device, mesh=None):
        d_step, g_step, (optim_g, optim_d), loss_mel_fn = make_gan_steps(
            DEFAULT_CONFIG, compute_dtype=dtype, device=device, mesh=mesh)
        g_wn = generator_to_weight_norm(init_generator_params(
            SEED, device=device))
        mpd, msd = init_mpd_params(SEED, device), init_msd_params(SEED,
                                                                   device)
        mel_g = torch.from_numpy(gan_mel[:b]).to(device)
        y_g = torch.from_numpy(gan_y[:b]).to(device)
        with torch.no_grad():
            y_mel = loss_mel_fn(y_g[:, 0])
        state = dict(g_wn=g_wn, mpd=mpd, msd=msd, g_opt=optim_g(g_wn),
                     d_opt=optim_d(mpd, msd))

        def iteration(ranges=False):
            with _range(torch, 'd_step', ranges):
                d_loss = d_step(mpd, msd, state['d_opt'], g_wn, mel_g, y_g)
            with _range(torch, 'g_step', ranges):
                g_loss, mel_l1 = g_step(g_wn, state['g_opt'], mpd, msd,
                                        mel_g, y_g, y_mel)
            return float(d_loss), float(g_loss), float(mel_l1)
        return iteration, state

    def gan_run(dtype):
        iteration, state = gan_setup(dtype, GAN_B, dev)
        u0 = state['msd'].scale_0.conv_0.u.clone()
        losses, secs = [], []
        for _ in range(GAN_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(iteration())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        tensors = param_leaves(state['g_wn']) + list(
            state['mpd'].parameters()) + list(state['msd'].parameters()) + \
            list(state['msd'].buffers())
        for opt in (state['g_opt'], state['d_opt']):
            tensors += [v for st in opt.state.values() for k, v in st.items()
                        if k != 'step']
        assert all(t.dtype == torch.float32 for t in tensors), dtype
        assert all(math.isfinite(v) for loss in losses for v in loss), losses
        moved = float((state['msd'].scale_0.conv_0.u - u0).abs().max())
        assert moved > 0, 'the spectral state did not move'
        del state, iteration
        torch.cuda.empty_cache()
        return losses, secs, moved

    gan = run_path('gan-step', lambda: {dt: gan_run(dt) for dt in (
        'float32', 'bfloat16')}, ())
    gan_s = {}
    for dt, (losses, secs, moved) in gan.items():
        gan_s[dt] = float(np.median(secs[1:]))
        log(f'path gan-step {dt}: losses (d, g, mel_l1) '
            + ' '.join(f'({d:.6g}, {g:.6g}, {m:.6g})' for d, g, m in losses)
            + f'; scale_0 u moved {moved:.3e}; host s/iteration '
            f'{[round(x, 4) for x in secs]}')
        log(f'path gan-step {dt}: {gan_s[dt]:.4f} s/iteration (median of '
            f'iterations 2-{GAN_ITERS}, synchronised) at B={GAN_B} x '
            f'{GAN_SEG} samples, full V1 width: {GAN_B / gan_s[dt]:.2f} '
            f'segments/s [{smi.splitlines()[0]}]')
    f32_0, b16_0 = gan['float32'][0][0], gan['bfloat16'][0][0]
    for a, b in zip(f32_0, b16_0):
        assert abs(a - b) < 0.1 * max(abs(a), 1.0), (f32_0, b16_0)
    log(f'path gan-step: first bf16 iteration {b16_0} vs float32 {f32_0} '
        '(band |a - b| < 0.1 max(|a|, 1))')
    # the first float32 iteration on the card (TF32 off) against the port's
    # CPU run of the same iteration, B = 2 x 8192 at full width
    with vk.full_f32():
        card_it, _ = gan_setup('float32', GAN_CPU_B, dev)
        card_l = card_it()
    cpu_it, _ = gan_setup('float32', GAN_CPU_B, 'cpu')
    t0 = time.perf_counter()
    cpu_l = cpu_it()
    cpu_s = time.perf_counter() - t0
    r_gan = [abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l)]
    log(f'path gan-step: card (TF32 off) {card_l} vs the CPU {cpu_l} at '
        f'B={GAN_CPU_B}: rel {r_gan} (bands 1e-4, 1e-3, 1e-3; the CPU '
        f'iteration took {cpu_s:.1f} s)')
    assert r_gan[0] <= 1e-4 and r_gan[1] <= 1e-3 and r_gan[2] <= 1e-3, r_gan
    del card_it, cpu_it
    torch.cuda.empty_cache()

    # finetune: the entry point on finetune-dataset's speaker_0 pairs, full
    # V1 width, then its generator served on the bf16 kernels
    ft_out = os.path.join(ROOT, 'build', 'smoke', 'finetune')
    shutil.rmtree(ft_out, ignore_errors=True)
    val_l1 = []

    class ValLog(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith('Validation mel L1'):
                val_l1.append(float(msg.rsplit(' ', 1)[1]))
    ft_log = logging.getLogger('daft_exprt_torch.vocoder_finetune')
    ft_log.setLevel(logging.INFO)
    ft_log.addHandler(ValLog())
    ft_pairs = os.path.join(ft_root, speakers[0])
    val_mel = np.load(os.path.join(ft_pairs, 'utt_0.npy'))

    def finetune_path():
        out = finetune(ft_pairs, ft_out, init_generator_params(SEED),
                       training_steps=FT_STEPS, batch_size=2,
                       checkpoint_interval=2, log_interval=1, seed=SEED,
                       val_names=['utt_0'], device='cuda')
        payload, meta = ckpt.load_checkpoint(os.path.join(ft_out,
                                                          'g_00000004'))
        served = HiFiGanVocoder(payload['model']['generator'], fast='bf16')
        return out, payload, meta, served, served.infer(val_mel)

    ft_gen, ft_payload, ft_meta, ft_voc, ft_wav = run_path(
        'finetune', finetune_path, kernels[1:3])
    assert paths[-1][1] == {'fused_mrf_tc': 6, 'fused_mrf_phase': 2}, \
        paths[-1][1]
    for step in (2, 4):
        g_payload, _ = ckpt.load_checkpoint(os.path.join(ft_out,
                                                         f'g_{step:08d}'))
        assert len(param_leaves(g_payload['model']['generator'])) == \
            len(param_leaves(ft_gen))
        load_discriminators(os.path.join(ft_out, f'do_{step:08d}'))
    assert ft_meta['iteration'] == 4
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        param_leaves(ft_payload['model']['generator']),
        param_leaves(ft_gen)))
    assert len(val_l1) == 2 and all(math.isfinite(v) for v in val_l1), val_l1
    exact_ft = HiFiGanVocoder(ft_payload['model']['generator'],
                              fast=False).infer(val_mel)
    r_ft = rel(ft_wav, exact_ft)
    log(f'path finetune: {FT_STEPS} steps at batch 2 on '
        f'{len(os.listdir(ft_pairs)) // 2} pairs, validation mel L1 {val_l1}; '
        f'g_00000004 served in bf16 on {val_mel.shape[1]} frames: waveform '
        f'vs the float32 plain route rel_l2={r_ft:.3e} (band 5e-2)')
    assert ft_wav.shape == (val_mel.shape[1] * 256,) and r_ft <= 5e-2, r_ft
    del ft_gen, ft_payload, ft_voc

    # text: a sentences file through prepare_sentences_for_inference (an
    # MFA-style dictionary under a home of the smoke's own; an mfa on PATH
    # that would leave a mark), then generate_mel_specs(batch_size=1) with
    # the int8-static vocoder
    text_root = os.path.join(ROOT, 'build', 'smoke', 'text')
    shutil.rmtree(text_root, ignore_errors=True)
    os.makedirs(os.path.join(text_root, 'bin'))
    mark = os.path.join(text_root, 'mfa_ran')
    with open(os.path.join(text_root, 'bin', 'mfa'), 'w') as f:
        f.write(f'#!/bin/sh\ntouch {mark}\n')
    os.chmod(os.path.join(text_root, 'bin', 'mfa'), 0o755)
    text_file = os.path.join(text_root, 'sentences.txt')
    with open(text_file, 'w') as f:
        f.write('\n'.join(TEXT_SENTENCES) + '\n')
    env_keep = {k: os.environ.get(k) for k in ('HOME', 'PATH')}
    os.environ['HOME'] = os.path.join(text_root, 'home')
    os.environ['PATH'] = os.path.join(text_root, 'bin') + os.pathsep + \
        env_keep['PATH']
    try:
        hp_text = HyperParams(verbose=False, training_files='unused',
                              validation_files='unused',
                              output_directory=text_root, language='english',
                              speakers=['lj'])
        n_words = len(write_mfa_dictionary(
            hp_text.mfa_dictionary, TEXT_SENTENCES,
            lambda s: text_cleaner(s, 'english'), arpabet_stressed))
        prepared = {n_jobs: prepare_sentences_for_inference(
            text_file, os.path.join(text_root, f'jobs_{n_jobs}'), hp_text,
            n_jobs=n_jobs) for n_jobs in (2, 1)}
    finally:
        for k, v in env_keep.items():
            os.environ[k] = v
    outs = {}
    for n_jobs in prepared:
        with open(os.path.join(text_root, f'jobs_{n_jobs}',
                               'sentences_to_generate.txt')) as f:
            outs[n_jobs] = f.read()
    assert outs[2] == outs[1] and prepared[2] == prepared[1]
    assert '<unk>' not in outs[2] and not os.path.exists(mark)
    text_sents, text_names = prepared[2]
    log(f'path text: {len(text_sents)} sentences, {n_words} dictionary '
        f'words, n_jobs 2 == n_jobs 1, no <unk>, no mfa subprocess: '
        + ' | '.join(outs[2].splitlines()))
    rng_t = np.random.RandomState(SEED + 6)
    text_prosody = []
    for sent in text_sents:
        n = sum(len(x) if isinstance(x, list) else 1 for x in sent)
        text_prosody.append({
            'symbols': list(range(n)),
            'durations_frames': rng_t.randint(4, 9, n).astype(np.float64),
            'energy': rng_t.rand(n) * 3.0,
            'pitch': np.where(rng_t.rand(n) < 0.3, 0.0,
                              100.0 + 150.0 * rng_t.rand(n))})
    text_out = os.path.join(text_root, 'out')

    def text_path():
        text_synth = Synthesizer(model, hp, vocoder=vocoder_q8)
        preds = generate_mel_specs(
            text_synth, text_sents, text_names, [0] * len(text_names),
            text_out, hp, batch_size=1, get_time_perf=True,
            external_prosody=text_prosody, external_embeddings=emb,
            external_accent_emb=emb[:model.hidden_dim], save_outputs=save)
        return preds, None if save else {
            k: text_synth.vocoder.infer(v[4]) for k, v in preds.items()
            if k != '__rtf__'}

    text_preds, text_wavs = run_path('text', text_path, (
        fused_attention, vk.fused_mrf_tc_q8, mi.fused_mrf_phase_q8))
    assert paths[-1][1]['fused_attention'] == 8 * len(text_names)
    assert paths[-1][1]['fused_mrf_phase_q8'] == 4 * len(text_names)
    for name in text_names:
        m = text_preds[f'{name}_spk_0'][4]
        w = text_wavs[f'{name}_spk_0'] if text_wavs else \
            vocoder_q8.infer(m)
        assert w.shape == (m.shape[1] * 256,) and np.isfinite(w).all()
        r = rel(w, plain_int8(vocoder_q8, m)[0])
        log(f'path text {name}: {m.shape[1]} frames, waveform vs the plain '
            f'int8 route rel_l2={r:.3e} (band 1e-2)')
        assert r <= 1e-2, r

    # ---- 3b. training ------------------------------------------------------
    attn_kernels = (fused_attention, fused_attention_bwd)
    hp_t = HyperParams(verbose=False, training_files='unused',
                       validation_files='unused',
                       output_directory=os.path.join(ROOT, 'build', 'smoke'),
                       language='english', speakers=['lj'])

    pitch_pp = random_pitch_predictor(hp_t.n_mel_channels,
                                      SEED + 1).to(dev).frozen()
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
    ts_metrics, step_s = train_step_path('train-step', hp_t, TRAIN_STEPS,
                                         (1e-2, 5e-2))
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
    torch.save(random_pitch_predictor(hp_t.n_mel_channels,
                                      SEED + 2).state_dict(), pp_path)
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

    # ---- 3c. scale-out ------------------------------------------------------
    # ddp-train-step and gan-dp: NCCL at world 1 in this process; ddp-2rank
    # and voc-tp: two spawned ranks sharing the card over gloo
    store = os.path.join(ROOT, 'build', 'smoke', 'pg_store')
    if os.path.exists(store):
        os.remove(store)
    init_distributed(0, 1, 'file://' + store, device='cuda', timeout=300)
    mesh1 = make_mesh()
    log(f'scale-out: process group {dist.get_backend()} world '
        f'{dist.get_world_size()}, mesh {mesh1.n_data}x{mesh1.n_model} on '
        f'{mesh1.device}')
    dev_batch = to_device(tbatch, dev)
    dev_raw = to_device({'frames_energy': tbatch['frames_energy'],
                         'frames_pitch': tbatch['frames_pitch']}, dev)
    cudnn_det = torch.backends.cudnn.deterministic

    def train_steps(mesh):
        """TRAIN_STEPS steps of train-step's model, batch and seed."""
        xmodel = DaftExprt.from_hparams(hp_t, seed=SEED).train()
        step = make_train_step(xmodel, make_optimizer(xmodel, hp_t),
                               loss_cfg, pitch_pp, mesh=mesh)
        out, secs = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            m = step(dev_batch, dev_raw, float(i), SEED)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            out.append({k: float(v) for k, v in m.items()})
        return out, secs

    # both runs with cuDNN's deterministic algorithms, so that equality
    # tests the step and not the card's atomics
    torch.backends.cudnn.deterministic = True
    ref_m, ref_s = train_steps(None)
    ddp_m, ddp_s = run_path('ddp-train-step', lambda: train_steps(mesh1),
                            attn_kernels)
    torch.backends.cudnn.deterministic = cudnn_det
    assert paths[-1][1] == {'fused_attention': 12 * TRAIN_STEPS,
                            'fused_attention_bwd': 24 * TRAIN_STEPS}, \
        paths[-1][1]
    for i, (a, b) in enumerate(zip(ddp_m, ref_m)):
        log(f'path ddp-train-step: step {i}: loss {a["loss"]!r} grad_norm '
            f'{a["grad_norm"]!r}; single process {b["loss"]!r} '
            f'{b["grad_norm"]!r}')
        assert a == b, (i, a, b)
    same_ts = all(a['loss'] == b['loss'] and a['grad_norm'] == b['grad_norm']
                  for a, b in zip(ddp_m, ts_metrics))
    ddp_step = float(np.median(ddp_s[1:]))
    log(f'path ddp-train-step: every metric of {TRAIN_STEPS} steps equal to '
        f'the single-process step bit for bit (both with cuDNN '
        f'deterministic; equal to the train-step path\'s run, cuDNN '
        f'default: {same_ts}); {ddp_step:.4f} s/step (median of steps '
        f'2-{TRAIN_STEPS}) against the single process\'s '
        f'{float(np.median(ref_s[1:])):.4f} in the same setting and '
        f'train-step\'s {per_step:.4f} [{smi.splitlines()[0]}]')
    del dev_batch, dev_raw
    torch.cuda.empty_cache()

    # ddp-2rank: the float32 step on two ranks over gloo against one
    # process, B = 16 split 8 + 8, halves of other lengths and voicing
    hp_d = ddp_hparams()
    d_batch, d_raw = ddp_batch(hp_d, TB, TL, TT)
    # cuDNN's deterministic algorithms on both sides: the second step's
    # loss moves with the sign of every near-zero gradient element (Adam's
    # first update is ~lr sign(g)), so atomics' order would move it between
    # runs
    torch.backends.cudnn.deterministic = True
    with vk.full_f32():
        dmodel = DaftExprt.from_hparams(hp_d, seed=SEED).train()
        dstep = make_train_step(dmodel, make_optimizer(dmodel, hp_d),
                                loss_cfg_from_hparams(hp_d), pitch_pp)
        ref2 = [{k: float(v) for k, v in dstep(
            to_device(d_batch, dev), to_device(d_raw, dev), float(i),
            SEED).items()} for i in range(DDP_STEPS)]
    torch.backends.cudnn.deterministic = cudnn_det
    del dmodel, dstep
    torch.cuda.empty_cache()
    r0, r1 = run_path('ddp-2rank', lambda: run_ranks(
        ddp_rank, 2, args=(d_batch, d_raw, DDP_STEPS), backend='gloo',
        device='cuda', timeout=900, pg_timeout=300), ())
    assert r0['metrics'] == r1['metrics'], (r0['metrics'], r1['metrics'])
    assert r0['rows'] == r1['rows'] == TB // 2
    for i, (a, b) in enumerate(zip(r0['metrics'], ref2)):
        r_loss = abs(a['loss'] - b['loss']) / abs(b['loss'])
        r_norm = abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm'])
        log(f'path ddp-2rank: step {i}: loss {a["loss"]:.9g} (one process '
            f'{b["loss"]:.9g}, rel {r_loss:.3e}, band 1e-5), grad_norm '
            f'{a["grad_norm"]:.9g} ({b["grad_norm"]:.9g}, rel {r_norm:.3e}, '
            'band 1e-4)')
        assert r_loss <= 1e-5 and r_norm <= 1e-4, (r_loss, r_norm)
    for res in (r0, r1):
        n = {k: v[0] for k, v in res['counts'].items()}
        assert n == {'fused_attention': 12 * DDP_STEPS,
                     'fused_attention_bwd': 24 * DDP_STEPS}, n
        assert all(k[-1] == 'float32' for _, calls in res['counts'].values()
                   for k in calls), res['counts']
    log(f'path ddp-2rank: each rank launched {r0["counts"]}; host s/step '
        f'{[round(x, 4) for x in r0["secs"]]} (rank 0) '
        f'{[round(x, 4) for x in r1["secs"]]} (rank 1); gloo all-reduce of '
        f'{r0["n_grad"]} float32 (the gradient) '
        f'{[round(x, 4) for x in r0["allreduce_s"]]} s '
        f'[{smi.splitlines()[0]}]')

    # gan-dp: the GAN steps over the world-1 mesh against gan-step's
    torch.backends.cudnn.deterministic = True
    ref_it, _ = gan_setup('float32', GAN_B, dev)
    gan_ref = ref_it()
    del ref_it
    torch.cuda.empty_cache()

    def gan_dp_run():
        iteration, _ = gan_setup('float32', GAN_B, dev, mesh=mesh1)
        first = iteration()
        torch.backends.cudnn.deterministic = cudnn_det
        secs = []
        for _ in range(GAN_ITERS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = iteration()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            assert all(math.isfinite(v) for v in loss), loss
        return first, secs

    gan_first, gan_dp_s = run_path('gan-dp', gan_dp_run, ())
    assert gan_first == gan_ref, (gan_first, gan_ref)
    gan_dp_it = float(np.median(gan_dp_s))
    log(f'path gan-dp: first iteration (d_loss, g_loss, mel_l1) {gan_first}'
        f' equal to one process\'s bit for bit (both with cuDNN '
        f'deterministic; the gan-step path\'s: {gan["float32"][0][0]}); '
        f'{gan_dp_it:.4f} s/iteration (median of iterations 2-{GAN_ITERS}) '
        f'against gan-step\'s {gan_s["float32"]:.4f} '
        f'[{smi.splitlines()[0]}]')
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # voc-tp: V1's channels over two ranks (1 x 2, gloo) against the plain
    # float32 generator
    rng_v = np.random.RandomState(SEED + 9)
    tp_mel = (0.5 * rng_v.randn(TP_B, hp.n_mel_channels, TP_FRAMES)
              - 4.0).astype(np.float32)
    t0, t1 = run_path('voc-tp', lambda: run_ranks(
        tp_rank, 2, args=(tp_mel,), backend='gloo', device='cuda',
        timeout=900, pg_timeout=300), ())
    with vk.full_f32(), torch.no_grad():
        tp_ref = generator_forward(init_generator_params(SEED),
                                   torch.from_numpy(tp_mel).to(dev),
                                   DEFAULT_CONFIG).cpu().numpy()
    r_tp = rel_l2(torch.from_numpy(t0['wav']), torch.from_numpy(tp_ref))
    assert np.array_equal(t0['wav'], t1['wav'])
    log(f'path voc-tp: waveform {t0["wav"].shape} against the plain float32 '
        f'generator rel_l2={r_tp:.3e} (band 1e-5); rank shards '
        f'conv_pre {t0["shapes"]["conv_pre"]}, ups_0 {t0["shapes"]["ups_0"]}'
        f'; host s/call {[round(x, 4) for x in t0["secs"]]} '
        f'[{smi.splitlines()[0]}]')
    assert t0['wav'].shape == tp_ref.shape and r_tp <= 1e-5, r_tp

    # profile-trace: profiler_trace around one bf16 synthesis call
    trace_dir = os.path.join(ROOT, 'build', 'smoke', 'trace')
    shutil.rmtree(trace_dir, ignore_errors=True)
    counter = ThroughputCounter(hp)

    def traced():
        with profiler_trace(trace_dir):
            t0 = time.perf_counter()
            out = synthesize()
            counter.add([T] * B, time.perf_counter() - t0)
        return out

    run_path('profile-trace', traced, kernels[:3])
    trace_file = os.path.join(trace_dir, 'trace.json')
    with open(trace_file) as f:
        events = json.load(f)['traceEvents']
    n_kern = sum(e.get('cat') == 'kernel' for e in events)
    log(f'path profile-trace: {trace_file} {os.path.getsize(trace_file)} '
        f'bytes, {len(events)} events, {n_kern} device kernels; '
        f'ThroughputCounter {counter.rate:.2f} audio-s/s (one call under '
        f'the profiler) [{smi.splitlines()[0]}]')
    assert events

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
        if name == 'fused_mrf_ct' and mode == 'float32':
            table[-1]['off_path'] = ct_f32
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
    _, pre_s = timed(features)
    log(f'end to end preprocess-batch: {pre_s:.4f} s for {pre_audio_s:.2f} '
        f'audio-s at B={PRE_B}: {pre_audio_s / pre_s:.2f} audio-s/s (host '
        f'clock, synchronized) [{smi.splitlines()[0]}]')
    log(f'end to end train-step: {per_step:.4f} s/step (median of steps '
        f'2-{TRAIN_STEPS}) at B={TB}, L={TL}, T={TT}: {1 / per_step:.3f} '
        f'steps/s, {TB / per_step:.2f} utterances/s (host clock, '
        'synchronized)')
    for dt, sec in gan_s.items():
        log(f'end to end gan-step {dt}: {sec:.4f} s/iteration (median of '
            f'iterations 2-{GAN_ITERS}) at B={GAN_B} x {GAN_SEG} samples: '
            f'{GAN_B / sec:.2f} segments/s (host clock, synchronized) '
            f'[{smi.splitlines()[0]}]')

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
        profile_path(torch, features, 'preprocess-batch',
                     ranges=('mel', 'energy', 'pitch'))
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
        for dt in ('float32', 'bfloat16'):
            gan_it, _ = gan_setup(dt, GAN_B, dev)
            profile_path(torch, gan_it, f'gan-step-{dt}',
                         ranges=('d_step', 'g_step'))
            del gan_it
            torch.cuda.empty_cache()

    log(json.dumps({'kernels': table}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

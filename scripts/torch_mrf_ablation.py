#!/usr/bin/env python3
"""Where the time of the port's MRF kernels goes, on one CUDA card.

    python3 scripts/torch_mrf_ablation.py [--iters N] [--sections a,b]
                                          [--builds kernel,no_mma,...]

Builds the kernels' sources as they are and with ablations that remove a
part of the work (the results are then wrong and not checked), and times
each build at the V1 shapes of a B=8 x 1024-frame synthesis call
(chip_smoke.py's KernelCases, seeded unit-gain weights); the unablated
build must match the plain version (the int8 sections bit for bit, a
conv_post waveform within one bf16 ulp; the bf16 sections within rel-L2
1e-2). Sections:

- ``bf16``: the bf16 tier's block-resident engine (mrf_chain_bf16.cuh:
  tc_bf_kernel, phase_bf_kernel; fused_mrf_tc and fused_mrf_phase in
  bf16, and fused_resblock1 in bf16 at chip_smoke.py's resblock1 shapes,
  one chain a launch), ablated by MRF_ABL_NOW (no weight copies), MRF_ABL_NOMMA (no
  wgmma), MRF_ABL_NOEPI (no conv epilogues: the residual and conv-input
  writes, the chains' outputs) and the three together (the skeleton:
  loads, the per-block prologue and tail, launches).
- ``bf16_steps``: the bf16 kernel still on the one-launch-per-step route
  (mrf_phase.cu: step_kernel, ups_kernel, post_kernel of mrf_common.cuh):
  fused_mrf_ptc's fdot mode at V1's narrow levels, ablated by
  MRF_ABL_STEP_NOW (no weight loads), MRF_ABL_STEP_NOMMA (no mma.sync),
  MRF_ABL_STEP_NOF32 (no float32 residual and chain-sum traffic) and all
  three (the skeleton of launches and tails).
- ``f32``: the float32 chain kernel (mrf_chain_f32.cuh: tc_f32_kernel,
  3xTF32 on the tensor cores; fused_resblock1 in float32 at chip_smoke.py's
  resblock1 shapes and fused_mrf_tc in float32 at V1's L0), ablated by
  MRF_ABL_NOW (no weight copies), MRF_ABL_NOMMA (no A fragment loads and
  no mma.sync: the epilogues see zero sums) and the two together.
- ``static``: the block-resident int8-static kernels (mrf_tc_q8.cu,
  mrf_ptc.cu: fused_mrf_tc_q8, fused_mrf_ptc static), ablated by
  MRF_ABL_NOW (no weight copies: the convs read whatever the ring holds),
  MRF_ABL_NOMMA (no ldmatrix/wgmma: the epilogues see zero sums),
  MRF_ABL_NOEPI (no conv epilogues), MRF_ABL_NOSYNC (no __syncthreads per
  weight stage; only beside the first two).
- ``conv_dyn``: the one-launch-per-conv int8-dynamic kernel
  (conv_dyn_kernel, mrf_dyn.cuh) where it still runs at V1's shapes:
  fused_mrf_ptc dyn at L2/L3 (mrf_ptc.cu), ablated by MRF_ABL_NOW (no
  weight loads), MRF_ABL_NOMMA (no mma.sync), MRF_ABL_NOF32 (no float32
  input, residual and output traffic), MRF_ABL_NOQ (no rint/conversion in
  the prologue quantisation).
- ``dyn_blk``: the segment-synchronised int8-dynamic engine
  (mrf_dyn_blk.cuh: fused_mrf_ct_q8 at C = 256/128, fused_mrf_phase_q8
  dynamic at C = 64/32), ablated by MRF_ABL_NOW, MRF_ABL_NOMMA,
  MRF_ABL_NOEPI and MRF_ABL_NOBAR (no segment barrier: every block reads
  the scale word without waiting).

Prints the card (nvidia-smi name and power limit), then per section,
build and shape the median of CUDA-event timings, and one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SKELETON = ['-DMRF_ABL_NOW', '-DMRF_ABL_NOMMA']
STEP_SKELETON = ['-DMRF_ABL_STEP_NOW', '-DMRF_ABL_STEP_NOMMA',
                 '-DMRF_ABL_STEP_NOF32']
# the bf16 path's levels and chip_smoke.py's resblock1 path (bf16 half)
BF16_SHAPES = (('fused_mrf_tc', (8, 8192, 256)),
               ('fused_mrf_tc', (8, 65536, 128)),
               ('fused_mrf_phase', (8, 128, 65536)),
               ('fused_mrf_phase', (8, 64, 131072))) + tuple(
    ('fused_resblock1', (8, n, C, k, (1, 3, 5), 'bfloat16'))
    for n, C in ((8192, 256), (65536, 128)) for k in (3, 7, 11))
ENGINE_SKELETON = SKELETON + ['-DMRF_ABL_NOEPI']
# chip_smoke.py's resblock1 path (float32 half) and tc-f32 path
F32_SHAPES = tuple(('fused_resblock1', (8, n, C, k, (1, 3, 5), 'float32'))
                   for n, C in ((8192, 256), (65536, 128))
                   for k in (3, 7, 11)) + (
    ('fused_mrf_tc', (8, 8192, 256, 'float32')),)
# chip_smoke.py's bf16-ptc path (fdot)
STEP_SHAPES = (('fused_mrf_ptc_f', (8, 128, 65536, 'fdot')),
               ('fused_mrf_ptc_f', (8, 64, 131072, 'fdot')))


SECTIONS = {
    'bf16': dict(
        sources=('mrf_tc', 'mrf_phase'), band=1e-2,
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_epilogue': ['-DMRF_ABL_NOEPI'],
            'skeleton': ENGINE_SKELETON,
        },
        shapes=BF16_SHAPES),
    'bf16_steps': dict(
        sources=('mrf_phase',), band=1e-2,
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_STEP_NOW'],
            'no_mma': ['-DMRF_ABL_STEP_NOMMA'],
            'no_f32': ['-DMRF_ABL_STEP_NOF32'],
            'skeleton': STEP_SKELETON,
        },
        shapes=STEP_SHAPES),
    'f32': dict(
        sources=('mrf_tc',), band=1e-5,
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_weights_no_mma': SKELETON,
        },
        shapes=F32_SHAPES),
    'static': dict(
        sources=('mrf_tc_q8', 'mrf_ptc'),
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_weights_no_mma': SKELETON,
            'skeleton_no_epilogue': SKELETON + ['-DMRF_ABL_NOEPI'],
            'skeleton_no_stage_sync': SKELETON + ['-DMRF_ABL_NOSYNC'],
        },
        shapes=(('fused_mrf_tc_q8', (8, 8192, 256)),
                ('fused_mrf_tc_q8', (8, 65536, 128)),
                ('fused_mrf_ptc', (8, 65536, 128, 'q8f')),
                ('fused_mrf_ptc', (8, 131072, 64, 'q8f')))),
    'conv_dyn': dict(
        sources=('mrf_ptc',),
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_f32': ['-DMRF_ABL_NOF32'],
            'no_quant': ['-DMRF_ABL_NOQ'],
            'no_weights_no_mma': SKELETON,
            'skeleton_no_f32_no_quant': SKELETON + ['-DMRF_ABL_NOF32',
                                                    '-DMRF_ABL_NOQ'],
        },
        shapes=(('fused_mrf_ptc', (8, 65536, 128, 'dynamic')),
                ('fused_mrf_ptc', (8, 131072, 64, 'dynamic')))),
    'dyn_blk': dict(
        sources=('mrf_ct_q8', 'mrf_phase_q8'),
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_barrier': ['-DMRF_ABL_NOBAR'],
            'no_weights_no_mma': SKELETON,
            'skeleton_no_epilogue': SKELETON + ['-DMRF_ABL_NOEPI'],
            'skeleton_no_epilogue_no_barrier': SKELETON + [
                '-DMRF_ABL_NOEPI', '-DMRF_ABL_NOBAR'],
        },
        shapes=(('fused_mrf_ct_q8', (8, 8192, 256)),
                ('fused_mrf_ct_q8', (8, 65536, 128)),
                ('fused_mrf_phase_q8', (8, 65536, 128, 'dynamic')),
                ('fused_mrf_phase_q8', (8, 131072, 64, 'dynamic')))),
}


def build(_build, out_dir, sections):
    """Every build of every section's sources, one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs, by_flags, libs = [], {}, {}
    for sec in sections:
        for v, flags in SECTIONS[sec]['builds'].items():
            for src in SECTIONS[sec]['sources']:
                out = by_flags.get((src, tuple(flags)))
                if out is None:
                    out = os.path.join(out_dir, f'lib{src}-{sec}-{v}.so')
                    by_flags[src, tuple(flags)] = out
                    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, '-o',
                           out, str(_build.CSRC / f'{src}.cu')]
                    procs.append((v, src, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
                libs[sec, src, v] = out
    for v, src, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc {src} [{v}] failed:\n{log}')
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_mrf_ablation: no CUDA device', file=sys.stderr)
        sys.exit(2)
    iters = int(sys.argv[sys.argv.index('--iters') + 1]) if '--iters' in sys.argv else 10
    sections = (sys.argv[sys.argv.index('--sections') + 1].split(',')
                if '--sections' in sys.argv else list(SECTIONS))
    if '--builds' in sys.argv:      # only these builds of each section
        keep = sys.argv[sys.argv.index('--builds') + 1].split(',')
        for sec in sections:
            SECTIONS[sec]['builds'] = {v: f for v, f in
                                       SECTIONS[sec]['builds'].items()
                                       if v in keep}
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch.nn.functional as F
    from daft_exprt_torch.models.hifigan import DEFAULT_CONFIG
    from daft_exprt_torch.ops import _build
    from daft_exprt_torch.ops import mrf_ct as mc
    from daft_exprt_torch.ops import mrf_int8 as mi
    from daft_exprt_torch.ops import vocoder_kernels as vk

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    libs = build(_build, os.path.join(ROOT, 'build', 'ablation'), sections)
    print(f'build: {time.perf_counter() - t0:.1f} s', flush=True)
    ks = tuple(DEFAULT_CONFIG['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in DEFAULT_CONFIG['resblock_dilation_sizes'])
    dev = torch.device('cuda')
    wrappers = {'fused_mrf_tc': vk.fused_mrf_tc,
                'fused_mrf_phase': vk.fused_mrf_phase,
                'fused_resblock1': vk.fused_resblock1,
                'fused_mrf_ptc_f': vk.fused_mrf_ptc_f,
                'fused_mrf_tc_q8': vk.fused_mrf_tc_q8,
                'fused_mrf_ptc': mi.fused_mrf_ptc,
                'fused_mrf_ct_q8': mi.fused_mrf_ct_q8,
                'fused_mrf_phase_q8': mi.fused_mrf_phase_q8}
    results = {}
    for sec in sections:
        spec = SECTIONS[sec]
        ref = {}
        for v in spec['builds']:
            for src in spec['sources']:
                _build._libs[src] = ctypes.CDLL(libs[sec, src, v])
            cases = cs.KernelCases(torch, F, vk, mi, mc, None, dev, ks, dils)
            for name, key in spec['shapes']:
                c = cases.case(name, key)
                fn, wrapper = c['fn'], wrappers[name]
                n0 = wrapper.launches
                out = fn()
                torch.cuda.synchronize()
                launches = wrapper.launches - n0
                err = None
                if v == 'kernel':
                    if (name, key) not in ref:
                        ref[name, key] = c['plain']()
                    if 'band' in spec:
                        err = cs.rel_l2(out.float(), ref[name, key].float())
                        assert err <= spec['band'], (sec, v, name, key, err)
                    else:
                        err = cs.max_abs(out.float(), ref[name, key].float())
                        post = key[2] == 64
                        assert err <= (4e-3 if post else 0.0), (sec, v, name, key, err)
                ms = cs.time_ms(torch, fn, warmup=2, iters=iters)
                results.setdefault(sec, {}).setdefault(v, []).append(dict(
                    kernel=name, shape=c['desc'], ms=ms, launches=launches,
                    err_vs_plain=err))
                print(f'{sec:8s} {v:28s} {name} {c["desc"]}: {ms:.4f} ms, '
                      f'{launches} launches, vs plain {err}', flush=True)
                del out, c
            torch.cuda.empty_cache()
    print(json.dumps({'sections': results,
                      'flags': {s_: SECTIONS[s_]['builds'] for s_ in sections},
                      'device': torch.cuda.get_device_name(0)}))


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Where the time of the port's MRF kernels goes, on one CUDA card.

    python3 scripts/torch_mrf_ablation.py [--iters N] [--sections a,b]
                                          [--builds kernel,no_mma,...]
                                          [--ptxas]

Builds the kernels' sources as they are and with ablations that remove a
part of the work (the results are then wrong and not checked), and times
each build at the V1 shapes of a B=8 x 1024-frame synthesis call
(chip_smoke.py's KernelCases, seeded unit-gain weights); the unablated
build must match the plain version (the int8 sections bit for bit, a
conv_post waveform within one bf16 ulp; the bf16 sections within rel-L2
1e-2). Sections:

- ``bf16``: the bf16 tier's block-resident engine (mrf_chain_bf16.cuh:
  tc_bf_kernel, phase_bf_kernel; fused_mrf_tc and fused_mrf_phase in
  bf16, fused_mrf_ptc's fdot mode at V1's narrow levels (phase_bf_kernel
  with a float32 upsample output), and fused_resblock1 in bf16 at
  chip_smoke.py's resblock1 shapes, one chain a launch), ablated by
  MRF_ABL_NOW (no weight copies), MRF_ABL_NOMMA (no wgmma), MRF_ABL_NOEPI
  (no conv epilogues: the residual and conv-input writes, the chains'
  outputs) and the three together (the skeleton: loads, the per-block
  prologue and tail, launches).
- ``fdot``: fused_mrf_ptc's fdot mode at the bf16-ptc path's L2/L3 as the
  tree builds it, unablated (so that a tree whose fdot level runs another
  route can be timed at the same shapes).
- ``f32``: the float32 chain kernels (mrf_chain_f32.cuh: tc_f32_kernel
  and phase_f32_kernel, 3xTF32 on the tensor cores; fused_resblock1 in
  float32 at chip_smoke.py's resblock1 shapes, fused_mrf_tc in float32 at
  V1's L0 and fused_mrf_phase in float32 at the fast-f32 path's L2/L3),
  ablated by MRF_ABL_NOW (no weight copies), MRF_ABL_NOMMA (no A fragment
  loads and no mma.sync: the epilogues see zero sums) and the two
  together.
- ``f32_phase``: fused_mrf_phase in float32 at the fast-f32 path's L2/L3
  as the tree builds it, unablated (so that a tree whose float32 level
  runs another route can be timed at the same shapes).
- ``static``: the block-resident int8-static kernels (mrf_tc_q8.cu,
  mrf_ptc.cu, mrf_phase_q8.cu: fused_mrf_tc_q8, fused_mrf_ptc static and
  fused_mrf_phase_q8 q8s at the batch-1 entry point's L2/L3 for one
  1024-frame utterance, all on mrf_chain_q8.cuh), ablated by
  MRF_ABL_NOW (no weight copies: the convs read whatever the ring holds),
  MRF_ABL_NOMMA (no ldmatrix/wgmma: the epilogues see zero sums),
  MRF_ABL_NOEPI (no conv epilogues), MRF_ABL_NOSYNC (no __syncthreads per
  weight stage; only beside the first two).
- ``q8s_phase``: fused_mrf_phase_q8 q8s at those shapes as the tree builds
  it, unablated.
- ``dyn_blk``: the segment-synchronised int8-dynamic engine
  (mrf_dyn_blk.cuh: fused_mrf_ct_q8 at C = 256/128, fused_mrf_phase_q8
  dynamic at C = 64/32, fused_mrf_ptc dyn at V1's L2/L3), ablated by MRF_ABL_NOW, MRF_ABL_NOMMA,
  MRF_ABL_NOEPI and MRF_ABL_NOBAR (no segment barrier: every block reads
  the scale word without waiting).
- ``v2_int8``: HiFi-GAN V2's int8 levels at a B=8 x 1024-frame call's
  shapes (L0 (8, 8192, 64) through fused_mrf_ct, L1 (8, 65536, 32) through
  fused_mrf_phase without prologue, p = 4) in each mode: the dynamic
  engine (mrf_dyn_blk.cuh, one launch a level) and ptc_fused_q8_kernel
  without prologue (q8f, q8s), ablated as ``dyn_blk``.

``--ptxas`` builds each section's unablated sources with ``-Xptxas -v``
and prints each kernel's registers, spills and ptxas's wgmma
serialisation warnings (C75xx).

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
# the fast-f32 path's narrow levels (float32 fused_mrf_phase)
F32_PHASE_SHAPES = (('fused_mrf_phase', (8, 128, 65536, 'float32')),
                    ('fused_mrf_phase', (8, 64, 131072, 'float32')))
# chip_smoke.py's bf16-ptc path (fdot)
FDOT_SHAPES = (('fused_mrf_ptc_f', (8, 128, 65536, 'fdot')),
               ('fused_mrf_ptc_f', (8, 64, 131072, 'fdot')))
# chip_smoke.py's entry-int8-unfused path: L2/L3 of a 1024-frame utterance
Q8S_PHASE_SHAPES = (('fused_mrf_phase_q8', (1, 65536, 128, 'q8s')),
                    ('fused_mrf_phase_q8', (1, 131072, 64, 'q8s')))


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
        shapes=BF16_SHAPES + FDOT_SHAPES),
    'fdot': dict(
        sources=('mrf_phase',), band=1e-2,
        builds={'kernel': []},
        shapes=FDOT_SHAPES),
    'f32': dict(
        sources=('mrf_tc', 'mrf_phase'), band=1e-5,
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_weights_no_mma': SKELETON,
        },
        shapes=F32_SHAPES + F32_PHASE_SHAPES),
    'f32_phase': dict(
        sources=('mrf_phase',), band=1e-5,
        builds={'kernel': []},
        shapes=F32_PHASE_SHAPES),
    'static': dict(
        sources=('mrf_tc_q8', 'mrf_ptc', 'mrf_phase_q8'),
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
                ('fused_mrf_ptc', (8, 131072, 64, 'q8f'))) + Q8S_PHASE_SHAPES),
    'q8s_phase': dict(
        sources=('mrf_phase_q8',),
        builds={'kernel': []},
        shapes=Q8S_PHASE_SHAPES),
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
                ('fused_mrf_phase_q8', (8, 131072, 64, 'dynamic')),
                ('fused_mrf_ptc', (8, 65536, 128, 'dynamic')),
                ('fused_mrf_ptc', (8, 131072, 64, 'dynamic')))),
    'v2_int8': dict(
        sources=('mrf_ct_q8', 'mrf_phase_q8'),
        builds={
            'kernel': [],
            'no_weights': ['-DMRF_ABL_NOW'],
            'no_mma': ['-DMRF_ABL_NOMMA'],
            'no_epilogue': ['-DMRF_ABL_NOEPI'],
            'no_barrier': ['-DMRF_ABL_NOBAR'],
            'skeleton': ENGINE_SKELETON,
        },
        shapes=(('fused_mrf_ct_q8', (8, 8192, 64)),
                ('fused_mrf_phase_q8_noups', (8, 65536, 32, 'dynamic')),
                ('fused_mrf_ct_q8f', (8, 8192, 64)),
                ('fused_mrf_phase_q8_noups', (8, 65536, 32, 'q8f')),
                ('fused_mrf_ct_q8s', (8, 8192, 64)),
                ('fused_mrf_phase_q8_noups', (8, 65536, 32, 'q8s')))),
}


def build(_build, out_dir, sections, ptxas=False):
    """Every build of every section's sources, one nvcc each, all at once;
    with ``ptxas``, the unablated builds report their registers."""
    os.makedirs(out_dir, exist_ok=True)
    procs, by_flags, libs = [], {}, {}
    for sec in sections:
        for v, flags in SECTIONS[sec]['builds'].items():
            for src in SECTIONS[sec]['sources']:
                out = by_flags.get((src, tuple(flags)))
                if out is None:
                    out = os.path.join(out_dir, f'lib{src}-{sec}-{v}.so')
                    by_flags[src, tuple(flags)] = out
                    verbose = ['-Xptxas', '-v'] if ptxas and not flags else []
                    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                           *verbose, '-o', out, str(_build.CSRC / f'{src}.cu')]
                    procs.append((v, src, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
                libs[sec, src, v] = out
    for v, src, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc {src} [{v}] failed:\n{log}')
        if ptxas and v == 'kernel':
            print_ptxas(src, log)
    return libs


def print_ptxas(src, log):
    """Each kernel's registers and spills, and the C75xx warnings, from
    an ``-Xptxas -v`` build log."""
    fn = None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            fn = line.split("'")[1]
        elif 'registers' in line or 'spill' in line or 'C75' in line:
            print(f'ptxas {src} {fn}: {line.strip()}', flush=True)


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
    libs = build(_build, os.path.join(ROOT, 'build', 'ablation'), sections,
                 ptxas='--ptxas' in sys.argv)
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
                'fused_mrf_phase_q8': mi.fused_mrf_phase_q8,
                'fused_mrf_ct_q8f': mi.fused_mrf_ct_q8f,
                'fused_mrf_ct_q8s': mi.fused_mrf_ct_q8s,
                'fused_mrf_phase_q8_noups': mi.fused_mrf_phase_q8_noups}
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
                        post = name in ('fused_mrf_phase_q8',
                                        'fused_mrf_ptc') and key[2] == 64
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

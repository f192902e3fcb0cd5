#!/usr/bin/env python3
"""Where the time of the port's block-resident int8 MRF kernels goes
(daft_exprt_torch/ops/csrc/mrf_tc_q8.cu and mrf_ptc.cu), on one CUDA card.

    python3 scripts/torch_mrf_q8_ablation.py [--iters N]

Builds the two sources as they are and with ablations that remove a part
of the work (the results are then wrong and not checked):
MRF_ABL_NOW (no weight copies: the convs read whatever the ring holds),
MRF_ABL_NOMMA (no ldmatrix/wgmma: the epilogues see zero sums),
MRF_ABL_NOEPI (no conv epilogues), MRF_ABL_NOSYNC (no __syncthreads per
weight stage; only beside the first two, where nothing is shared between
the warps). Runs fused_mrf_tc_q8 and fused_mrf_ptc (static) at the V1
int8-static shapes of a B=8 x 1024-frame call (chip_smoke.py's
KernelCases, seeded unit-gain weights); the unablated build must match the
plain version (bit for bit; the conv_post waveform within one bf16 ulp).
Prints the card (nvidia-smi name and power limit), then per build and
shape the median of CUDA-event timings, and one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SKELETON = ['-DMRF_ABL_NOW', '-DMRF_ABL_NOMMA']
BUILDS = {
    'kernel': [],
    'no_weights': ['-DMRF_ABL_NOW'],
    'no_mma': ['-DMRF_ABL_NOMMA'],
    'no_weights_no_mma': SKELETON,
    'skeleton_no_epilogue': SKELETON + ['-DMRF_ABL_NOEPI'],
    'skeleton_no_stage_sync': SKELETON + ['-DMRF_ABL_NOSYNC'],
}
ABLATIONS = tuple(v for v in BUILDS if v != 'kernel')
SHAPES = (('fused_mrf_tc_q8', (8, 8192, 256)), ('fused_mrf_tc_q8', (8, 65536, 128)),
          ('fused_mrf_ptc', (8, 65536, 128, 'q8f')),
          ('fused_mrf_ptc', (8, 131072, 64, 'q8f')))


def build(_build, out_dir):
    """Every build of both sources, one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for v, flags in BUILDS.items():
        for src in ('mrf_tc_q8', 'mrf_ptc'):
            out = os.path.join(out_dir, f'lib{src}-{v}.so')
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, '-o', out,
                   str(_build.CSRC / f'{src}.cu')]
            procs.append((v, src, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, src, out, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc {src} [{v}] failed:\n{log}')
        libs[v, src] = out
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_mrf_q8_ablation: no CUDA device', file=sys.stderr)
        sys.exit(2)
    iters = int(sys.argv[sys.argv.index('--iters') + 1]) if '--iters' in sys.argv else 10
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
    libs = build(_build, os.path.join(ROOT, 'build', 'ablation'))
    print(f'build: {time.perf_counter() - t0:.1f} s', flush=True)
    ks = tuple(DEFAULT_CONFIG['resblock_kernel_sizes'])
    dils = tuple(tuple(d) for d in DEFAULT_CONFIG['resblock_dilation_sizes'])
    dev = torch.device('cuda')
    wrappers = {'fused_mrf_tc_q8': vk.fused_mrf_tc_q8, 'fused_mrf_ptc': mi.fused_mrf_ptc}
    results, ref = {}, {}
    for v in BUILDS:
        _build._libs['mrf_tc_q8'] = ctypes.CDLL(libs[v, 'mrf_tc_q8'])
        _build._libs['mrf_ptc'] = ctypes.CDLL(libs[v, 'mrf_ptc'])
        cases = cs.KernelCases(torch, F, vk, mi, mc, None, dev, ks, dils)
        for name, key in SHAPES:
            c = cases.case(name, key)
            n0 = wrappers[name].launches
            out = c['fn']()
            torch.cuda.synchronize()
            launches = wrappers[name].launches - n0
            if v not in ABLATIONS:
                if (name, key) not in ref:
                    ref[name, key] = c['plain']()
                err = cs.max_abs(out.float(), ref[name, key].float())
                assert err <= (4e-3 if key[2] == 64 else 0.0), (v, name, key, err)
            else:
                err = None
            ms = cs.time_ms(torch, c['fn'], warmup=2, iters=iters)
            results.setdefault(v, []).append(dict(kernel=name, shape=c['desc'], ms=ms,
                                                  launches=launches, max_abs=err))
            print(f'{v:18s} {name} {c["desc"]}: {ms:.4f} ms, {launches} launches, '
                  f'max_abs vs plain {err}', flush=True)
            del out, c
        torch.cuda.empty_cache()
    print(json.dumps({'builds': results, 'flags': BUILDS,
                      'device': torch.cuda.get_device_name(0)}))


if __name__ == '__main__':
    main()

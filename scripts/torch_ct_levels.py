#!/usr/bin/env python3
"""Times the float MRF kernels of HiFi-GAN V2's levels on one CUDA card.

    python3 scripts/torch_ct_levels.py [--ablate] [--iters N] [--label L]

fused_mrf_ct at L0 and fused_mrf_phase_noups at L1-L3 (ops/mrf_ct.py) at
the shapes of a B=8 x 1024-frame synthesis call ((8, 8192, 64), (8, 65536,
32), (8, 131072, 16), (8, 262144, 8)), in bf16 and float32, with seeded
unit-gain weights: each call against its plain version (rel-L2 <= 1e-2 in
bf16, <= 1e-5 in float32, TF32 off), its launches per call and the median
of CUDA-event timings. It uses only names every tree of the port has, so
that a parent checkout can be timed with the same script (copy it there).

``--ablate`` times builds of mrf_ct.cu with parts of the work removed
(results wrong, not checked; the flags of scripts/torch_mrf_ablation.py):
``no_weights`` (MRF_ABL_NOW: no weight copies), ``no_mma``
(MRF_ABL_NOMMA: no MMAs), ``no_epilogue`` (MRF_ABL_NOEPI: no bf16 conv
epilogues) and ``skeleton`` (all three: the loads, barriers and launch).

For the bf16 level kernel it also prints, per level, two least times
beside the operations bound (252*B*T*C^2 FLOPs at 989 TFLOP/s): the
bytes its ``wgmma`` read from shared memory (per active warpgroup, conv
pass and weight stage of the plan: a 64 x 16 bf16 A tile, 2 KB, and a C x
16 B tile) at 128 bytes a clock per SM over 132 SMs at the card's
maximum SM clock (nvidia-smi ``clocks.max.sm``).

Prints the card (nvidia-smi name and power limit), a line per variant and
shape, and one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 8, 1024
LEVELS = (('fused_mrf_ct', 64, T * 8), ('fused_mrf_phase_noups', 32, T * 64),
          ('fused_mrf_phase_noups', 16, T * 128),
          ('fused_mrf_phase_noups', 8, T * 256))
SEED = 1234


def median_ms(torch, fn, iters, warmup=2):
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


def smem_mma_bytes(vk, C, ks, dils, B, n, bm):
    """Bytes the bf16 level kernel's wgmma read from shared memory in one
    call at block_m ``bm``: every active warpgroup (64 rows) of every conv
    pass issues the conv's stages' MMAs, each reading a 64 x 16 bf16 A
    tile and a C x 16 bf16 B tile."""
    cfg = vk.CT_BF_CFG[C]
    pair = C == 8
    kc, ksteps = (1, 1) if pair else (C // cfg.kch, cfg.kch // 16)
    mmas = 0
    for k, d, w in vk._ct_windows(ks, dils, bm):
        vt = (k + 1) // 2 if pair else k
        per_group = -(-vt // cfg.tps) * kc * cfg.tps * ksteps
        mmas += sum(-(-M // 64) for M in vk._chain_convs(k, d, w)) * per_group
    return B * -(-n // bm) * mmas * (64 * 16 * 2 + C * 16 * 2)


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_ct_levels: no CUDA device; nothing was run',
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from daft_exprt_torch.ops import _build
    from daft_exprt_torch.ops import mrf_ct as mc
    from daft_exprt_torch.ops import vocoder_kernels as vk
    iters = int(sys.argv[sys.argv.index('--iters') + 1]) \
        if '--iters' in sys.argv else 20
    label = sys.argv[sys.argv.index('--label') + 1] \
        if '--label' in sys.argv else 'tree'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    clk_mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,'
         'nounits'], capture_output=True, text=True, check=True
    ).stdout.split()[0])
    dev = torch.device('cuda')
    ks, dils = (3, 7, 11), ((1, 3, 5),) * 3
    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for name, C, n in LEVELS:
        rb = {}
        for j, k in enumerate(ks):
            rb[f'resblock_0_{j}'] = {
                f'{pre}_{i}': {'w': (C * k) ** -0.5 * torch.randn(
                    (C, C, k), generator=gen), 'b': 0.05 * torch.randn(
                        C, generator=gen)}
                for pre in ('convs1', 'convs2') for i in range(3)}
        w = vk.pack_mrf_tc_weights(rb, 0, ks, dils)
        x = torch.randn((B, n, C), generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            wd = [t.to(dev, dt) for t in w]
            cases.append((name, C, n, dt, x.to(dev, dt),
                          vk.prepare_mrf(wd, ks, dils)))

    variants = [('as_built', None, None)]
    if '--ablate' in sys.argv:
        out_dir = os.path.join(ROOT, 'build', 'ct_variants')
        os.makedirs(out_dir, exist_ok=True)
        for var, flags in (('no_weights', ['-DMRF_ABL_NOW']),
                           ('no_mma', ['-DMRF_ABL_NOMMA']),
                           ('no_epilogue', ['-DMRF_ABL_NOEPI']),
                           ('skeleton', ['-DMRF_ABL_NOW', '-DMRF_ABL_NOMMA',
                                         '-DMRF_ABL_NOEPI'])):
            lib = os.path.join(out_dir, f'libmrf_ct_{var}.so')
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                            '-o', lib, str(_build.CSRC / 'mrf_ct.cu')],
                           check=True)
            variants.append((var, lib, 'ablated'))
    as_built = _build.library('mrf_ct')
    engine = hasattr(vk, 'ct_block')      # the one-launch level kernels
    results = []
    for var, lib, block in variants:
        _build._libs['mrf_ct'] = ctypes.CDLL(lib) if lib else as_built
        for name, C, n, dt, x, mrf in cases:
            fn = getattr(mc, name)
            n0 = fn.launches
            with vk.full_f32():
                out = fn(x, mrf)
                ref = mc.mrf_ct_plain(x, mrf)
            per_call = fn.launches - n0
            torch.cuda.synchronize()
            a, b = out.double(), ref.double()
            r = float((a - b).norm() / (b.norm() + 1e-30))
            band = 1e-5 if dt == torch.float32 else 1e-2
            assert block == 'ablated' or (
                torch.isfinite(out.float()).all() and r <= band), \
                (var, name, C, r)
            with vk.full_f32():
                ms = median_ms(torch, lambda: fn(x, mrf), iters)
            bm = vk._ct_plan(x, mrf, lambda s, d: None,
                             vk.sm_count(dev)).block_m if engine else None
            row = dict(label=label, variant=var, name=name,
                       shape=[B, n, C], dtype=str(dt)[6:], ms=ms,
                       launches_per_call=per_call, rel_l2=r, block_m=bm)
            results.append(row)
            print(f'{label} {var} {name} ({B},{n},{C}) {row["dtype"]}: '
                  f'ms={ms:.4f} launches={per_call} block_m={bm} '
                  f'rel_l2={r:.3e} (band {band:g})', flush=True)
            del out, ref
    bounds = []
    if engine:
        for name, C, n in LEVELS:
            bm = vk.ct_block(C, False, ks, dils, B, n, vk.sm_count(dev))
            nbytes = smem_mma_bytes(vk, C, ks, dils, B, n, bm)
            smem_ms = nbytes / (128 * vk.sm_count(dev) * clk_mhz * 1e6) * 1e3
            ops_ms = 252 * B * n * C * C / 989e12 * 1e3
            bounds.append(dict(name=name, shape=[B, n, C], block_m=bm,
                               smem_mma_bytes=nbytes, smem_bound_ms=smem_ms,
                               ops_bound_ms=ops_ms, sm_clock_mhz=clk_mhz))
            print(f'bound {name} ({B},{n},{C}) bf16 block_m={bm}: shared '
                  f'memory {nbytes / 1e9:.3f} GB read by wgmma, '
                  f'{smem_ms:.4f} ms at {clk_mhz:.0f} MHz; operations '
                  f'{ops_ms:.4f} ms', flush=True)
    print(json.dumps({'card': smi.splitlines()[0], 'levels': results,
                      'bf16_bounds': bounds}))


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Readings for setting a cell's limits: for each seed, one short window
of the program with its compared numbers, and the control's numbers on
the same checked batches (the reference one precision below the
configuration's, or the program's own lower tier), in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control 1] [--faults 1] [--out cal.jsonl]

``--faults 1`` adds, for the fine-tuning cells, the readings of faults
planted in the reference put in the program's place.

Not run by the benchmark's own runs. Prints one JSON line per seed.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--control', type=int, default=1)
    ap.add_argument('--faults', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import harness
    import torch

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell['config'])
    mix = bench.traffic(cell['traffic'])
    kind = bench.kind(mix['kind'])
    harness.cache_dirs(ROOT)
    out = open(args.out, 'a') if args.out else None
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        ctx = dict(root=ROOT, bench=bench, cell=cell, config=cfg,
                   traffic=mix, seed=seed, device=args.device,
                   log=harness.log, generator=bench.generator(mix['generator']),
                   module=harness.module)
        state = kind.setup(ctx)
        record = kind.window(state, args.seconds)
        ctrl = kind.control(state) if args.control else []
        kind.release(state)
        checks = kind.check(state)
        planted = kind.faults(state) if args.faults else {}
        extra = kind.details(state) if hasattr(kind, 'details') else None
        line = {'workload': args.workload, 'seed': seed,
                'program': {n: v for n, v, _ in checks},
                'limits': {n: lim for n, _, lim in checks},
                'control': dict(ctrl), 'attempted': record['attempted'],
                'faults': {k: dict(v) for k, v in planted.items()},
                'detail': extra,
                'seconds': time.perf_counter() - t0,
                'device': torch.cuda.get_device_name(0)
                if args.device == 'cuda' else 'cpu'}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + '\n')
            out.flush()
        del state
        if args.device == 'cuda':
            torch.cuda.empty_cache()
    if harness.forbidden_loaded():
        print('forbidden modules loaded:', harness.forbidden_loaded(),
              file=sys.stderr)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())

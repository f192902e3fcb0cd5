#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA cards of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the device's busy time and a breakdown. Every run
checks the outputs of its window against the plain float32 reference
under ``portbench/reference`` and prints each number compared beside its
limit, last on standard error and last in the result line. It exits
non-zero, printing no result, without enough CUDA cards, or if JAX or the
JAX package is loaded in this process once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import harness
    import torch

    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload).get('chips', 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f'needs {chips} CUDA card(s); found '
                    f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              args.trace, device='cuda', t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        harness.log(f'modules of JAX or the JAX package were loaded: {bad}')
        return 3
    for name, c in result['checks'].items():
        harness.log(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})'
                    f'{"" if c["value"] <= c["limit"] else "  FAILED"}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""The benchmark's core: finds a cell's parts by name and runs it once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``BENCHMARK.json`` ``configs[].file``: the configuration's JSON;
- ``portbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the driver ``portbench/kinds/<kind>.py`` and its ``generator`` the
  input generator ``portbench/gen/<generator>.py``;
- ``portbench/metrics/<metric>.py``: one reader per metric, end-to-end or
  per-layer, ``read(record) -> float | None``; where that file is
  missing, ``portbench/metrics/<stem>.py``, ``<stem>`` being the name up
  to its first dot, reads every metric of that stem (``mfu.synth`` and
  ``mfu.gan``: one quantity, split by the end-to-end metric it moves).

A driver module has ``setup(ctx) -> state`` (``ctx['module']`` loads the
benchmark's own helpers), ``window(state, seconds) ->
record``, ``trace(state, record)`` (fills ``record['trace']`` from a
profiled stretch), ``release(state)`` (frees the program's state, keeps
the sample) and ``check(state) -> [(name, value, limit), ...]``.
"""
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'daft_exprt_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import a file of the benchmark by its path (names may hold dots),
    once per path."""
    path = Path(path).resolve()
    name = 'portbench_' + ''.join(c if c.isalnum() else '_'
                                  for c in path.as_posix())
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def module(name):
    """The benchmark's own ``portbench/<name>.py`` (``weights``,
    ``tracing``, ``steps``, ``counts/...``, ``reference/...``)."""
    return load_module(HERE / f'{name}.py')


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = load_json(self.root / 'BENCHMARK.json')
        self.pkg = self.root / 'portbench'

    def cell(self, name):
        for w in self.spec['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, name):
        for c in self.spec['configs']:
            if c['name'] == name:
                cfg = load_json(self.root / c['file'])
                cfg['name'] = name
                return cfg
        raise KeyError(f'no config {name!r} in BENCHMARK.json')

    def traffic(self, name):
        mix = load_json(self.pkg / 'traffic' / f'{name}.json')
        mix['name'] = name
        return mix

    def kind(self, name):
        return load_module(self.pkg / 'kinds' / f'{name}.py')

    def generator(self, name):
        return load_module(self.pkg / 'gen' / f'{name}.py')

    def metrics(self, cell, section):
        """The cell's metrics of ``section`` ('end_to_end' or 'per_layer'):
        those that list it, or list no cells."""
        return [m for m in self.spec[section]
                if cell in m.get('workloads', [cell])]

    def reader(self, metric):
        own = self.pkg / 'metrics' / f'{metric}.py'
        if not own.exists():
            own = self.pkg / 'metrics' / f'{metric.split(".", 1)[0]}.py'
        return load_module(own)


def forbidden_loaded():
    """Top-level module names of JAX or the JAX package in this process,
    compared whole (the port's name starts with the JAX package's)."""
    tops = {m.split('.', 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dirs(root):
    """Fixed build and kernel cache directories inside the checkout."""
    base = Path(root) / 'build' / 'portbench-cache'
    os.environ['TRITON_CACHE_DIR'] = str(base / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(base / 'torch_extensions')
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('USE_JAX', '0')


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def quarters(record):
    """The window's rate in each of its four quarters: the work of each
    batch or iteration (``marks``: start, end, amount) shared over the
    quarters by how much of its span lies in each, over the quarter's
    length. How far they part within one run, against how far runs part,
    says what a longer window would buy."""
    q = record['window_s'] / 4
    done = [0.0] * 4
    for s, e, amount in record['marks']:
        s, e = s - record['begin'], e - record['begin']
        for i in range(4):
            part = min(e, (i + 1) * q) - max(s, i * q)
            if part > 0:
                done[i] += amount * part / max(e - s, 1e-12)
    return [d / q for d in done]


def run_cell(root, workload, seed, seconds, trace, device='cuda',
             t_start=None):
    """One run of one cell. Returns the result dict (the last line)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell['config'])
    mix = bench.traffic(cell['traffic'])
    kind = bench.kind(mix['kind'])
    cache_dirs(root)
    ctx = dict(root=Path(root), bench=bench, cell=cell, config=cfg,
               traffic=mix, seed=int(seed), device=device, log=log,
               generator=bench.generator(mix['generator']), module=module)
    state = kind.setup(ctx)
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    record = kind.window(state, float(seconds))
    record['setup_s'] = setup_s
    if cuda:
        torch.cuda.synchronize()
        record['window_peak_bytes'] = torch.cuda.max_memory_allocated()
        record['memory_peak_bytes'] = max(setup_peak,
                                          record['window_peak_bytes'])
    if trace:
        kind.trace(state, record)
    kind.release(state)
    checks = kind.check(state)
    correct = bool(checks) and all(
        isinstance(v, float) and math.isfinite(v) and v <= lim
        for _, v, lim in checks)
    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in bench.metrics(workload, section):
        value = bench.reader(m['name']).read(record)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': int(cell.get('chips', 1)),
           'memory_peak_bytes': int(record.get('memory_peak_bytes', 0))}
    result = {'correct': correct, 'attempted': int(record['attempted']),
              'failed': int(record['failed']), 'metrics': metrics,
              'device': dev}
    if trace and record.get('trace'):
        tr = record['trace']
        dev['busy_s'] = tr['busy_s']
        dev['window_s'] = tr['window_s']
        result['breakdown'] = {'device_ops': tr['device_ops'],
                               'idle_gaps': tr['idle_gaps']}
    if record.get('marks'):
        result['quarters'] = quarters(record)
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    return result

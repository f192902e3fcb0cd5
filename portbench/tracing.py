"""A profiled stretch of a window, read from the profiler's Chrome trace.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA) and
returns what the metric readers use: every device activity (kernels,
copies, sets) as (name, start, end, category) in seconds, the device-side
spans of the ``record_function`` ranges (the benchmark's and the
program's) and the device time inside each (``range_s``; kernels alone:
``range_kernel_s``), the host-side spans, the stretch's wall length, the
union of device time, the device operations that took most time and the
longest idle gaps, named by what the host was doing.
"""
import collections
import json
import os
import tempfile
import time

import numpy as np

MAX_GAPS = 500      # the longest idle gaps that are named
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


def union(intervals):
    """Merged, sorted intervals of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(intervals):
    return sum(e - s for s, e in union(intervals))


def clip(intervals, spans):
    """The parts of ``intervals`` inside any of ``spans`` (both lists)."""
    spans = union(spans)
    out = []
    for s, e in intervals:
        for a, b in spans:
            lo, hi = max(s, a), min(e, b)
            if lo < hi:
                out.append((lo, hi))
    return out


def _top(pairs, n=10):
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def profiled(fn, sync, host=True):
    """Run ``fn()`` (then ``sync()``) under the profiler; returns the
    stretch's trace summary and fn's result. ``host=False`` records the
    device's activities alone, which leaves the host's pace nearly as it
    is untraced: the busy and idle shares come from such a stretch, the
    ranges and what the host was doing in each gap from a full one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    acts = acts or [ProfilerActivity.CPU]       # no card: the host alone
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    finally:
        os.remove(path)
    return summarize(events, wall), out


def summarize(events, wall):
    dev, dev_ranges, host, host_ranges = [], collections.defaultdict(list), \
        [], collections.defaultdict(list)
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        cat = ev.get('cat', '')
        s = float(ev['ts']) * 1e-6
        e = s + float(ev['dur']) * 1e-6
        name = ev.get('name', '')
        if cat in DEVICE_CATS:
            dev.append((name, s, e, cat))
        elif cat == 'gpu_user_annotation':
            dev_ranges[name].append((s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e, cat))
            if cat == 'user_annotation':
                host_ranges[name].append((s, e))
    if dev:
        lo = min(d[1] for d in dev)
        hi = max(d[2] for d in dev)
    else:
        lo = hi = 0.0
    busy = union([(d[1], d[2]) for d in dev])
    ops = collections.Counter()
    for name, s, e, _ in dev:
        ops[name[:120]] += e - s
    gaps = collections.Counter()
    hs = np.array([h[1] for h in host])
    he = np.array([h[2] for h in host])
    is_ann = np.array([h[3] == 'user_annotation' for h in host], dtype=bool)
    holes = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                   reverse=True)
    for dur, a, b in holes[:MAX_GAPS]:
        mid = (a + b) / 2
        around = (hs <= mid) & (he >= mid) if len(host) else np.zeros(0, bool)
        what = []
        for sel in (around & is_ann, around & ~is_ann):
            idx = np.nonzero(sel)[0]
            if len(idx):
                what.append(host[idx[np.argmin(he[idx] - hs[idx])]][0])
        gaps[' / '.join(what) or 'no host event'] += dur
    out = {'window_s': wall, 'busy_s': sum(e - s for s, e in busy),
           'device': dev, 'device_span_s': hi - lo,
           'dev_ranges': dict(dev_ranges), 'host_ranges': dict(host_ranges),
           'device_ops': _top(ops), 'idle_gaps': _top(gaps)}
    out['range_s'] = {n: device_time_in(out, n) for n in dev_ranges}
    out['range_kernel_s'] = {n: device_time_in(out, n, ('kernel',))
                             for n in dev_ranges}
    return out


def device_time_in(trace, range_name, cats=DEVICE_CATS):
    """Device time (union of the activities of categories ``cats``) inside
    the device-side spans of the ``record_function`` range ``range_name``;
    None without the range."""
    spans = trace['dev_ranges'].get(range_name)
    if not spans:
        return None
    return length(clip([(d[1], d[2]) for d in trace['device']
                        if d[3] in cats], spans))


def two_stretches(lean_fn, full_fn, sync):
    """A device-only stretch for the busy time, the idle share and the
    device operations, then a full one for the ranges and the gaps'
    names; one summary."""
    lean, _ = profiled(lean_fn, sync, host=False)
    full, _ = profiled(full_fn, sync, host=True)
    full.update(window_s=lean['window_s'], busy_s=lean['busy_s'],
                device_ops=lean['device_ops'],
                full_window_s=full['window_s'], full_busy_s=full['busy_s'])
    return full

"""The reading of a profiler trace: busy time as the union of device
activity, device time inside a range's device-side span, and idle gaps
named by what the host was doing."""
import pytest

from tinybench import REPO, harness


def _ev(cat, name, ts, dur, corr=None):
    ev = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    if corr is not None:
        ev['args'] = {'correlation': corr}
    return ev


def test_summarize_synthetic_trace():
    tracing = harness(REPO).module('tracing')
    us = 1e-6
    events = [
        _ev('user_annotation', 'backward', 0, 100),       # host range
        _ev('cuda_runtime', 'cudaLaunchKernel', 10, 2, corr=1),
        _ev('cuda_runtime', 'cudaLaunchKernel', 150, 2, corr=2),
        _ev('kernel', 'k1', 20, 30, corr=1),               # launched inside
        _ev('kernel', 'k2', 40, 20, corr=9),               # overlaps k1
        _ev('gpu_memcpy', 'copy', 160, 10, corr=2),        # launched after
        _ev('gpu_user_annotation', 'backward', 15, 50),
        _ev('cpu_op', 'aten::mm', 60, 80),                 # host in the gap
    ]
    tr = tracing.summarize(events, wall=200 * us)
    assert tr['busy_s'] == pytest.approx(50 * us)          # [20, 60] + [160, 170]
    assert tr['range_s']['backward'] == pytest.approx(40 * us)
    assert tr['range_kernel_s']['backward'] == pytest.approx(40 * us)
    assert tr['idle_gaps'] == [['aten::mm', pytest.approx(100 * us)]]
    assert [n for n, _ in tr['device_ops']] == ['k1', 'k2', 'copy']


def test_union_and_clip():
    tracing = harness(REPO).module('tracing')
    assert tracing.union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
    assert tracing.length([(0, 1), (0.5, 2), (5, 6)]) == 3
    assert tracing.clip([(0, 10)], [(2, 3), (5, 7)]) == [(2, 3), (5, 7)]

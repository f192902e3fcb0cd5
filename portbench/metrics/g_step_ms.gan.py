"""Device time (union of kernels, copies and sets) inside the benchmark's
``g_step`` profiler range, per iteration of the traced stretch."""


def read(record):
    tr = record.get('trace')
    if record.get('kind') != 'gan' or not tr:
        return None
    t = tr['range_s'].get('g_step')
    return None if t is None else 1e3 * t / tr['iterations']

"""The comparison of a training cell's first steps with its reference.

Readings (program or reference): ``losses``, a list per step of its
losses; ``grads`` and ``change``, {leaf: norm} of every leaf's first
gradient as its optimiser got it and of its change over the steps. Leaf
names start with their model's prefix ('G/', 'D/', 'A/'), and each
model's leaves are judged against its own median leaf.
"""
import numpy as np


def _groups(names):
    out = {}
    for n in names:
        out.setdefault(n.split('/', 1)[0], []).append(n)
    return out


def compare(prog, ref, skip_rule=1e-3):
    """The numbers a training cell can compare, by name:

    - ``loss_rel``: the worst step's relative loss gap;
    - ``loss_rel_step1``: the same over the first step's losses alone;
    - ``grad_gap``: the worst leaf's gap of first-gradient norms, against
      the reference's norm of that leaf or of its model's median leaf,
      whichever is larger;
    - ``grad_median.<model>``: that gap of the model's median leaf;
    - ``change_gap``: the worst leaf's gap of change norms, the same way,
      leaving out leaves whose reference gradient is under ``skip_rule``
      of the median leaf's (their moves under Adam are round-off).

    All NaN when the two hold different leaves."""
    names = ['loss_rel', 'loss_rel_step1', 'grad_gap', 'change_gap']
    groups = _groups(ref['grads'])
    names += [f'grad_median.{m}' for m in groups]
    if set(prog['grads']) != set(ref['grads']):
        return {n: float('nan') for n in names}
    gaps = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ps, rs)]
            for ps, rs in zip(prog['losses'], ref['losses'])]
    out = {'loss_rel': max(max(g) for g in gaps),
           'loss_rel_step1': max(gaps[0]), 'grad_gap': 0.0,
           'change_gap': 0.0}
    for model, leaves in groups.items():
        mg = float(np.median([ref['grads'][n] for n in leaves]))
        mc = float(np.median([ref['change'][n] for n in leaves]))
        gg = [abs(prog['grads'][n] - ref['grads'][n]) / max(ref['grads'][n],
                                                             mg)
              for n in leaves]
        out['grad_gap'] = max(out['grad_gap'], max(gg))
        out[f'grad_median.{model}'] = float(np.median(gg))
        for n in leaves:
            if ref['grads'][n] >= skip_rule * mg:
                rc = ref['change'][n]
                out['change_gap'] = max(out['change_gap'], abs(
                    prog['change'][n] - rc) / max(rc, mc))
    return out


def checks(readings, ref, limits):
    """[(name, value, limit)] for the numbers that ``limits`` names."""
    vals = compare(readings, ref)
    return [(n, float(vals[n]), float(lim)) for n, lim in limits.items()]


def detail(prog, ref, skip_rule=1e-3):
    """What lies behind :func:`compare`'s numbers, for setting limits: each
    step's loss gaps, each model's median-leaf gaps and worst leaves, and
    the leaves the change leaves out."""
    out = {'loss_rel_steps': [[abs(p - r) / max(abs(r), 1e-30)
                               for p, r in zip(ps, rs)]
                              for ps, rs in zip(prog['losses'],
                                                ref['losses'])]}
    for model, names in _groups(ref['grads']).items():
        mg = float(np.median([ref['grads'][n] for n in names]))
        mc = float(np.median([ref['change'][n] for n in names]))
        gg = {n: abs(prog['grads'][n] - ref['grads'][n])
              / max(ref['grads'][n], mg) for n in names}
        cg = {n: abs(prog['change'][n] - ref['change'][n])
              / max(ref['change'][n], mc) for n in names
              if ref['grads'][n] >= skip_rule * mg}
        wg, wc = max(gg, key=gg.get), max(cg, key=cg.get)
        out[model] = {
            'grad_gap_median': float(np.median(list(gg.values()))),
            'grad_worst': [wg, gg[wg], ref['grads'][wg], mg],
            'change_gap_median': float(np.median(list(cg.values()))),
            'change_worst': [wc, cg[wc], ref['change'][wc], mc],
            'skipped': sorted(set(names) - set(cg))}
    return out

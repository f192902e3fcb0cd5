"""The control fails where the program passes: for each cell, the
reference put in the program's place one precision below the
configuration's (or the program's own lower path) reads over at least
one of the cell's limits, while the program reads under all of them.
On the card, at the cells' widths with a smaller batch.

    python -m pytest --noconftest -m cuda portbench/tests -q
"""
import json

import pytest
import torch

from tinybench import REPO, harness

SEED = 2 ** 31 + 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def _cells():
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    return [w['name'] for w in bench['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', _cells())
def test_control_fails_where_the_program_passes(card, cell):
    h = harness(REPO)
    bench = h.Bench(REPO)
    w = bench.cell(cell)
    mix = dict(bench.traffic(w['traffic']))
    mix['batch'] = min(mix['batch'], 8 if mix['kind'] == 'synth' else 4)
    mix['check_batches'] = 1
    ctx = dict(root=REPO, bench=bench, cell=w, config=bench.config(w['config']),
               traffic=mix, seed=SEED, device='cuda', log=h.log,
               generator=bench.generator(mix['generator']), module=h.module)
    kind = bench.kind(mix['kind'])
    h.cache_dirs(REPO)
    state = kind.setup(ctx)
    kind.window(state, 1.0)
    ctrl = dict(kind.control(state))
    kind.release(state)
    checks = kind.check(state)
    assert all(v <= lim for _, v, lim in checks), checks
    assert any(ctrl[n] > lim for n, _, lim in checks), (ctrl, checks)


def _program_controls():
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cfgs = {c['name']: json.loads((REPO / c['file']).read_text())
            for c in bench['configs']}
    return [w['name'] for w in bench['workloads']
            if cfgs[w['config']].get('control', {}).get(
                'vocoder', '').startswith('program:')]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', _program_controls())
def test_program_lower_tier_comes_out_not_correct(card, cell):
    """The program's own lower vocoder tier (V2's int8-static) served in
    the cell's place, at the cell's batch, reads over a limit."""
    h = harness(REPO)
    bench = h.Bench(REPO)
    w = bench.cell(cell)
    cfg = bench.config(w['config'])
    cfg['serve'] = dict(cfg['serve'], vocoder_tier=cfg['control'][
        'vocoder'].split(':', 1)[1])
    mix = dict(bench.traffic(w['traffic']), check_batches=1)
    ctx = dict(root=REPO, bench=bench, cell=w, config=cfg, traffic=mix,
               seed=SEED, device='cuda', log=h.log,
               generator=bench.generator(mix['generator']), module=h.module)
    kind = bench.kind(mix['kind'])
    h.cache_dirs(REPO)
    state = kind.setup(ctx)
    kind.window(state, 1.0)
    kind.release(state)
    checks = kind.check(state)
    assert any(v > lim for _, v, lim in checks), checks

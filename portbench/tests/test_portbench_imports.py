"""Nothing a run executes loads JAX or the JAX package (compared by whole
top-level names), the reference imports nothing of the port, and the
command refuses to run without a CUDA card."""
import ast
import json
import subprocess
import sys

import torch

from tinybench import REPO, harness, tiny_root

PKG = REPO / 'portbench'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'daft_exprt_tpu'}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split('.')[0]


def test_no_benchmark_file_imports_jax():
    for f in PKG.rglob('*.py'):
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in (PKG / 'reference').glob('*.py'):
        mods = set(_imports(f))
        assert 'daft_exprt_torch' not in mods and not mods & FORBIDDEN, f


def test_whole_name_comparison(monkeypatch):
    h = harness(REPO)
    for name in list(sys.modules):
        if name.split('.')[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'daft_exprt_tpu_like', sys)
    monkeypatch.setitem(sys.modules, 'jaxtyping', sys)
    assert h.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, 'jaxlib.xla_client', sys)
    monkeypatch.setitem(sys.modules, 'daft_exprt_tpu.models', sys)
    assert h.forbidden_loaded() == ['daft_exprt_tpu', 'jaxlib']


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    code = (
        'import sys, json\n'
        f'sys.path[:0] = [{str(root)!r}, {str(root / "portbench")!r}]\n'
        'import harness\n'
        f'out = harness.run_cell({str(root)!r}, "tiny.synth", 7, 0.5, 1, '
        'device="cpu")\n'
        'b = harness.Bench(' + repr(str(root)) + ')\n'
        'for d in ("kinds", "metrics", "gen", "reference", "counts"):\n'
        '    for f in sorted((b.pkg / d).glob("*.py")):\n'
        '        harness.load_module(f)\n'
        'print(json.dumps([out["correct"], harness.forbidden_loaded()]))\n')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        return      # the refusal is for machines without a card
    res = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'v1.synth-int8.b128', '--seed', str(2 ** 31 + 3), '--seconds', '1',
         '--trace', '0'], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ''


def test_command_fails_without_the_port(tmp_path):
    import shutil
    shutil.copytree(PKG, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    cell = json.loads((REPO / 'BENCHMARK.json').read_text())['workloads'][0]
    res = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell['name'],
         '--seed', '11', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ''

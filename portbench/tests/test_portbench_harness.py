"""The harness finds a configuration, a traffic mix and a metric by name
from new files alone, and a whole run reports the cell's metrics and
its checks (CPU, tiny sizes)."""
import json

from tinybench import tiny_root, harness

SEED = 2 ** 31 + 1009


def _limits(root, cell):
    """The numbers the cell's configuration compares (its limits)."""
    cfg = json.loads((root / 'portbench' / 'configs' / f'{cell}.json')
                     .read_text())
    return cfg['gan']['limits']


def test_new_config_traffic_and_metric_from_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    (root / 'portbench' / 'metrics' / 'tiny_probe.py').write_text(
        '"""A probe metric: batches of the window."""\n\n\n'
        'def read(record):\n'
        '    return float(len(record.get("items", []))) or None\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append({
        'name': 'tiny_probe', 'unit': 'batches', 'better': 'higher',
        'source': 'host_clock', 'layer': 'model', 'moves': 'audio_s_per_s',
        'workloads': ['tiny.synth']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    h = harness(root)
    out = h.run_cell(root, 'tiny.synth', SEED, 1.0, 1, device='cpu')
    assert out['correct'] is True
    assert out['metrics']['tiny_probe']['value'] >= 1
    assert {'acoustic_ms.synth', 'vocoder_ms.synth', 'mfu.synth',
            'device_idle_pct.synth'} <= set(out['metrics'])
    assert list(out)[-1] == 'checks'
    cfg = json.loads((root / 'portbench' / 'configs' / 'tiny.synth.json')
                     .read_text())
    assert list(out['checks']) == list(cfg['limits'])
    out = h.run_cell(root, 'tiny.synth', SEED, 1.0, 0, device='cpu')
    assert set(out['metrics']) == {
        m['name'] for m in bench['end_to_end']
        if 'tiny.synth' in m.get('workloads', ['tiny.synth'])}
    assert {'audio_s_per_s', 'setup_s'} <= set(out['metrics'])
    assert out['attempted'] >= 4 and out['failed'] == 0


def test_gan_cell_runs_and_checks(tmp_path):
    root = tiny_root(tmp_path)
    h = harness(root)
    out = h.run_cell(root, 'tiny.gan', SEED, 1.0, 0, device='cpu')
    assert out['correct'] is True, out['checks']
    assert set(out['metrics']) == {'gan_audio_s_per_s', 'setup_s'}
    assert set(out['checks']) == set(_limits(root, 'tiny.gan'))


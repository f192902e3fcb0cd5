"""A copy of the benchmark at CPU-test size: ``tiny_root(tmp)`` copies
``portbench/`` and ``BENCHMARK.json`` into ``tmp``, links the port beside
them, and adds the cells ``tiny.synth`` (V2 vocoder at the bf16 tier, B
= 4 x 32-64 frames) and ``tiny.gan`` (a 64-channel generator, B = 2 x
2048 samples), each listed under every metric of its full-size cells. The
configurations keep the full-size files' limits."""
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# tiny cell: (configuration, traffic, the full-size cell whose metrics it
# reports, if BENCHMARK.json has one)
CELLS = {'tiny.synth': ('daft-exprt.hifigan-v2', 'batch-synth.b512',
                        'v2.synth-bf16.b512'),
         'tiny.gan': ('daft-exprt.hifigan-v1', 'gan-segments.b16',
                      'v1.gan-f32.b16')}


def tiny_root(tmp):
    root = Path(tmp) / 'bench'
    shutil.copytree(REPO / 'portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (root / 'daft_exprt_torch').symlink_to(REPO / 'daft_exprt_torch')
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cfgs = {c['name']: c for c in bench['configs']}
    pkg = root / 'portbench'
    for name, (config, traffic, full) in CELLS.items():
        cfg = json.loads((REPO / cfgs[config]['file']).read_text())
        mix = json.loads((pkg / 'traffic' / f'{traffic}.json').read_text())
        if mix['kind'] == 'synth':
            cfg['acoustic']['frame_buckets'] = [64, 128]
            mix.update(batch=4, frames=[32, 64], frames_mean=52,
                       warmup_shapes=[[64, 12]],
                       warmup_batches=1, trace_batches=2, check_batches=2)
        else:
            cfg['vocoder']['upsample_initial_channel'] = 64
            mix.update(batch=2, segment=2048, trace_iterations=1)
        (pkg / 'configs' / f'{name}.json').write_text(json.dumps(cfg))
        (pkg / 'traffic' / f'{name}.json').write_text(json.dumps(mix))
        bench['configs'].append(dict(cfgs[config], name=name,
                                     file=f'portbench/configs/{name}.json'))
        bench['workloads'].append(dict(name=name, config=name, traffic=name,
                                       chips=1, why='a CPU test'))
        for sec in ('end_to_end', 'per_layer'):
            for m in bench[sec]:
                if full is not None and full in m.get('workloads', []):
                    m['workloads'].append(name)
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


def harness(root):
    """The copy's harness module, imported from its own directory."""
    for p in (str(root), str(root / 'portbench')):
        if p not in sys.path:
            sys.path.insert(0, p)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f'harness_{abs(hash(str(root)))}', root / 'portbench' / 'harness.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

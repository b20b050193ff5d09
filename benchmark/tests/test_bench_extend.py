"""A cell, a traffic mix, a configuration and a per-layer metric added as
new files (and entries of BENCHMARK.json) in a copy of the benchmark are
found and run without an edit to any file that is there."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import REPO, TINY_CONFIG

NEW_METRIC = '''"""Steps of the traced epoch a second (a test's metric)."""


def read(r):
    return r.e2e[r.metric['moves']] / r.mix['batch']
'''


def test_added_files_are_found(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    b = root / 'benchmark'
    # a configuration, a traffic mix, a cell's limits and a metric, as files
    cfg = json.loads((b / 'configs' / 'kdd.json').read_text())
    cfg.update(TINY_CONFIG, name='tiny')
    (b / 'configs' / 'tiny.json').write_text(json.dumps(cfg))
    (b / 'traffic' / 'train-bs16.json').write_text(json.dumps(
        {'driver': 'train', 'batch': 16, 'pack_seeds': 1,
         'check_steps': 3}))
    (b / 'workloads' / 'tiny-train-bs16.json').write_text(json.dumps(
        {'limits': {'loss_gap': 1e-5, 'grad1_gap': 1e-5,
                    'delta_gap': 1e-5}}))
    (b / 'metrics' / 'steps_per_s.py').write_text(NEW_METRIC)
    bench['configs'].append({'name': 'tiny', 'source': 'a test',
                             'file': 'benchmark/configs/tiny.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny-train-bs16', 'config': 'tiny',
                               'traffic': 'train-bs16', 'chips': 1,
                               'why': 'a test'})
    for m in bench['end_to_end']:
        if m['name'] == 'train_samples_per_s':
            m['workloads'].append('tiny-train-bs16')
    bench['per_layer'].append({
        'name': 'steps_per_s.train', 'unit': 'steps/s', 'better': 'higher',
        'source': 'host_clock', 'layer': 'trainer (train.Trainer, '
        'graphs.StepGraph)', 'moves': 'train_samples_per_s',
        'workloads': ['tiny-train-bs16']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    code = (f'import sys, time\n'
            f'sys.path.insert(0, {str(root)!r})\n'
            f'sys.path.append({str(REPO)!r})\n'
            f'import torch; torch.set_num_threads(2)\n'
            f'from benchmark import harness\n'
            f'assert harness.ROOT == __import__("pathlib").Path('
            f'{str(b)!r})\n'
            f'r = harness.run("tiny-train-bs16", 7, 0.2, True, '
            f'time.perf_counter(), root={str(root)!r}, device="cpu")\n'
            f'harness.report(r)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    assert result['metrics']['steps_per_s.train']['value'] > 0

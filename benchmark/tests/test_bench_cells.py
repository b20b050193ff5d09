"""Every cell of BENCHMARK.json loads its files and runs a tiny CPU pass
through its driver, untraced and traced, and the result line has the keys
and metrics the contract asks for."""

import json
import time

import pytest

from benchmark import harness, inputs
from benchmark.tests.conftest import REPO, tiny

BENCH = harness.benchmark_file(REPO)
CELLS = [w['name'] for w in BENCH['workloads']]


def _run(name, trace, **kw):
    entry = harness.cell_entry(BENCH, name)
    driver = inputs.traffic(entry['traffic'])['driver']
    return harness.run(name, 2 ** 31 + 12345, 0.3, trace,
                       time.perf_counter(), root=REPO, device='cpu',
                       overrides=tiny(driver), **kw)


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_are_found(name):
    entry = harness.cell_entry(BENCH, name)
    cfg = inputs.config(entry['config'])
    assert cfg['name'] == entry['config']
    assert inputs.traffic(entry['traffic'])['driver'] in (
        'train', 'cmll', 'score')
    assert harness.limits(name)
    for m in harness.per_layer(BENCH, name):
        assert callable(harness.metric_reader(m['name']).read)


@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_on_the_cpu(name, cpu_threads, capsys):
    result = _run(name, False)
    assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                                'device']
    assert list(result)[-1] == 'checks'
    assert result['correct'] is True, result['checks']
    assert result['failed'] == 0 and result['attempted'] > 0
    want = {m['name'] for m in harness.end_to_end(BENCH, name)}
    assert set(result['metrics']) == want
    assert all(v['value'] > 0 for v in result['metrics'].values())
    assert set(result['checks']) == set(harness.limits(name))
    harness.report(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-1].startswith('check ')


@pytest.mark.parametrize('name', CELLS)
def test_traced_run_on_the_cpu(name, cpu_threads):
    result = _run(name, True)
    assert result['correct'] is True
    # on the CPU no device metric is read: only the host-clock ones
    host = {m['name'] for m in harness.per_layer(BENCH, name)
            if m['source'] == 'host_clock'}
    assert set(result['metrics']) == host
    assert 'busy_s' not in result['device']


def test_every_metric_is_reported_by_its_cells():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for name in CELLS:
        names = {m['name'] for m in harness.end_to_end(BENCH, name)}
        assert 'setup_s' in names and len(names) >= 2
        layer = harness.per_layer(BENCH, name)
        assert layer
        for m in layer:
            assert m['moves'] in names
            assert e2e[m['moves']]['name'] in names


def test_a_reader_is_found_by_the_longest_prefix():
    assert harness.metric_reader('device.idle_pct.any').__file__.endswith(
        'device.idle_pct.py')
    with pytest.raises(FileNotFoundError):
        harness.metric_reader('no_such_metric.train')

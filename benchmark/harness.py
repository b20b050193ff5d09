"""The harness: one run of one cell, driven by data.

A cell (an entry of `workloads` in `BENCHMARK.json`) names a configuration
and a traffic mix. The harness finds everything else by those names:

- `configs/<config>.json`: the model's sizes and the run's hyperparameters;
- `traffic/<traffic>.json`: the mix's parameters, with `driver` naming the
  module under `drivers/` that runs it;
- `workloads/<cell>.json`: the limits of the numbers that decide `correct`;
- `metrics/<metric>.py`: the reader of a per-layer metric; where there is
  no file of the metric's whole name, the one of its longest prefix that
  ends before a '.' (`device.idle_pct.train` reads with
  `device.idle_pct.py`), so one reader serves a quantity in every cell.
  The metric's unit, layer, source and `moves` are its entry's in
  `BENCHMARK.json`; the reader gets the entry.

A run: the driver's set-up (inputs from the seed, the program's objects,
warm-up of the shapes the window uses), the measured window (`--seconds`),
with `--trace 1` a bounded traced window after it, the peak memory, the
program's state freed, then the comparison with the plain reference. The
last line of standard output is the result; the numbers compared, each
beside its limit, are also the last lines of standard error.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from benchmark import inputs, trace as tracing

ROOT = inputs.ROOT
# top-level module names that must not be loaded: the JAX stack and the
# JAX package (compared whole: the port's name begins with the JAX one's)
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'pgmvae_tpu')


class Reading(NamedTuple):
    """What a per-layer metric's reader gets."""
    cfg: dict                  # the configuration file
    mix: dict                  # the traffic file
    e2e: dict                  # the measured window's end-to-end values
    trace: Optional[tracing.Trace]
    work: dict                 # the traced window's work, by the driver
    metric: dict               # the metric's entry in BENCHMARK.json


class Log:
    """Lines on standard error, and the set-up's parts with their
    seconds."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.t = time.perf_counter()

    def __call__(self, msg: str) -> None:
        print(f'[bench] {msg}', file=self.stream, flush=True)

    def part(self, name: str, sync_device=None) -> None:
        if sync_device is not None and torch.device(
                sync_device).type == 'cuda':
            torch.cuda.synchronize(sync_device)
        now = time.perf_counter()
        self(f'setup {name}: {now - self.t:.3f} s')
        self.t = now


def banned_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & set(BANNED))


def benchmark_file(root: Path) -> dict:
    return inputs.read_json(Path(root) / 'BENCHMARK.json')


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == workload:
            return w
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json')


def _reports(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def _quantity(measured: dict, name: str) -> float:
    """End-to-end metric `name` from what a driver measured: the quantity
    of its whole name, or of its longest prefix that ends before a '.'
    (`train_samples_per_s.packed` is a packed cell's
    `train_samples_per_s`, under a bound of its own)."""
    parts = name.split('.')
    for n in range(len(parts), 0, -1):
        if '.'.join(parts[:n]) in measured:
            return measured['.'.join(parts[:n])]
    raise KeyError(f'the driver measured no {name!r}')


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench['end_to_end'] if _reports(m, workload)]


def per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics of a cell: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m['name'] for m in end_to_end(bench, workload)}
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', ())
            or ('workloads' not in m and m['moves'] in e2e)]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _load(ROOT / 'drivers' / f'{name}.py', f'bench_driver_{name}')


def metric_reader(name: str):
    """The reader of metric `name`: `metrics/<name>.py`, or that of the
    longest prefix of the name that ends before a '.'."""
    parts = name.split('.')
    for n in range(len(parts), 0, -1):
        stem = '.'.join(parts[:n])
        path = ROOT / 'metrics' / f'{stem}.py'
        if path.is_file():
            return _load(path, 'bench_metric_' + stem.replace('.', '_'))
    raise FileNotFoundError(f'no reader for metric {name!r} under '
                            f'{ROOT / "metrics"}')


def limits(workload: str) -> dict:
    return inputs.read_json(ROOT / 'workloads' / f'{workload}.json')[
        'limits']


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': peak}
    info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': 1, 'memory_peak_bytes': peak}
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader', f'--id={dev.index or 0}'],
            capture_output=True, text=True, check=True, timeout=60)
        info['power_limit'] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        info['power_limit'] = f'not read ({type(e).__name__})'
    return info


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        root: Path = ROOT.parent, device='cuda', overrides=None,
        log: Optional[Log] = None) -> dict:
    """One run of cell `workload`; returns the result dict (the checks
    under 'checks', last). `t0` is the process's start on the host clock.
    `overrides` ({'config': {...}, 'traffic': {...}}) shrink a cell for the
    CPU tests."""
    log = log or Log()
    overrides = overrides or {}
    bench = benchmark_file(root)
    entry = cell_entry(bench, workload)
    cfg = {**inputs.config(entry['config']), **overrides.get('config', {})}
    mix = {**inputs.traffic(entry['traffic']),
           **overrides.get('traffic', {})}
    cell = driver(mix['driver']).Cell(cfg, mix, seed, device, log)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    log(f'setup_s {setup_s:.3f}')

    window = cell.window(seconds)
    values = {m['name']: _quantity(window['metrics'], m['name'])
              for m in end_to_end(bench, workload) if m['name'] != 'setup_s'}
    values['setup_s'] = setup_s
    log('window: ' + json.dumps(values))
    breakdown = tr = None
    if trace:
        tr = tracing.traced(cell.traced, device)
        metrics = {}
        for m in per_layer(bench, workload):
            reading = Reading(cfg, mix, values, tr, cell.traced_work, m)
            value = metric_reader(m['name']).read(reading)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        if tr is not None:
            breakdown = {'device_ops': tr.device_ops(),
                         'idle_gaps': tr.idle_gaps()}
    else:
        metrics = {m['name']: {'value': values[m['name']],
                               'unit': m['unit']}
                   for m in end_to_end(bench, workload)}
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == 'cuda' else 0)
    cell.release()
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()

    lim = limits(workload)
    checks = {}
    for name, value in cell.check().items():
        checks[name] = {'value': value, 'limit': lim[name]}
    correct = bool(checks) and all(
        c['value'] == c['value'] and c['value'] <= c['limit']
        for c in checks.values())

    dev = device_info(device, peak)
    if trace:
        if tr is not None:
            dev['busy_s'] = tr.busy_s()
            dev['window_s'] = tr.window_s
        else:
            log('the profiler saw no device event in the traced window')
    result = {'correct': correct, 'attempted': window['attempted'],
              'failed': window['failed'], 'metrics': metrics,
              'device': dev}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    return result


def report(result: dict, out=None, err=None) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result['checks'].items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})',
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)

"""The port's host spans and set-up counters (`pgmvae_tpu_torch/trace.py`):
with no profiler a span is one shared null context and nothing calls into
the profiler; under `torch.profiler` each entry point's spans appear among
the kineto host events, nested as the work is; `timed` work adds to the
process counters on each call (`stage2.cpt`), and a graph's capture on
each capture, never on a replay."""

import ast
import contextlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pgmvae_tpu_torch import graphs, trace
from pgmvae_tpu_torch.gibbs import GibbsChain
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.serving import PgmModel
from pgmvae_tpu_torch.stage2 import Stage2
from pgmvae_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25,
                     decay=0.9, quantizer='ema', dead_code_threshold=0.5)
N, BS = 37, 8
SERVE_CHILDREN = ('serve.to_device', 'serve.encode', 'serve.lookup',
                  'serve.to_host')


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, 6)).astype(np.float32)


def _model():
    params, codebook = tv.init_model(torch.Generator().manual_seed(0), CFG,
                                     device='cpu')
    return params, codebook


def _score():
    params, codebook = _model()
    dist = np.random.default_rng(1).uniform(0.1, 0.9, (6, 7))
    PgmModel(CFG, params, codebook, dist, device='cpu').score(_data()[:9])


def _gibbs():
    params, codebook = _model()
    dist = np.random.default_rng(1).uniform(0.1, 0.9, (6, 7))
    chain = GibbsChain(params, codebook, CFG, dist, _data()[:5], 2, 1)
    chain.run(0, 4, lambda i: torch.full((3, 5), 0.5))


def _cpt():
    params, codebook = _model()
    Stage2(CFG, chunk=8, device='cpu').cpt(params, codebook, _data())


def _epoch():
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    tr.run_epochs(tr.init_state(1), torch.from_numpy(_data()), 3, 0, 1)


def _packed_epoch():
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    tr.run_epochs_packed(tr.init_states_packed([1, 2]),
                         torch.from_numpy(_data()), [1, 2], 0, 1)


def _streamed_epoch():
    tr = Trainer(CFG, 0.01, BS, N, device='cpu', stream_bytes=0)
    tr.fit(tr.init_state(1), _data(), 1, seed=3)


ENTRY_POINTS = {'score': _score, 'gibbs': _gibbs, 'cpt': _cpt,
                'epoch': _epoch, 'packed_epoch': _packed_epoch,
                'streamed_epoch': _streamed_epoch}


def _host_events(run):
    """The kineto host events of `run()` under a CPU profiler session, as
    (name, start, end) in ns."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _each_inside(events, child, parent):
    """Every `child` event lies inside one `parent` event; returns the
    number of children."""
    parents = _named(events, parent)
    kids = _named(events, child)
    assert kids, f'no {child} event'
    for k in kids:
        assert any(_inside(k, p) for p in parents), (k, parents)
    return len(kids)


# -------------------------------------------------------------- off --

@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_no_profiler_no_call_into_it(entry, monkeypatch):
    """With no profiler session a span is the one shared null context: the
    entry point runs with every profiler range made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError('a profiler range was opened with the '
                             'profiler off')
    monkeypatch.setattr(trace, '_Range', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span('serve.score') is trace.span('gibbs.run')
    ENTRY_POINTS[entry]()


# --------------------------------------------------------------- on --

def test_score_spans_nest():
    events = _host_events(_score)
    (outer,) = _named(events, 'serve.score')
    for child in SERVE_CHILDREN:
        (c,) = _named(events, child)
        assert _inside(c, outer), child
    starts = [_named(events, c)[0][1] for c in SERVE_CHILDREN]
    assert starts == sorted(starts)


def test_gibbs_spans_nest():
    events = _host_events(_gibbs)
    assert len(_named(events, 'gibbs.run')) == 1
    assert _each_inside(events, 'gibbs.fill', 'gibbs.run') == 1
    assert _each_inside(events, 'graph.run', 'gibbs.run') == 1


@pytest.mark.parametrize('entry', ['epoch', 'packed_epoch',
                                   'streamed_epoch'])
def test_epoch_span(entry):
    events = _host_events(ENTRY_POINTS[entry])
    assert len(_named(events, 'train.epoch')) == 1
    assert _each_inside(events, 'graph.run', 'train.epoch') >= 1


def test_cpt_span_and_counters():
    before = trace.counters()
    events = _host_events(_cpt)
    after = trace.counters()
    assert len(_named(events, 'stage2.cpt')) == 1
    # 37 rows in chunks of 8
    assert _each_inside(events, 'stage2.chunk', 'stage2.cpt') == 5
    assert after['stage2.cpt_s'] - before.get('stage2.cpt_s', 0.0) > 0


def test_spans_in_the_exported_trace(tmp_path):
    """The spans reach the Chrome trace that `--profile` exports."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _score()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    names = {e.get('name') for e in json.loads(path.read_text())[
        'traceEvents']}
    assert {'serve.score', *SERVE_CHILDREN} <= names


def test_span_off_and_on():
    assert isinstance(trace.span('a.b'), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(trace.span('a.b'), contextlib.nullcontext)
    assert isinstance(trace.span('a.b'), contextlib.nullcontext)


# --------------------------------------------------------- counters --

def test_timed_counts_each_call_that_returns():
    """Seconds are added for each call whose body returns, and not for one
    that raises; `counters()` is a copy."""
    before = trace.counters().get('test.work_s', 0.0)
    for _ in range(3):
        with trace.timed('test.work'):
            pass
    mid = trace.counters()['test.work_s']
    with pytest.raises(ValueError):
        with trace.timed('test.work'):
            time.sleep(0.2)
            raise ValueError
    after = trace.counters()
    assert 0 < mid - before < 0.1
    assert after['test.work_s'] == mid
    after['test.work_s'] = -1.0
    assert trace.counters()['test.work_s'] == mid


@pytest.mark.parametrize('steps', [1, 5])
def test_capture_counts_once_and_replays_add_nothing(steps, monkeypatch):
    """The capture path with CUDA stood in for (no side stream, a record
    that runs the body's Python once, replays that do nothing): one
    capture a graph, whatever the replays; `capture_ms` is still the
    record's."""
    g = graphs.StepGraph(lambda gens: None, 'cpu', capture=True)
    replays = []
    monkeypatch.setattr(g, '_side_stream', contextlib.nullcontext)
    monkeypatch.setattr(g, '_record', lambda: types.SimpleNamespace(
        reset=lambda: None))
    monkeypatch.setattr(g, '_replay', lambda: replays.append(1))
    before = trace.counters().get('graph.capture_s', 0.0)
    g.run(steps)
    mid = trace.counters()['graph.capture_s']
    g.run(3)
    assert mid > before
    assert trace.counters()['graph.capture_s'] == mid
    assert len(replays) == steps - 1 + 3
    assert g.capture_ms is not None and g.capture_ms >= 0


def test_eager_graph_counts_no_capture():
    before = trace.counters().get('graph.capture_s', 0.0)
    graphs.StepGraph(lambda gens: None, 'cpu', capture=False).run(4)
    assert trace.counters().get('graph.capture_s', 0.0) == before


# ------------------------------------------------------------ apart --

def test_trace_module_imports_no_jax():
    path = os.path.join(ROOT, 'pgmvae_tpu_torch', 'trace.py')
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split('.')[0])
    assert names <= {'__future__', 'contextlib', 'time', 'torch'}
    code = ('import sys; import pgmvae_tpu_torch.trace; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "pgmvae_tpu")]; '
            'assert not bad, bad')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

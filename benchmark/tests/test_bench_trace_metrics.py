"""The readers of the program's own spans and counters: the host's share
of a scoring request (`serve.dispatch_pct.score`, from the `serve.score`
spans of a trace) on hand-built traces, and the set-up counters
(`graph.capture_s`, `stage2.cpt_s`) read from the program, 0.0 where it
counted nothing and None where it has no counters."""

import sys

import pytest

from benchmark import harness
from benchmark.harness import Reading
from benchmark.trace import Event, Trace
from benchmark.tests.conftest import REPO

BENCH = harness.benchmark_file(REPO)
NEW = ('serve.dispatch_pct.score', 'graph.capture_s', 'stage2.cpt_s')
COUNTERS = ('graph.capture_s', 'stage2.cpt_s')


def _metric(name):
    return next(m for m in BENCH['per_layer'] if m['name'] == name)


def _reading(name, trace=None):
    return Reading({}, {}, {}, trace, {}, _metric(name))


def _read(name, trace=None):
    return harness.metric_reader(name).read(_reading(name, trace))


@pytest.mark.parametrize('name', NEW)
def test_reader_is_found(name):
    m = _metric(name)
    assert callable(harness.metric_reader(name).read)
    assert m['workloads'] and all(
        m['moves'] in {e['name'] for e in harness.end_to_end(BENCH, w)}
        for w in m['workloads'])


def _trace(kernels, spans, window=(0, 1000), other=()):
    host = sorted([Event('bench.traced_window', *window)]
                  + [Event('serve.score', a, b) for a, b in spans]
                  + [Event(n, a, b) for n, a, b in other],
                  key=lambda e: e.start)
    return Trace(sorted((Event('k', a, b) for a, b in kernels),
                        key=lambda e: e.start), host, window)


@pytest.mark.parametrize('kernels,spans,want', [
    # overlapping kernels count once; a kernel across a span's end counts
    # its part inside; a kernel outside every span counts nothing
    ([(150, 200), (180, 250), (290, 350), (550, 560), (700, 800)],
     [(100, 300), (500, 600)], 100.0 * (300 - 120) / 300),
    # a kernel that starts before the span and covers all of it
    ([(50, 700)], [(100, 300), (500, 600)], 0.0),
    # no kernel inside the spans
    ([(10, 20), (900, 950)], [(100, 300)], 100.0),
    # back-to-back kernels, the first before the span
    ([(80, 120), (120, 160), (160, 190)], [(100, 200)], 10.0),
])
def test_dispatch_share(kernels, spans, want):
    tr = _trace(kernels, spans, other=[('serve.encode', 110, 190)])
    assert _read('serve.dispatch_pct.score', tr) == pytest.approx(want)


def test_dispatch_share_reads_only_the_window():
    tr = _trace([(150, 250)], [(100, 300), (1100, 1300)])
    assert _read('serve.dispatch_pct.score', tr) == pytest.approx(50.0)


@pytest.mark.parametrize('trace', [
    None,                                           # the CPU: no trace
    _trace([(10, 20)], []),                          # no serve.score span
    _trace([(10, 20)], [], other=[('bench.request', 100, 300)]),
])
def test_dispatch_share_none_without_spans(trace):
    assert _read('serve.dispatch_pct.score', trace) is None


@pytest.fixture
def program_trace(monkeypatch):
    from pgmvae_tpu_torch import trace
    monkeypatch.setattr(trace, '_COUNTERS', {})
    return trace


@pytest.mark.parametrize('name', COUNTERS)
def test_counter_reads_zero_when_nothing_counted(name, program_trace):
    assert _read(name) == 0.0


@pytest.mark.parametrize('name', COUNTERS)
def test_counter_reads_the_program(name, program_trace):
    work = name[:-len('_s')]
    program_trace.add(work, 0.25)
    program_trace.add(work, 0.5)
    assert _read(name) == pytest.approx(0.75)


@pytest.mark.parametrize('name', COUNTERS)
def test_counter_none_without_the_program_module(name, monkeypatch):
    """A program without the counters (no `pgmvae_tpu_torch.trace`)."""
    import pgmvae_tpu_torch
    monkeypatch.delattr(pgmvae_tpu_torch, 'trace', raising=False)
    monkeypatch.setitem(sys.modules, 'pgmvae_tpu_torch.trace', None)
    assert _read(name) is None

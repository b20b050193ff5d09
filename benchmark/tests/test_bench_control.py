"""What decides `correct` has to be able to fail.

- On the CPU (tiny size): a run of each cell through the harness, its look
  for a chip skipped, with the program broken underneath, comes out not
  correct, once for each fault the cell can have: a step that returns its
  state unchanged and half of the batch left out (training), an answer
  altered where it is produced (the Gibbs chain, scoring), and the
  answers of small requests a little off (scoring).
- On the card (`-m card`), at each cell's own size on three seeds: the
  control (the reference in TF32 put in the program's place) fails at least
  one of the cell's numbers, and so does each fault.
"""

import time

import numpy as np
import pytest

from benchmark import control, harness, inputs
from benchmark.tests.conftest import REPO, tiny

BENCH = harness.benchmark_file(REPO)


def _driver(name):
    return inputs.traffic(harness.cell_entry(BENCH, name)['traffic'])[
        'driver']


def _frozen(monkeypatch):
    from pgmvae_tpu_torch import train
    orig = train.Trainer._step

    def step(self, state, y, w, generators=None, seeds=None):
        keep = train.copy_state(state)
        _, metrics = orig(self, state, y, w, generators, seeds)
        train.copy_state_into(state, keep)
        return state, metrics
    monkeypatch.setattr(train.Trainer, '_step', step)


def _half_batch(monkeypatch):
    from pgmvae_tpu_torch import train
    orig = train.Trainer._step

    def step(self, state, y, w, generators=None, seeds=None):
        w = w.clone()
        w[w.shape[0] // 2:] = 0.0
        return orig(self, state, y, w, generators, seeds)
    monkeypatch.setattr(train.Trainer, '_step', step)


def _gibbs_altered(monkeypatch):
    from pgmvae_tpu_torch import gibbs
    orig = gibbs.get_probability

    def prob(*args, **kw):
        p = orig(*args, **kw).clone()
        p[0] = 1.0 - p[0]
        return p
    monkeypatch.setattr(gibbs, 'get_probability', prob)


def _score_altered(monkeypatch):
    from pgmvae_tpu_torch import serving
    orig = serving.PgmModel.score

    def score(self, y):
        out = orig(self, y).copy()
        out[0] *= 1.5
        return out
    monkeypatch.setattr(serving.PgmModel, 'score', score)


def _score_small_requests(monkeypatch):
    from pgmvae_tpu_torch import serving
    orig = serving.PgmModel.score

    def score(self, y):
        out = orig(self, y)
        return out * 1.004 if len(y) <= 8 else out
    monkeypatch.setattr(serving.PgmModel, 'score', score)


FAULTS = {'train': [_frozen, _half_batch], 'cmll': [_gibbs_altered],
          'score': [_score_altered, _score_small_requests]}
CASES = [(w['name'], f) for w in BENCH['workloads']
         for f in FAULTS[_driver(w['name'])]]


@pytest.mark.parametrize('name,fault', CASES,
                         ids=[f'{n}-{f.__name__[1:]}' for n, f in CASES])
def test_a_broken_program_is_not_correct(name, fault, monkeypatch,
                                         cpu_threads):
    fault(monkeypatch)
    result = harness.run(name, 3_000_000_019, 0.2, False,
                         time.perf_counter(), root=REPO, device='cpu',
                         overrides=tiny(_driver(name)))
    assert result['correct'] is False, result['checks']


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_control_readings_on_the_cpu(name, cpu_threads):
    got = control.readings(name, [11], [], 0.2, 'cpu',
                           overrides=tiny(_driver(name)), emit=lambda r: 0)
    kinds = [r['kind'] for r in got]
    assert kinds == ['control'] + [f'fault:{f}' for f in
                                   control.FAULTS[_driver(name)]]
    limits = harness.limits(name)
    for r in got:
        assert set(limits) <= set(r['numbers'])
        assert all(np.isfinite(v) for v in r['numbers'].values())


@pytest.mark.card
@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_control_and_faults_fail_at_the_cells_size(name, card):
    limits = harness.limits(name)
    got = control.readings(name, [101, 102, 103], [], 1.0, card,
                           emit=lambda r: 0)
    for r in got:
        failed = [k for k in limits if r['numbers'][k] > limits[k]]
        assert failed, r

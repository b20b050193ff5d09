"""The program's host spans and set-up counters.

- `span(name)`: a host range named `name` in the `torch.profiler` session
  that is recording in this process, if one is (the CLI's `--profile`, or
  any caller's `torch.profiler.profile`); otherwise nothing. The profiler's
  own enabled state is read on every call, so there is no switch: off, a
  span costs that one check and returns one shared null context. On, it is
  a `_RecordFunctionFast` range: a host event on the profiler's clock, in
  `kineto_results.events()` and the exported trace like an operator, which
  the profiler does not project onto the device's timeline as a user
  annotation (`record_function`) is projected.
- `timed(name)`: `span(name)`, plus the host seconds added to the process
  counter `<name>_s` (`graph.capture_s`, `stage2.cpt_s`). For one-shot work
  only, never a per-step path.
  `counters()` returns a copy of the table: totals over the whole process.

A span's name says its layer: `serve.*` (`PgmModel.score`), `gibbs.*`
(`GibbsChain`), `graph.*` (`StepGraph`), `train.epoch` (`Trainer`),
`stage2.*` (`Stage2`).
"""

from __future__ import annotations

import contextlib
import time

import torch

_enabled = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_COUNTERS: dict = {}


def span(name: str):
    """A host range `name` while a profiler session records, else the
    shared null context."""
    if not _enabled():
        return _OFF
    return _Range(name)


def add(name: str, seconds: float) -> None:
    """Add `seconds` to the counter `<name>_s`."""
    _COUNTERS[f'{name}_s'] = _COUNTERS.get(f'{name}_s', 0.0) + seconds


@contextlib.contextmanager
def timed(name: str):
    """`span(name)` whose host seconds, from entry to exit, go to
    `add(name, ...)` when the body returns."""
    t0 = time.perf_counter()
    with span(name):
        yield
    add(name, time.perf_counter() - t0)


def counters() -> dict:
    """A copy of the process counters."""
    return dict(_COUNTERS)

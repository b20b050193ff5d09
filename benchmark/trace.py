"""One traced window: `torch.profiler` (CPU and CUDA activities) around a
bounded piece of a cell's work, read in memory (nothing is written to
disk), reduced to what the per-layer metrics and the `breakdown` need.

- kernels: every device event (kernels, copies, sets) with its name, start
  and duration;
- busy: the union of the device events' intervals inside the window;
- window: the host's `bench.traced_window` span, which ends after a device
  synchronisation;
- gaps: the idle stretches between device events inside the window, each
  labelled with the innermost host event running at its middle (the
  benchmark's own `bench.*` spans, a PyTorch operator or a CUDA runtime
  call).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

WINDOW_SPAN = 'bench.traced_window'
GAP_LABELS = 2000     # longest gaps that get a host label
TOP = 10


class Event(NamedTuple):
    name: str
    start: int         # ns
    end: int           # ns


class Trace(NamedTuple):
    kernels: List[Event]      # device events inside the window
    host: List[Event]         # host events, by start
    window: Tuple[int, int]   # ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        total, reach = 0, self.window[0]
        for e in self.kernels:
            lo, hi = max(e.start, reach), min(e.end, self.window[1])
            if hi > lo:
                total += hi - lo
                reach = hi
        return total * 1e-9

    def kernel_s(self, names) -> Tuple[float, int]:
        """(seconds, count) of the device events whose name holds any of
        `names`."""
        hits = [e for e in self.kernels if any(n in e.name for n in names)]
        return sum(e.end - e.start for e in hits) * 1e-9, len(hits)

    def n_kernels(self) -> int:
        """Kernel launches: device events that are not copies or sets."""
        return sum(1 for e in self.kernels
                   if not e.name.startswith(('Memcpy', 'Memset')))

    def device_ops(self) -> list:
        by = defaultdict(int)
        for e in self.kernels:
            by[e.name[:120]] += e.end - e.start
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """Idle seconds by what the host was doing, the longest
        GAP_LABELS gaps labelled, the largest TOP labels."""
        gaps, reach = [], self.window[0]
        for e in self.kernels:
            if e.start > reach:
                gaps.append((reach, e.start))
            reach = max(reach, e.end)
        if self.window[1] > reach:
            gaps.append((reach, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h.start for h in self.host]
        by = defaultdict(int)
        for lo, hi in gaps[:GAP_LABELS]:
            by[self._host_at((lo + hi) // 2, starts)] += hi - lo
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: int, starts) -> str:
        i = bisect.bisect_right(starts, t)
        for h in reversed(self.host[max(0, i - 4000):i]):
            if h.end >= t and h.name != WINDOW_SPAN:
                return h.name[:120]
        return 'host outside any traced event'


def _events(prof):
    kin = prof.profiler.kineto_results.events()
    device, host, window = [], [], None
    for e in kin:
        start = e.start_ns()
        ev = Event(e.name(), start, start + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copy of a host span is no device work
            if not (ev.name.startswith('bench.')
                    or getattr(e, 'is_user_annotation', bool)()):
                device.append(ev)
        else:
            host.append(ev)
            if ev.name == WINDOW_SPAN:
                window = (ev.start, ev.end)
    return device, host, window


def traced(run: Callable[[], None], device) -> Optional[Trace]:
    """Trace `run()` (which ends in a device synchronisation) once; None
    when the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            run()
    device_events, host, window = _events(prof)
    if window is None or not device_events:
        return None
    kernels = sorted((e for e in device_events
                      if e.end > window[0] and e.start < window[1]),
                     key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return Trace(kernels, host, window)


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own around a call into the program."""
    from torch.profiler import record_function
    with record_function(name):
        yield

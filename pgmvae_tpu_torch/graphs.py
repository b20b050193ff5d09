"""Multi-step device executions as CUDA graphs: the port's counterpart of
the JAX package's `jit` + `lax.scan` / `lax.fori_loop` (a train epoch, a
streamed chunk, a Gibbs segment).

A `StepGraph` holds one step body that reads and writes only static
buffers: tensors that keep their addresses from step to step (params,
moments, EMA state, step counters, the data, a permutation, a chunk or
uniform buffer), with a device counter in place of the loop index. The body
ends by copying every tensor it made anew into the static buffer that the
next step reads.

On CUDA (`capture=True`) the first step runs eagerly on a side stream as
the warm-up: it builds and loads the kernels, sets up cuBLAS and autograd,
and advances the caller's state like any other step. The body is then
captured on that stream into a `torch.cuda.CUDAGraph` with a private memory
pool, and every later step is one `replay()` on the current stream. The
side stream is the device's one capture stream (`capture_stream`), shared
by every graph: cuBLAS keeps a workspace for each (handle, stream) pair it
has run a GEMM on, for the life of the process, so a new stream a graph
would leave two more workspaces behind (the forward's, and the backward's
on autograd's thread) with every graph captured. The
graph keeps its pool until `release()`. A failure to capture or replay
raises; nothing falls back to the eager loop. On the CPU, or with
`capture=False` (the eager reference the graphs are held against on the
card), `run` calls the body once a step in a Python loop: the plain
version.

Random draws inside the body come from the `generators` it is given. For a
capture these are the graph's own generators, registered with it; before
each run of replays their states are set from the caller's generators, and
after it the caller's are set from theirs, so the draws are the ones the
eager loop makes and the caller's generators end where the eager loop would
leave them.

Launch accounting: the kernel wrappers count a launch when Python calls
them (`ops/kernels.py`). A capture calls them without launching anything,
so the counts a capture adds are taken back and kept as the graph's
launches per step, and every replay adds them again. The counts then read
as if every step had run eagerly.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Sequence

import torch

from pgmvae_tpu_torch import trace
from pgmvae_tpu_torch.ops import kernels

_CAPTURE_STREAMS = {}      # CUDA device index -> its capture stream


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream on which every StepGraph of `device` warms up and
    captures: one a device, made at first use (see the module doc)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def tensor_key(*tensors) -> tuple:
    """What a captured graph holds of tensors: address, shape and type."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class StepGraph:
    """A step body `body(generators)` run `steps` times by `run`: captured
    and replayed on CUDA, looped eagerly otherwise (see the module doc).
    `n_generators` is the number of generators the body draws from; `key`
    names what the body reads, for a cache to compare."""

    def __init__(self, body: Callable[[Sequence[torch.Generator]], None],
                 device: torch.device, n_generators: int = 0,
                 capture: bool = True, key=None, buffers=None):
        self.body, self.device, self.key = body, torch.device(device), key
        self.buffers = buffers          # the static buffers the body reads
        self.capture = capture
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(n_generators)]
        self.graph = None
        self.launches = {}      # captured launches by name, per replay
        self.capture_ms: Optional[float] = None
        self.replays = 0

    def run(self, steps: int,
            generators: Sequence[torch.Generator] = ()) -> None:
        """`steps` steps of the body, drawing from `generators` (one for
        each of the body's)."""
        generators = list(generators)
        if len(generators) != len(self.generators):
            raise ValueError(f'the body draws from {len(self.generators)} '
                             f'generators, got {len(generators)}')
        if steps <= 0:
            return
        with trace.span('graph.run'):
            self._run(steps, generators)

    def _run(self, steps: int, generators) -> None:
        if not self.capture:
            for _ in range(steps):
                self.body(generators)
            return
        if self.graph is None:
            self._capture(generators)
            steps -= 1
        if steps == 0:
            return
        for mine, theirs in zip(self.generators, generators):
            mine.set_state(theirs.get_state())
        for _ in range(steps):
            self._replay()
        self.replays += steps
        kernels.add(self.launches, steps)
        for mine, theirs in zip(self.generators, generators):
            theirs.set_state(mine.get_state())

    def _capture(self, generators) -> None:
        """The warm-up step (eager, on the side stream, counted as it
        launches), then the capture of the body, whose counted launches
        become the graph's per replay. `capture_ms` is the record, which
        begins with the device synchronisation `torch.cuda.graph` makes on
        entry (the wait for the warm-up); the counter `graph.capture_s`
        takes the warm-up and the record."""
        with trace.span('graph.capture'):
            t0 = time.perf_counter()
            with self._side_stream():
                self.body(generators)
            before = kernels.counts()
            try:
                t1 = time.perf_counter()
                self.graph = self._record()
                t2 = time.perf_counter()
            finally:
                self.launches = kernels.since(before)
                kernels.restore(before)
        self.capture_ms = (t2 - t1) * 1e3
        trace.add('graph.capture', t2 - t0)

    @contextlib.contextmanager
    def _side_stream(self):
        """The device's capture stream as the current stream (yielded),
        ordered after the work queued so far and before the work queued
        after."""
        stream = capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield stream
        current.wait_stream(stream)

    def _record(self):
        """The body captured on the side stream into a CUDA graph with its
        own memory pool and the body's generators registered."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with self._side_stream() as stream, torch.cuda.graph(graph,
                                                             stream=stream):
            self.body(self.generators)
        return graph

    def _replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        """Drop the graph, its memory pool and the buffers it holds."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            torch.cuda.empty_cache()
        self.buffers = self.body = None

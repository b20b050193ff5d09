"""The port's hand-written CUDA kernels and their launch counts, in one
place. Each kernel wrapper calls `register(build, *names)` at import and
`count(name)` for each launch; `pgmvae_tpu_torch.ops` imports every
wrapper, and that order is the key order of `counts()` and of every report
made from it. `counts()` is also the snapshot that `since` and `restore`
take: `graphs.StepGraph` keeps a capture's `since` as its launches per
replay. This module imports nothing of the port."""

from __future__ import annotations

from typing import Callable

_BUILDS = {}        # first counter name -> the kernel library's build
_COUNTS = {}        # counter name -> launches so far


def register(build: Callable, *names: str) -> None:
    """A kernel library's `build` and its counters' names, each new, at 0."""
    taken = [name for name in names if name in _COUNTS]
    if not names or taken:
        raise ValueError(f'launch counters {names} (taken: {taken})')
    _BUILDS[names[0]] = build
    _COUNTS.update(dict.fromkeys(names, 0))


def builds() -> dict:
    """Every registered library's build, by its first counter's name."""
    return dict(_BUILDS)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts() -> dict:
    """Every registered counter by name, zeros included."""
    return dict(_COUNTS)


def since(snapshot: dict) -> dict:
    return {name: n - snapshot.get(name, 0) for name, n in _COUNTS.items()}


def restore(snapshot: dict) -> None:
    _COUNTS.update(snapshot)


def add(deltas: dict, steps: int = 1) -> None:
    """Add `steps` times each of `deltas` to its counter."""
    for name, n in deltas.items():
        _COUNTS[name] += n * steps


def reset() -> None:
    _COUNTS.update(dict.fromkeys(_COUNTS, 0))

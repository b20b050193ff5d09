"""Host-side loading of the TRW benchmark CSVs.

The TRW files are strictly single-char `0`/`1` CSV, so each row is exactly
`2*n_var` bytes (`n_var` digits + `n_var-1` commas + newline). They are read
by the native multithreaded parser (`data/native.py`) where it runs, else by
reshaping the raw byte buffer with numpy; files of any other layout go
through `np.genfromtxt`.

Leave-one-out views are never materialized on the training path (each
network masks its own variable inside the model); `leave_one_out_index` and
`leave_one_out` give the reference's gather table and views for tests and
debugging, as the JAX package's do.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from pgmvae_tpu_torch import registry


def load_binary_csv(path: str, n_var: int) -> np.ndarray:
    """Load a 0/1 CSV with `n_var` columns into a uint8 array [N, n_var].

    Path order, as the JAX package's: the native parser, the numpy
    byte-stride parse, `np.genfromtxt`."""
    from pgmvae_tpu_torch.data import native
    arr = native.parse_binary_csv(path, n_var)
    if arr is not None:
        return arr
    with open(path, 'rb') as f:
        buf = f.read()
    row_bytes = 2 * n_var  # digits + commas + '\n'
    rem = len(buf) % row_bytes
    if rem in (0, row_bytes - 1):
        # Tolerate a missing trailing newline by appending one.
        if rem == row_bytes - 1:
            buf += b'\n'
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(-1, row_bytes)
        vals = arr[:, ::2] - ord('0')
        if vals.max(initial=0) <= 1 and (arr[:, 1::2][:, :-1] == ord(',')).all():
            return np.ascontiguousarray(vals)
    # General CSV (handles \r\n or multi-digit values).
    return np.genfromtxt(path, delimiter=',', dtype=np.uint8)


def load_split(name: str, split: str, root: Optional[str] = None,
               dtype=np.float32) -> np.ndarray:
    """Load one split of a registry dataset as [N, n_var] of `dtype`."""
    info = registry.REGISTRY[name]
    y = load_binary_csv(registry.split_path(name, split, root), info.n_var)
    return y.astype(dtype)


@lru_cache(maxsize=None)
def leave_one_out_index(n_var: int) -> np.ndarray:
    """Static gather table [n_var, n_var-1] int32: row v is
    [0 .. n_var-1] without v (the reference's off-diagonal construction)."""
    full = np.broadcast_to(np.arange(n_var, dtype=np.int32), (n_var, n_var))
    mask = ~np.eye(n_var, dtype=bool)
    return np.ascontiguousarray(full[mask].reshape(n_var, n_var - 1))


def leave_one_out(y: np.ndarray) -> np.ndarray:
    """Materialized leave-one-out views [n_var, N, n_var-1] of y [N, n_var]
    (tests and debugging only)."""
    idx = leave_one_out_index(y.shape[-1])
    return np.transpose(y[:, idx], (1, 0, 2))

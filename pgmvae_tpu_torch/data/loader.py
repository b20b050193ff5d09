"""Host-side loading of the TRW benchmark CSVs.

The TRW files are strictly single-char `0`/`1` CSV, so each row is exactly
`2*n_var` bytes (`n_var` digits + `n_var-1` commas + newline) and parses by
reshaping the raw byte buffer. Files of any other layout go through
`np.genfromtxt`. (The JAX package also has a native multithreaded parser;
the port does not carry it yet.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pgmvae_tpu_torch import registry


def load_binary_csv(path: str, n_var: int) -> np.ndarray:
    """Load a 0/1 CSV with `n_var` columns into a uint8 array [N, n_var]."""
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

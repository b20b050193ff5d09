"""ctypes binding of the native 0/1 CSV parser, `native/fastcsv.cpp` (the
port of `pgmvae_tpu/data/native.py`): the file is mmapped and its rows are
converted to bytes by several threads, straight into the output array.

The library is built at first use with g++ from the repository's source
into `pgmvae_tpu_torch/_build/libfastcsv-<hash>.so` (the hash covers the
source and the flags), written under a temporary name and renamed into
place, so concurrent first uses never load a half-written file; `native/`
is left as it is. As in the JAX package the parser is a speed path, never a
dependency: if it cannot be built or loaded, `parse_binary_csv` returns
None (`available()` is False, `unavailable()` says why) and the loader
parses with numpy. `PARSES` counts the files it parsed, so a run can show
which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pgmvae_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'fastcsv.cpp'
FLAGS = ('-O3', '-march=native', '-std=c++17', '-fPIC', '-Wall', '-Wextra',
         '-shared', '-pthread')
PARSES = 0

_lock = threading.Lock()
_lib = None
_why: Optional[str] = None


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + ' '.join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libfastcsv-{tag}.so'


def build() -> ctypes.CDLL:
    """Compile the parser (once per source and flags) and load it; raises
    RuntimeError when g++ is missing or fails."""
    so = library_path()
    if not so.exists():
        cxx = shutil.which('g++')
        if cxx is None:
            raise RuntimeError('g++ not found: the native CSV parser is '
                               'built at first use')
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        proc = subprocess.run([cxx, *FLAGS, '-o', str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed with code {proc.returncode}: '
                               f'{proc.stderr[-2000:]}')
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.fastcsv_parse.restype = ctypes.c_int
    lib.fastcsv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _why
    with _lock:
        if _lib is None and _why is None:
            try:
                _lib = build()
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _why = f'{type(e).__name__}: {e}'
        return _lib


def unavailable() -> Optional[str]:
    """Why the parser cannot run here, or None when it can."""
    _load()
    return _why


def available() -> bool:
    """Whether the parser runs here (builds and loads at first call), as
    the JAX package's `available()`."""
    return unavailable() is None


def parse_binary_csv(path: str, n_var: int) -> Optional[np.ndarray]:
    """Parse a 0/1 CSV into uint8 [N, n_var], or None when the parser is
    unavailable or the file does not have the single-char layout (2 * n_var
    bytes a row, an optional missing last newline)."""
    global PARSES
    lib = _load()
    if lib is None:
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    max_rows = size // (2 * n_var) + 1
    out = np.empty((max_rows, n_var), np.uint8)
    rows = ctypes.c_int64(0)
    rc = lib.fastcsv_parse(
        os.fsencode(path), n_var,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_rows,
        ctypes.byref(rows))
    if rc != 0:
        return None
    PARSES += 1
    return out[:rows.value]

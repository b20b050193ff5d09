"""Build a CUDA source of the port into a shared library with a plain C
interface and load it with ctypes.

`build(name, source, flags)` compiles `source` with nvcc at first use into
`pgmvae_tpu_torch/_build/lib<name>-<hash>.so`, where the hash covers the
source and the flags, so an edited kernel or a changed flag builds anew. The
compiler's output (ptxas registers and spills with `-Xptxas -v`) is kept
beside the library as `.log`. A missing nvcc or a failed build raises
RuntimeError; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
DEFAULT_NVCC = '/usr/local/cuda/bin/nvcc'
# every kernel: Hopper with its 'a' features, a shared library, ptxas report
BASE_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc(name: str) -> str:
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    if os.path.isfile(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError(
        f'nvcc not found: the CUDA kernel {name} is built at first use and '
        f'needs the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path(name: str, source: Path, flags: Sequence[str]) -> Path:
    """Where `build` puts the library for this source and these flags."""
    tag = hashlib.sha256(Path(source).read_bytes()
                         + ' '.join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{tag}.so'


def build(name: str, source: Path, flags: Sequence[str]) -> ctypes.CDLL:
    """Compile `source` with BASE_FLAGS + `flags` (once per source and
    flags) and load the library. The caller declares argtypes/restype."""
    flags = BASE_FLAGS + tuple(flags)
    so = library_path(name, source, flags)
    if not so.exists():
        nvcc = find_nvcc(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [nvcc, *flags, '-o', str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed with code {proc.returncode}: '
                               f'{" ".join(cmd)}\n{proc.stderr}')
        so.with_suffix('.log').write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))

"""The EMA codebook step of a training step as one CUDA kernel.

`ema_update_fused(state, z, indices, weights, decay, epsilon, zero_debias)`
takes the batch's codes and latents and returns (the new `EmaState`, the
batch counts [n, K]): what `quantizer.code_stats` followed by
`quantizer.ema_update` give (`ema_update_plain`), the batch counts being
the first half of `code_stats`. It writes the new counts, dw and codebook
IN PLACE into the state's tensors, on every device: the state it returns
holds the same tensors (and a new step), so a step graph copies nothing
back. A caller that must keep the old values copies them first. On a CUDA
tensor it launches the kernel in `csrc/ema_update.cu` (design and bound
are noted there) or raises; on a CPU tensor it runs `ema_update_plain` and
copies the result into the state. The kernel builds no one-hot and no
dense batch statistics. The plain version returns new tensors and leaves
its inputs alone.

Its arithmetic is the plain version's, in the same order and float32
constants; the two differ only in the order of two sums (a code's rows'
z-sum, and the counts' sum over K), so the batch counts of 0/1 weights and
the new counts are bit-equal, and dw and the codebook agree to rounding.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C entry point, at first use, by `ops/_build.py`, and bound with
ctypes. `plan(n, B, D, K)` chooses the launch (threads a block, batch rows
a tile, the hash of the hit codes, codes a chunk, where the tables live)
and the C entry point checks it; it takes any K and any B. The calls that
launched the kernel are counted as 'ema' (`kernels.count`).

The wrapper is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()`, the debias factor 1 - decay^step
is a device tensor made from the state's step by PyTorch operations (no
host read), its output and scratch come from the caching allocator, and the C
entry point's runtime calls are the launch, `cudaGetLastError` and, once a
process at its first call, the opt-in to a block's full shared memory. The
library must be built and that first call made before a capture (the
graphs' eager warm-up step does both); a first build during a capture
raises. A capture counts its launch once, and `graphs.StepGraph` adds it
again for every replay.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from pgmvae_tpu_torch.ops import _build, kernels
from pgmvae_tpu_torch.ops import quantizer as q

_SRC = Path(__file__).resolve().parent / 'csrc' / 'ema_update.cu'
_FLAGS = ('-O3', '-fmad=false')
_lib = None


def library_path() -> Path:
    """Where `build` puts the compiled library for this source and flags."""
    return _build.library_path('ema_update', _SRC,
                               _build.BASE_FLAGS + _FLAGS)


def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel's library; see
    `_build.build`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.build('ema_update', _SRC, _FLAGS)
    lib.ema_update.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                               + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.ema_update.restype = ctypes.c_int
    lib.ema_update_error_string.argtypes = [ctypes.c_int]
    lib.ema_update_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


kernels.register(build, 'ema')


SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_THREADS = 1024        # threads a block (csrc/ema_update.cu)
SHARED_THREADS = 512      # where blocks share an SM: two fit at 64 registers
MIN_THREADS = 64
UNROLL = 2                # float4 groups a thread holds a round
TILE_ROWS = 32            # batch rows staged at a time (one warp's match)
SMEM_BYTES = 232448       # a block's shared memory, opted in (227 KB)
SHARED_SMEM_BYTES = 115712    # a block's where two share an SM's 228 KB
MIN_HASH_BITS = 5
MIN_CHUNK = 1024          # codes a chunk the tables must leave room for,
                          # else they go to device memory


class Plan(NamedTuple):
    """One launch: a block of `threads` threads a network (`grid` blocks),
    the batch staged `tb` rows at a time, `slots` = min(B, K) slots for the
    codes the batch hits in a hash of 2^`hbits` entries, the streaming pass
    `kc` codes a chunk, the tables (hash and slots) in shared memory or, if
    not `shared_tables`, in a scratch buffer of `table_words` int32 a
    network; `smem_bytes` of shared memory a block."""
    threads: int
    tb: int
    slots: int
    hbits: int
    kc: int
    shared_tables: bool
    table_words: int
    grid: int
    smem_bytes: int

    @property
    def args(self):
        """The C entry point's plan arguments, in its order."""
        return (self.threads, self.tb, self.slots, self.hbits, self.kc)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _table_words(d: int, slots: int, hbits: int) -> int:
    """A network's tables (csrc/ema_update.cu `table_words`): the hash's
    keys and slots [2^hbits] each, the slots' codes and statistics
    [slots * (D + 2)]."""
    return 2 * (1 << hbits) + slots * (d + 2)


def _smem_bytes(d: int, tb: int, slots: int, hbits: int, kc: int,
                shared_tables: bool) -> int:
    """Shared memory of a block (csrc/ema_update.cu `smem_words`): a
    chunk's smoothed counts and slots [kc] each, the tile
    [tb * (D + 4)], 34 words besides, and the tables where they are
    shared."""
    return 4 * (2 * kc + tb * (d + 4) + 34
                + (_table_words(d, slots, hbits) if shared_tables else 0))


@functools.lru_cache(maxsize=1024)
def plan(n: int, b: int, d: int, k: int) -> Plan:
    """The launch for z [n, b, d] and a [n, d, k] codebook (pure: the CPU
    tests check it). A block's shared memory is its SM's where there are
    no more networks than SMs (a block an SM), else half of it. The tables
    stay in it where they leave room for a chunk of min(K, MIN_CHUNK)
    codes, and the chunk takes the rest, up to all of K (else a multiple
    of 4). A network's D * kc elements go UNROLL float4 groups a thread,
    so a block takes a power of two of threads up to one pass over them,
    at least MIN_THREADS; up to MAX_THREADS a block an SM, else
    SHARED_THREADS. Raises ValueError on what the kernel does not take."""
    if min(n, b, d, k) < 1:
        raise ValueError(f'empty shape {(n, b, d, k)}')
    if d * k >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f'shape {(n, b, d, k)} is past the kernel\'s grid')
    alone = n <= SMS
    cap = MAX_THREADS if alone else SHARED_THREADS
    budget = SMEM_BYTES if alone else SHARED_SMEM_BYTES
    tb, slots = min(b, TILE_ROWS), min(b, k)
    hbits = max(MIN_HASH_BITS, (4 * slots - 1).bit_length())
    shared = _smem_bytes(d, tb, slots, hbits, min(k, MIN_CHUNK),
                         True) <= budget
    kc = min(k, (budget - _smem_bytes(d, tb, slots, hbits, 0, shared)) // 8)
    if kc < k:
        kc -= kc % 4
    if kc < min(k, 4):
        raise ValueError(f'shape {(n, b, d, k)}: a tile of {tb} rows of D '
                         f'{d} leaves no room for a chunk of codes')
    threads = min(cap, max(MIN_THREADS,
                           _pow2_at_least(-(-d * kc // (4 * UNROLL)))))
    return Plan(threads, tb, slots, hbits, kc, shared,
                _table_words(d, slots, hbits), n,
                _smem_bytes(d, tb, slots, hbits, kc, shared))


def _check(state: q.EmaState, z: torch.Tensor, indices: torch.Tensor,
           weights: Optional[torch.Tensor]) -> None:
    """Shapes, types, devices and layout the kernel takes, checked on every
    device before anything runs."""
    if z.dim() != 3 or state.codebook.dim() != 3:
        raise ValueError(f'z must be [n, B, D] and the codebook [n, D, K]; '
                         f'got {tuple(z.shape)} and '
                         f'{tuple(state.codebook.shape)}')
    n, b, d = z.shape
    k = state.codebook.shape[2]
    want = {'codebook': (n, d, k), 'dw': (n, d, k), 'counts': (n, k)}
    got = {'codebook': state.codebook, 'dw': state.dw,
           'counts': state.counts}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f'the EMA {name} is {tuple(got[name].shape)}, '
                             f'z {tuple(z.shape)} needs {shape}')
    if tuple(indices.shape) != (n, b):
        raise ValueError(f'indices {tuple(indices.shape)} do not match z '
                         f'{tuple(z.shape)}')
    if weights is not None and tuple(weights.shape) != (b,):
        raise ValueError(f'weights {tuple(weights.shape)} do not match z '
                         f'{tuple(z.shape)}')
    floats = [z, state.codebook, state.dw, state.counts]
    if weights is not None:
        floats.append(weights)
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError('the EMA step takes float32 z, weights and state; '
                         f'got {[str(t.dtype) for t in floats]}')
    if indices.dtype != torch.int32:
        raise ValueError(f'the EMA step takes int32 indices, got '
                         f'{indices.dtype}')
    tensors = floats + [indices, state.step]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f'the EMA step\'s tensors lie on '
                         f'{sorted({str(t.device) for t in tensors})}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('the EMA step takes contiguous tensors')


def ema_update_plain(state: q.EmaState, z: torch.Tensor,
                     indices: torch.Tensor,
                     weights: Optional[torch.Tensor], decay: float,
                     epsilon: float = 1e-5, zero_debias: bool = True):
    """The kernel's function in plain PyTorch: `code_stats` through a
    one-hot, then `ema_update`; returns (new EmaState in new tensors, batch
    counts [n, K])."""
    counts, dw = q.code_stats(z, indices, state.codebook.shape[2], weights)
    return q.ema_update(state, counts, dw, decay, epsilon,
                        zero_debias), counts


def ema_update_fused(state: q.EmaState, z: torch.Tensor,
                     indices: torch.Tensor,
                     weights: Optional[torch.Tensor], decay: float,
                     epsilon: float = 1e-5, zero_debias: bool = True):
    """One EMA codebook step from the batch's codes: indices [n, B] int32
    of z [n, B, D] float32, sample weights [B] (None: 1), the state's
    codebook, counts and dw float32 and contiguous, all on one device.
    Writes the new counts, dw and codebook into the state's own tensors and
    returns (EmaState of them and the next step, batch counts [n, K]). CUDA
    launches the kernel (`plan`); CPU runs `ema_update_plain` and copies its
    result in; any other device raises."""
    _check(state, z, indices, weights)
    if z.device.type == 'cpu':
        new, batch_counts = ema_update_plain(state, z, indices, weights,
                                             decay, epsilon, zero_debias)
        for dst, src in zip(state[:3], new[:3]):
            dst.copy_(src)
        return q.EmaState(state.codebook, state.counts, state.dw,
                          new.step), batch_counts
    if z.device.type != 'cuda':
        raise ValueError(f'the EMA step runs on CUDA or CPU, not {z.device}')
    n, b, d = z.shape
    k = state.codebook.shape[2]
    p = plan(n, b, d, k)
    step = state.step + 1
    bias = (q._debias(decay, step, torch.float32) if zero_debias else None)
    batch_counts = torch.empty((n, k), dtype=torch.float32, device=z.device)
    tables = (None if p.shared_tables else
              torch.empty(n * p.table_words, dtype=torch.int32,
                          device=z.device))
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('ema_update: build() must run before a CUDA graph '
                           'capture')
    lib = build()
    with torch.cuda.device(z.device):
        err = lib.ema_update(
            indices.data_ptr(), z.data_ptr(),
            None if weights is None else weights.data_ptr(),
            None if bias is None else bias.data_ptr(),
            state.counts.data_ptr(), state.dw.data_ptr(),
            state.codebook.data_ptr(), batch_counts.data_ptr(),
            None if tables is None else tables.data_ptr(), n, b, d, k,
            *p.args, decay, 1.0 - decay, epsilon, k * epsilon,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ema_update_error_string(err).decode()
        raise RuntimeError(f'ema_update launch failed: CUDA error {err} '
                           f'({msg}) at shape {(n, b, d, k)}')
    kernels.count('ema')
    return q.EmaState(state.codebook, state.counts, state.dw,
                      step), batch_counts

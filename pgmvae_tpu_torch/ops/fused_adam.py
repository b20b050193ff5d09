"""Single-pass Adam update as a CUDA kernel — the counterpart of
`pgmvae_tpu/ops/fused_adam.py`.

Per parameter leaf, in one pass over memory and in place:

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + (1-b2)*g^2
    p'   = p + (-lr * (mu'/(1-b1^t)) / (sqrt(nu'/(1-b2^t)) + eps))

the arithmetic of `optax.inject_hyperparams(optax.adam)` followed by
`optax.apply_updates` (eps_root=0), with the step count t, the powers b^t
and the learning rate kept on the device.

`adam_update(params, grads, state)` launches the kernel in `csrc/adam.cu`
(design and bound are noted there) for CUDA tensors: ONE launch updates
every leaf, from a table of the leaves (`leaf_tables`; TABLE_CAPACITY
leaves a table, so an update with more leaves takes one launch a table:
`launches_per_update`). Before it, two small PyTorch operations make the
step count and the powers [b1^t, b2^t]. For CPU tensors it runs
`adam_update_plain` (the same arithmetic in the same order in plain
PyTorch), and it raises for any other device. Both write the new params and
moments into the tensors they are given: a caller that must keep the old
values copies them first.

The moments are float32, or bfloat16 (`adam_init(..., moment_dtype=
torch.bfloat16)`, adam_impl 'fused_bf16'): then the kernel's bfloat16
instance runs, which computes in float32 from the widened moments and
rounds only the stored m' and v' to nearest even, as the JAX package's
'xla_bf16' update does. The two instances' launches are counted as 'adam'
and 'adam_bf16' (`kernels.count`).

The kernel's library is built with `-fmad=false`, and the kernel and the
plain version take the bias corrections 1 - b^t from the same powers, so on
the card it is bit-equal to `adam_update_plain` on the same inputs.

The update is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()` (the capture stream under
`torch.cuda.graph`); the table travels by value in the launch's parameters,
so the graph keeps it with the node; the step count, powers and learning
rate are device tensors (a replay reads the count the last replay left);
it allocates only through the caching allocator; and the C entry point's
only runtime call besides the launch is `cudaGetLastError`. The library
and the constant [b1, b2] tensor must exist before a capture (the graphs'
eager warm-up step makes them); a first use during a capture raises.
Tables are cached by the leaves' addresses, sizes and types, so a step
over the same tensors does not rebuild them. A capture counts its launches once, and
`graphs.StepGraph` adds them again for every replay.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.ops import _build, kernels

MOMENT_DTYPES = (torch.float32, torch.bfloat16)
# csrc/adam.cu's CHUNK and TABLE_CAPACITY: values a block takes at a time,
# and leaves a launch
CHUNK = 4096
TABLE_CAPACITY = 64

_SRC = Path(__file__).resolve().parent / 'csrc' / 'adam.cu'
_FLAGS = ('-O3', '-fmad=false')
_lib = None
_BASES = {}                      # (device, b1, b2) -> float32 [b1, b2]
_TABLES = OrderedDict()          # leaves' addresses and sizes -> tables
_TABLES_KEPT = 32


class _Leaf(ctypes.Structure):
    """csrc/adam.cu's AdamLeaf."""
    _fields_ = [('p', ctypes.c_void_p), ('m', ctypes.c_void_p),
                ('v', ctypes.c_void_p), ('g', ctypes.c_void_p),
                ('numel', ctypes.c_longlong),
                ('first_chunk', ctypes.c_longlong),
                ('vec', ctypes.c_int), ('pad', ctypes.c_int)]


class _Table(ctypes.Structure):
    """csrc/adam.cu's AdamTable."""
    _fields_ = [('chunks', ctypes.c_longlong), ('n_leaves', ctypes.c_int),
                ('pad', ctypes.c_int), ('leaves', _Leaf * TABLE_CAPACITY)]


class AdamState(NamedTuple):
    """The optimizer state: optax's `ScaleByAdamState(count, mu, nu)` with
    the `inject_hyperparams` learning rate and eps beside it."""
    count: torch.Tensor          # int32 scalar: updates taken
    mu: dict                     # first moments, in the params layout
    nu: dict                     # second moments, in the params layout
    learning_rate: torch.Tensor  # float32 scalar, a runtime value
    eps: float                   # a float32 value (a launch argument)


def library_path() -> Path:
    """Where `build` puts the compiled library for this source and flags."""
    return _build.library_path('adam', _SRC, _build.BASE_FLAGS + _FLAGS)


def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel's library; see
    `_build.build`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.build('adam', _SRC, _FLAGS)
    lib.adam_update_table.argtypes = [
        ctypes.POINTER(_Table), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.adam_update_table.restype = ctypes.c_int
    lib.adam_error_string.argtypes = [ctypes.c_int]
    lib.adam_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


kernels.register(build, 'adam', 'adam_bf16')


def adam_init(params, learning_rate: float, eps: float = 1e-7,
              moment_dtype: torch.dtype = torch.float32) -> AdamState:
    """Zero moments of `moment_dtype` (float32, or bfloat16 for adam_impl
    'fused_bf16') in the params layout, count 0, on the params' device."""
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f'Adam moments are float32 or bfloat16, not '
                         f'{moment_dtype}')
    device = vqvae.param_leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)

    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mu=vqvae.map_params(zeros, params),
        nu=vqvae.map_params(zeros, params),
        learning_rate=torch.tensor(learning_rate, dtype=torch.float32,
                                   device=device),
        eps=float(np.float32(eps)))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _powers(count: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """[b1**count, b2**count] float32 on the count's device (one operation:
    a stored [b1, b2] raised to the count), along a new first axis."""
    key = (count.device, _f32(b1), _f32(b2))
    if key not in _BASES:
        if (count.device.type == 'cuda'
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError('adam: the first update on a device must '
                               'run before a CUDA graph capture')
        _BASES[key] = torch.tensor(key[1:], dtype=torch.float32,
                                   device=count.device)
    base = _BASES[key].view((2,) + (1,) * count.dim())
    return torch.pow(base, count)


def _scalars(count: torch.Tensor, lr: torch.Tensor, b1: float,
             b2: float) -> torch.Tensor:
    """[bc1, bc2, lr] float32 on the device: bc = 1 - b**count in float32,
    computed there from the count so that a step needs no host read."""
    return torch.cat([1.0 - _powers(count, b1, b2), lr.unsqueeze(0)])


def _quads(params, grads, state: AdamState):
    """(p, m, v, g) per leaf, after the checks the kernel relies on; and
    the one device they all lie on."""
    leaves = [vqvae.param_leaves(t)
              for t in (params, state.mu, state.nu, grads)]
    if len({len(x) for x in leaves}) != 1:
        raise ValueError('params, moments and grads differ in their leaves')
    quads = list(zip(*leaves))
    devices = {t.device for quad in quads for t in quad}
    devices |= {state.count.device, state.learning_rate.device}
    if len(devices) != 1:
        raise ValueError(f'Adam operands lie on more than one device: '
                         f'{sorted(map(str, devices))}')
    for quad in quads:
        p, m, v, g = quad
        if (p.dtype != torch.float32 or g.dtype != torch.float32
                or m.dtype != v.dtype or m.dtype not in MOMENT_DTYPES):
            raise ValueError(f'the Adam update takes float32 params and '
                             f'grads, and float32 or bfloat16 moments of one '
                             f'dtype; got {[t.dtype for t in quad]}')
        if any(t.shape != quad[0].shape for t in quad):
            raise ValueError(f'leaf shapes differ: '
                             f'{[tuple(t.shape) for t in quad]}')
        if not all(t.is_contiguous() for t in quad):
            raise ValueError('the Adam update takes contiguous leaves')
    return quads, devices.pop()


def _plain(quads, scalars, b1: float, b2: float, eps: float) -> None:
    bc1, bc2, lr = scalars[0], scalars[1], scalars[2]
    # (1 - b) in float32, as the kernel and optax take it
    omb1 = _f32(np.float32(1.0) - np.float32(b1))
    omb2 = _f32(np.float32(1.0) - np.float32(b2))
    b1, b2 = _f32(b1), _f32(b2)
    for p, m, v, g in quads:
        # bfloat16 moments widen exactly; p takes the unrounded m2, v2, and
        # copy_ rounds the stored moments to nearest even
        m2 = b1 * m.float() + omb1 * g
        v2 = b2 * v.float() + omb2 * (g * g)
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        p.copy_(p + (-lr) * u)
        m.copy_(m2)
        v.copy_(v2)


def _vector_ok(p, m, v, g) -> bool:
    """Whether the kernel may move a leaf four values at a time: p and g
    16-byte aligned, m and v aligned for four moments."""
    moments = 4 * m.element_size()
    return ((p.data_ptr() | g.data_ptr()) % 16 == 0
            and (m.data_ptr() | v.data_ptr()) % moments == 0)


def launches_per_update(n_leaves: int) -> int:
    """Kernel launches of one update of `n_leaves` non-empty leaves with
    moments of one dtype: one per table."""
    return -(-n_leaves // TABLE_CAPACITY)


def leaf_tables(quads) -> list:
    """The kernel's tables for (p, m, v, g) leaves of one moment dtype:
    the non-empty leaves in order, TABLE_CAPACITY a table; in each table
    every leaf is cut into chunks of CHUNK values, numbered from 0 across
    the table (`first_chunk`), with its vector flag."""
    quads = [q for q in quads if q[0].numel() > 0]
    tables = []
    for i in range(0, len(quads), TABLE_CAPACITY):
        table = _Table()
        chunks = 0
        group = quads[i:i + TABLE_CAPACITY]
        for leaf, (p, m, v, g) in zip(table.leaves, group):
            n = p.numel()
            leaf.p, leaf.m, leaf.v, leaf.g = (t.data_ptr()
                                              for t in (p, m, v, g))
            leaf.numel, leaf.first_chunk = n, chunks
            leaf.vec = int(_vector_ok(p, m, v, g))
            chunks += -(-n // CHUNK)
        table.n_leaves, table.chunks = len(group), chunks
        tables.append(table)
    return tables


def _cached_tables(quads) -> list:
    """`leaf_tables(quads)`, kept by the leaves' addresses, sizes and
    moment dtype for the next update over the same tensors."""
    key = tuple((t.data_ptr(), t.numel(), t.dtype)
                for quad in quads for t in quad)
    tables = _TABLES.get(key)
    if tables is None:
        tables = _TABLES[key] = leaf_tables(quads)
        if len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return tables


def _kernel(quads, powers: torch.Tensor, lr: torch.Tensor, b1: float,
            b2: float, eps: float, device: torch.device) -> None:
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f'the Adam kernel takes a float32 scalar learning '
                         f'rate, not {lr.dtype} {tuple(lr.shape)}')
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('adam: build() must run before a CUDA graph '
                           'capture')
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for dtype in MOMENT_DTYPES:
            bf16 = dtype == torch.bfloat16
            group = [q for q in quads if q[1].dtype == dtype]
            for table in _cached_tables(group):
                err = lib.adam_update_table(
                    ctypes.byref(table), powers.data_ptr(), lr.data_ptr(),
                    b1, b2, eps, int(bf16), stream)
                if err != 0:
                    msg = lib.adam_error_string(err).decode()
                    raise RuntimeError(
                        f'adam launch failed: CUDA error {err} ({msg}) '
                        f'over {table.n_leaves} leaves, {table.chunks} '
                        f'chunks')
                kernels.count('adam_bf16' if bf16 else 'adam')


def _update(params, grads, state: AdamState, b1: float, b2: float,
            kernel: bool) -> AdamState:
    quads, device = _quads(params, grads, state)
    if kernel and device.type not in ('cpu', 'cuda'):
        raise ValueError(f'adam_update runs on CUDA or CPU, not {device}')
    with torch.no_grad():
        count = state.count + 1
        if kernel and device.type == 'cuda':
            _kernel(quads, _powers(count, b1, b2), state.learning_rate,
                    b1, b2, state.eps, device)
        else:
            _plain(quads, _scalars(count, state.learning_rate, b1, b2),
                   b1, b2, state.eps)
    return state._replace(count=count)


def adam_update(params, grads, state: AdamState, b1: float = 0.9,
                b2: float = 0.999) -> AdamState:
    """One Adam step, in place on `params`' leaves and the state's moments;
    returns the state with the new count. `grads` is in the params layout.
    CUDA tensors launch the kernel once per TABLE_CAPACITY leaves, CPU
    tensors run `adam_update_plain`; every leaf must be contiguous, of its
    parameter's shape and on one device with the state, params and grads
    float32, each leaf's moments float32 or bfloat16."""
    return _update(params, grads, state, b1, b2, kernel=True)


def adam_update_plain(params, grads, state: AdamState, b1: float = 0.9,
                      b2: float = 0.999) -> AdamState:
    """`adam_update`'s arithmetic in plain PyTorch, in the same order, on
    any device: each product, sum, quotient and square root rounds on its
    own, as in the kernel."""
    return _update(params, grads, state, b1, b2, kernel=False)

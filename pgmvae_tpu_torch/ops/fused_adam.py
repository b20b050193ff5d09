"""Single-pass Adam update as a CUDA kernel — the counterpart of
`pgmvae_tpu/ops/fused_adam.py`.

Per parameter leaf, in one pass over memory and in place:

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + (1-b2)*g^2
    p'   = p + (-lr * (mu'/(1-b1^t)) / (sqrt(nu'/(1-b2^t)) + eps))

the arithmetic of `optax.inject_hyperparams(optax.adam)` followed by
`optax.apply_updates` (eps_root=0), with the step count t, the bias
corrections and the learning rate kept on the device.

`adam_update(params, grads, state)` launches the kernel in `csrc/adam.cu`
(design and bound are noted there) once per leaf for CUDA tensors, runs
`adam_update_plain` (the same arithmetic in the same order in plain
PyTorch) for CPU tensors, and raises for any other device. Both write the
new params and moments into the tensors they are given: a caller that must
keep the old values copies them first.

The moments are float32, or bfloat16 (`adam_init(..., moment_dtype=
torch.bfloat16)`, adam_impl 'fused_bf16'): then the kernel's bfloat16
variant runs, which computes in float32 from the widened moments and rounds
only the stored m' and v' to nearest even, as the JAX package's 'xla_bf16'
update does. `LAUNCHES` and `LAUNCHES_BF16` count the two variants'
launches.

The kernel's library is built with `-fmad=false`, so on the card it is
bit-equal to `adam_update_plain` on the same inputs.

The update is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()` (the capture stream under
`torch.cuda.graph`), takes the step count, bias corrections and learning
rate from device tensors (so a replay reads the count the last replay
left), allocates only through the caching allocator, and the C entry
point's only runtime call besides the launch is `cudaGetLastError`. The
library must be built before a capture (the graphs' eager warm-up step
does it); a first build during a capture raises. A capture counts its
launches once, and `graphs.StepGraph` adds them again for every replay.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pgmvae_tpu_torch.models.vqvae import map_params, param_leaves
from pgmvae_tpu_torch.ops import _build

LAUNCHES = 0
LAUNCHES_BF16 = 0
MOMENT_DTYPES = (torch.float32, torch.bfloat16)

_SRC = Path(__file__).resolve().parent / 'csrc' / 'adam.cu'
_FLAGS = ('-O3', '-fmad=false')
_lib = None


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
    lib.adam_update.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    lib.adam_update.restype = ctypes.c_int
    lib.adam_update_bf16.argtypes = lib.adam_update.argtypes
    lib.adam_update_bf16.restype = ctypes.c_int
    lib.adam_error_string.argtypes = [ctypes.c_int]
    lib.adam_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def adam_init(params, learning_rate: float, eps: float = 1e-7,
              moment_dtype: torch.dtype = torch.float32) -> AdamState:
    """Zero moments of `moment_dtype` (float32, or bfloat16 for adam_impl
    'fused_bf16') in the params layout, count 0, on the params' device."""
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f'Adam moments are float32 or bfloat16, not '
                         f'{moment_dtype}')
    device = param_leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)

    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mu=map_params(zeros, params),
        nu=map_params(zeros, params),
        learning_rate=torch.tensor(learning_rate, dtype=torch.float32,
                                   device=device),
        eps=float(np.float32(eps)))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _scalars(count: torch.Tensor, lr: torch.Tensor, b1: float,
             b2: float) -> torch.Tensor:
    """[bc1, bc2, lr] float32 on the device: bc = 1 - b**count in float32,
    computed there from the count so that a step needs no host read."""
    t = count.to(torch.float32)
    return torch.stack([1.0 - torch.pow(_f32(b1), t),
                        1.0 - torch.pow(_f32(b2), t), lr])


def _quads(params, grads, state: AdamState):
    """(p, m, v, g) per leaf, after the checks the kernel relies on; and
    the one device they all lie on."""
    leaves = [param_leaves(t) for t in (params, state.mu, state.nu, grads)]
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


def _kernel(quads, scalars, b1: float, b2: float, eps: float,
            device: torch.device) -> None:
    global LAUNCHES, LAUNCHES_BF16
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('adam: build() must run before a CUDA graph '
                           'capture')
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for p, m, v, g in quads:
            if p.numel() == 0:
                continue
            bf16 = m.dtype == torch.bfloat16
            fn = lib.adam_update_bf16 if bf16 else lib.adam_update
            err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                     scalars.data_ptr(), p.numel(), b1, b2, eps, stream)
            if err != 0:
                msg = lib.adam_error_string(err).decode()
                raise RuntimeError(f'adam launch failed: CUDA error {err} '
                                   f'({msg}) at shape {tuple(p.shape)}')
            if bf16:
                LAUNCHES_BF16 += 1
            else:
                LAUNCHES += 1


def _update(params, grads, state: AdamState, b1: float, b2: float,
            kernel: bool) -> AdamState:
    quads, device = _quads(params, grads, state)
    if kernel and device.type not in ('cpu', 'cuda'):
        raise ValueError(f'adam_update runs on CUDA or CPU, not {device}')
    with torch.no_grad():
        count = state.count + 1
        scalars = _scalars(count, state.learning_rate, b1, b2)
        if kernel and device.type == 'cuda':
            _kernel(quads, scalars, b1, b2, state.eps, device)
        else:
            _plain(quads, scalars, b1, b2, state.eps)
    return state._replace(count=count)


def adam_update(params, grads, state: AdamState, b1: float = 0.9,
                b2: float = 0.999) -> AdamState:
    """One Adam step, in place on `params`' leaves and the state's moments;
    returns the state with the new count. `grads` is in the params layout.
    CUDA tensors launch the kernel once per leaf, CPU tensors run
    `adam_update_plain`; every leaf must be contiguous, of its parameter's
    shape and on one device with the state, params and grads float32, each
    leaf's moments float32 or bfloat16."""
    return _update(params, grads, state, b1, b2, kernel=True)


def adam_update_plain(params, grads, state: AdamState, b1: float = 0.9,
                      b2: float = 0.999) -> AdamState:
    """`adam_update`'s arithmetic in plain PyTorch, in the same order, on
    any device: each product, sum, quotient and square root rounds on its
    own, as in the kernel."""
    return _update(params, grads, state, b1, b2, kernel=False)

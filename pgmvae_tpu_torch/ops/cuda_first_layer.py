"""The masked first encoder layer as one CUDA kernel over the shared rows.

`first_layer(w0, b0, y, seeds, lo, n_active)` returns the first encoder
layer's pre-activation [S * F, B, O] of every network: the bias plus the
product of the rows y with the network's weights, its own variable's input
(global column lo + v of network v) and `loo_mask`'s padding (columns and
networks >= n_active) left out. Unpacked, y is [B, N] and w0 [F, N, O];
packed (`seeds` = S), y is [S, B, N] and w0 [S * F, N, O], seed by seed.
`first_layer_plain` is the same function as the masked path computed it
before the kernel: the [F, B, N] masked input and one `baddbmm`.

On a float32 CUDA tensor an autograd Function launches the kernel in
`csrc/first_layer.cu` (design and bound are noted there), which never
builds the [n, B, n] masked input; anything it does not take raises. Its
backward keeps nothing of that size either: the weight gradient is the
shared rows' transpose (expanded, stride 0) times the output's gradient,
one batched product a seed straight into the [F, N, O] layout, with each
network's own row lo + v (and the padding) set to an exact zero, as the
masked input gave it; the bias gradient is the output's gradient summed
over the rows; y's gradient only where asked. On a CPU tensor
`first_layer` returns `first_layer_plain`, which autograd differentiates
itself.

The kernel sums each output in float32 in its own order, so it differs from
the plain version's `baddbmm` only by the order of rounding.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C entry point, at first use, by `ops/_build.py`, and bound with
ctypes. `plan(B)` chooses the tile; the C entry point checks it. The
launches count as 'first_layer' (`kernels.count`), one a call.

The wrapper is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()`, reads nothing back to the host,
and its output comes from the caching allocator. The library must be built
before a capture (the graphs' eager warm-up step does it); a first build
during a capture raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.ops import _build, kernels

_SRC = Path(__file__).resolve().parent / 'csrc' / 'first_layer.cu'
_FLAGS = ('-O3',)
_lib = None


def library_path() -> Path:
    """Where `build` puts the compiled library for this source and flags."""
    return _build.library_path('first_layer', _SRC,
                               _build.BASE_FLAGS + _FLAGS)


def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel's library; see
    `_build.build`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.build('first_layer', _SRC, _FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.first_layer_fwd.argtypes = [vp] * 4 + [ci] * 10 + [vp]
    lib.first_layer_fwd.restype = ci
    lib.first_layer_error_string.argtypes = [ci]
    lib.first_layer_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


kernels.register(build, 'first_layer')


class Plan(NamedTuple):
    """One launch: tile `inst` of the kernel (`csrc/first_layer.cu`
    SHAPES), `bm` rows by `bn` flattened output columns a block."""
    inst: int
    bm: int
    bn: int


# (rows, columns) of each tile, in the kernel's order
INSTANCES = ((128, 128), (64, 128), (32, 128), (8, 128))


@functools.lru_cache(maxsize=1024)
def plan(b: int) -> Plan:
    """The tile for b rows (pure: the CPU tests check it): the smallest
    whose rows hold b, the 128-row one past 64 rows. Raises ValueError on
    an empty batch."""
    if b < 1:
        raise ValueError(f'{b} rows')
    for inst in range(len(INSTANCES) - 1, 0, -1):
        if b <= INSTANCES[inst][0]:
            return Plan(inst, *INSTANCES[inst])
    return Plan(0, *INSTANCES[0])


# ------------------------------------------------------------- plain --

def _layout(w0, y, seeds):
    """(S, F, B, N, O) of a call."""
    s = seeds or 1
    return s, w0.shape[0] // s, y.shape[-2], y.shape[-1], w0.shape[-1]


def first_layer_mask(w0, y, seeds=None, lo: int = 0,
                     n_active: Optional[int] = None):
    """`loo_mask` of a seed's networks lo .. lo + F - 1: [F, 1, N]."""
    _, f, _, n, _ = _layout(w0, y, seeds)
    return vqvae.loo_mask(n, torch.arange(lo, lo + f, device=y.device),
                          y.dtype, n_active=n_active)


def first_layer_plain(w0, b0, y, seeds=None, lo: int = 0,
                      n_active: Optional[int] = None):
    """The kernel's function in plain PyTorch, as the masked path computed
    it: the [S * F, B, N] masked input, then `baddbmm(b0, x, w0)`."""
    mask = first_layer_mask(w0, y, seeds, lo, n_active)
    if seeds is not None:
        x = (y[:, None] * mask).flatten(0, 1)
    else:
        x = y[None] * mask
    return torch.baddbmm(b0, x, w0)


# ------------------------------------------------------------ kernel --

def _check(w0, b0, y, seeds, lo: int, n_active: int) -> None:
    """Shapes, types, devices and layout `first_layer` takes, checked on
    every device before anything runs; the kernel's on CUDA."""
    s = seeds or 1
    if w0.dim() != 3 or y.dim() != (2 if seeds is None else 3):
        raise ValueError(f'w0 must be [S * F, N, O] and y [B, N] (packed '
                         f'[S, B, N]); got {tuple(w0.shape)} and '
                         f'{tuple(y.shape)} of {s} seed(s)')
    _, f, _, n, o = _layout(w0, y, seeds)
    if (w0.shape[0] % s or w0.shape[1] != n
            or (seeds is not None and y.shape[0] != s)):
        raise ValueError(f'w0 {tuple(w0.shape)} does not match y '
                         f'{tuple(y.shape)} of {s} seed(s)')
    if tuple(b0.shape) != (s * f, 1, o):
        raise ValueError(f'b0 {tuple(b0.shape)} does not match w0 '
                         f'{tuple(w0.shape)}')
    if not (lo >= 0 and 1 <= n_active <= n and lo + f <= n):
        raise ValueError(f'networks {lo} .. {lo + f - 1} of n_active '
                         f'{n_active} do not fit {n} columns')
    tensors = (w0, b0, y)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f'the first layer\'s tensors lie on '
                         f'{sorted({str(t.device) for t in tensors})}')
    if w0.device.type == 'cuda':
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError(f'the kernel takes float32; got '
                             f'{[str(t.dtype) for t in tensors]}')
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError('the kernel takes contiguous tensors')
    elif w0.device.type != 'cpu':
        raise ValueError(f'the first layer runs on CUDA or CPU, not '
                         f'{w0.device}')


def _library() -> ctypes.CDLL:
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('first_layer: build() must run before a CUDA '
                           'graph capture')
    return build()


def _forward_kernel(w0, b0, y, seeds, lo: int, n_active: int):
    """out [S * F, B, O] from one launch of the kernel."""
    s, f, b, n, o = _layout(w0, y, seeds)
    p = plan(b)
    out = torch.empty((s * f, b, o), dtype=torch.float32, device=w0.device)
    lib = _library()
    with torch.cuda.device(w0.device):
        err = lib.first_layer_fwd(
            y.data_ptr(), w0.data_ptr(), b0.data_ptr(), out.data_ptr(), s,
            b, n, o, f, lo, n_active, *p,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.first_layer_error_string(err).decode()
        raise RuntimeError(f'first_layer launch failed: CUDA error {err} '
                           f'({msg}) at shape {(s, f, b, n, o)}')
    kernels.count('first_layer')
    return out


def _weight_grad(y, g, seeds, lo: int, n_active: int):
    """dW [S * F, N, O] = y^T g network by network, the shared rows'
    transpose expanded over the networks (stride 0), one batched product a
    seed into the [F, N, O] layout; each network's own row lo + v, and
    the padding, an exact zero."""
    s, fo, n = seeds or 1, g.shape[0], y.shape[-1]
    f, b, o = fo // s, g.shape[1], g.shape[2]
    gw = torch.empty((fo, n, o), dtype=g.dtype, device=g.device)
    rows = y.view(s, b, n)
    for i in range(s):
        part = slice(i * f, (i + 1) * f)
        torch.matmul(rows[i].t().expand(f, n, b), g[part], out=gw[part])
    nets = gw.view(s, f, n, o)
    nets.diagonal(offset=lo, dim1=1, dim2=2).zero_()
    if n_active < n:
        nets[:, :, n_active:].zero_()
        nets[:, max(0, n_active - lo):].zero_()
    return gw


class _FirstLayer(torch.autograd.Function):
    """The layer of float32 CUDA tensors by the kernel; see the module
    doc for its backward."""

    @staticmethod
    def forward(ctx, w0, b0, y, seeds, lo, n_active):
        ctx.save_for_backward(y, w0 if ctx.needs_input_grad[2] else None)
        ctx.layout = (seeds, lo, n_active)
        return _forward_kernel(w0, b0, y, seeds, lo, n_active)

    @staticmethod
    def backward(ctx, g):
        y, w0 = ctx.saved_tensors
        seeds, lo, n_active = ctx.layout
        gw = gb = gy = None
        if ctx.needs_input_grad[0]:
            gw = _weight_grad(y, g, seeds, lo, n_active)
        if ctx.needs_input_grad[1]:
            gb = g.sum(1, keepdim=True)
        if ctx.needs_input_grad[2]:
            s = seeds or 1
            mask = first_layer_mask(w0, y, seeds, lo, n_active)
            wm = w0.view(s, -1, *w0.shape[1:]) * mask.transpose(1, 2)
            gy = torch.einsum('sfbo,sfio->sbi',
                              g.view(s, -1, *g.shape[1:]), wm).view(y.shape)
        return gw, gb, gy, None, None, None


def first_layer(w0: torch.Tensor, b0: torch.Tensor, y: torch.Tensor,
                seeds: Optional[int] = None, lo: int = 0,
                n_active: Optional[int] = None) -> torch.Tensor:
    """The masked first layer's pre-activation (see the module doc): the
    kernel on CUDA, `first_layer_plain` on the CPU; differentiable in w0,
    b0 and y."""
    n_active = y.shape[-1] if n_active is None else int(n_active)
    _check(w0, b0, y, seeds, int(lo), n_active)
    if w0.device.type == 'cpu':
        return first_layer_plain(w0, b0, y, seeds, int(lo), n_active)
    if not (torch.is_grad_enabled() and (
            w0.requires_grad or b0.requires_grad or y.requires_grad)):
        return _forward_kernel(w0, b0, y, seeds, int(lo), n_active)
    return _FirstLayer.apply(w0, b0, y, seeds, int(lo), n_active)

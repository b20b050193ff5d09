"""The reconstruction tail of a training step as one CUDA kernel pair.

`recon_loss(logits, y, w, seeds, lo, n_active, wsum)` takes the decoder's
last pre-activation [F, B, N] (before its sigmoid) and returns (mse, mae):
each network's leave-one-out reconstruction error, masked and weighted, as
`recon_loss_plain` computes it (the sigmoid, `recon_error`,
`masked_recon_mean`), with mse differentiable in the logits and mae not.
Unpacked, y is [B, N] and both are 0-dim; packed (`seeds` = S), y is
[S, B, N], the logits [S * fps, B, N] and both are [S], one a seed. A mesh
rank passes its networks' first global index `lo`, and the global batch's
weight sum `wsum`; `n_active` is the model's count of real variables
(`loo_mask`'s). In bfloat16 logits the composition's roundings are kept:
r, e and e^2 in bfloat16 against y in bfloat16, the MAE against the
float32 y, the mask, weights and sums in float32.

On a CUDA tensor an autograd Function launches the kernels in
`csrc/recon_loss.cu` (design and bound are noted there): the forward once,
the backward once, and neither builds the [n, B, n] mask, error or square;
anything it does not take raises. On a CPU tensor `recon_loss` returns
`recon_loss_plain`, which autograd differentiates itself.

The kernels sum in float64 partials combined in a fixed order, so their
sums differ from the plain version's float32 ones only by the order of
rounding; the gradient's elements are the plain version's arithmetic on
the card, operation by operation (in bfloat16 PyTorch's sigmoid backward
rounds each of its three operations there, once on the CPU: the kernel
follows the card).

The kernels are compiled with nvcc for sm_90a into a shared library with
plain C entry points, at first use, by `ops/_build.py`, and bound with
ctypes. `plan(F, B, N, S)` chooses the launch; the C entry points check it.
The launches count as 'recon' (`kernels.count`): two a training step.

The wrapper is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()`, reads nothing back to the host,
and its outputs and scratch (the blocks' partials and a ticket, which
the C entry point zeroes by a memset on the stream) come from the caching
allocator. The library must be built before a
capture (the graphs' eager warm-up step does it); a first build during a
capture raises. A capture counts its launches once, and
`graphs.StepGraph` adds them again for every replay.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.ops import _build, kernels

_SRC = Path(__file__).resolve().parent / 'csrc' / 'recon_loss.cu'
_FLAGS = ('-O3',)
_lib = None


def library_path() -> Path:
    """Where `build` puts the compiled library for this source and flags."""
    return _build.library_path('recon_loss', _SRC,
                               _build.BASE_FLAGS + _FLAGS)


def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernels' library; see
    `_build.build`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.build('recon_loss', _SRC, _FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.recon_loss_fwd.argtypes = ([vp, ci] + [vp] * 8 + [ci] * 9 + [vp])
    lib.recon_loss_fwd.restype = ci
    lib.recon_loss_bwd.argtypes = ([vp, ci, vp, vp, vp, ci, vp, vp]
                                   + [ci] * 9 + [vp])
    lib.recon_loss_bwd.restype = ci
    lib.recon_loss_error_string.argtypes = [ci]
    lib.recon_loss_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


kernels.register(build, 'recon')


SMS = 132                 # streaming multiprocessors of an H100 SXM
THREADS = 256             # threads a block (csrc/recon_loss.cu MAX_THREADS)
WARPS = THREADS // 32
RESIDENT_WARPS = 64       # an SM's warps at full occupancy
WAVES = 4                 # rows a warp grow past this many full waves


class Plan(NamedTuple):
    """One launch of either kernel: blocks of `threads` threads, `rpw`
    consecutive rows of one seed a warp, `bps` blocks a seed (grid: bps by
    S)."""
    threads: int
    rpw: int
    bps: int

    @property
    def args(self):
        """The C entry points' plan arguments, in their order."""
        return (self.threads, self.rpw, self.bps)


@functools.lru_cache(maxsize=1024)
def plan(f: int, b: int, n: int, s: int = 1) -> Plan:
    """The launch for logits [f, b, n] of s seeds (pure: the CPU tests
    check it): a warp a row until the rows pass WAVES full waves of
    resident warps, then as many rows a warp as keep them to that. Raises
    ValueError on what the kernels do not take."""
    if min(f, b, n, s) < 1 or f % s:
        raise ValueError(f'shape {(f, b, n)} of {s} seeds')
    if f * b >= 2 ** 31 or s > 65535:
        raise ValueError(f'shape {(f, b, n)} of {s} seeds is past the '
                         f'kernels\' grid')
    rows = f // s * b
    rpw = max(1, -(-f * b // (SMS * RESIDENT_WARPS * WAVES)))
    return Plan(THREADS, rpw, -(-rows // (WARPS * rpw)))


# ------------------------------------------------------------- plain --

def masked_recon_mean(x, w, mask, n_active=None, wsum=None):
    """Mean over a [n, B, n] tensor with per-sample weights w [B] and the
    leave-one-out mask [n, 1, n]: denominator n*(n-1)*sum(w), the mean over
    the reference's gathered [n, B, n-1] views. A packed [S, n, B, n] tensor
    gives one mean per seed, [S]. A mesh rank passes its networks' mask rows,
    the global n (n_active) and the global batch's `wsum`: its share of the
    global mean."""
    n = n_active if n_active is not None else x.shape[-3]
    x = x * mask * w[None, :, None]
    total = torch.sum(x) if x.dim() == 3 else torch.sum(x, (1, 2, 3))
    return total / _denominator(n, w, wsum)


def _denominator(n: int, w, wsum):
    return n * (n - 1) * torch.clamp(
        torch.sum(w) if wsum is None else wsum, min=1.0)


def recon_error(recon, y, seeds=None):
    """recon - y for every network: [n, B, n_var], or packed [S, n, B,
    n_var] from recon [S * n, B, n_var] and y [S, B, n_var]."""
    if seeds is None:
        return recon - y[None]
    return recon.view(seeds, -1, *recon.shape[1:]) - y[:, None]


def _mask(logits, seeds, lo: int, n_active: int, dtype):
    """The leave-one-out mask of a seed's networks lo .. lo + fps - 1."""
    fps = logits.shape[0] // (seeds or 1)
    n = logits.shape[-1]
    return vqvae.loo_mask(
        n, torch.arange(lo, lo + fps, device=logits.device), dtype,
        n_active=n_active)


def recon_loss_plain(logits, y, w, seeds=None, lo: int = 0,
                     n_active: Optional[int] = None, wsum=None):
    """The kernels' function in plain PyTorch: (mse, mae) of
    `torch.sigmoid(logits)` against y, with the float32 mask and weights
    (the composition the training step differentiated before the kernel);
    differentiable in the logits where autograd records."""
    n_active = logits.shape[-1] if n_active is None else n_active
    recon = torch.sigmoid(logits)
    mask = _mask(logits, seeds, lo, n_active, y.dtype)
    mse = masked_recon_mean(
        recon_error(recon, y.to(logits.dtype), seeds) ** 2, w, mask,
        n_active, wsum)
    mae = masked_recon_mean(
        torch.abs(recon_error(recon.detach(), y, seeds)), w, mask,
        n_active, wsum)
    return mse, mae.detach()


# ------------------------------------------------------------ kernel --

def _check(logits, y, w, seeds, lo: int, n_active: int, wsum) -> None:
    """Shapes, types, devices and layout `recon_loss` takes, checked on
    every device before anything runs; the kernels' types on CUDA."""
    if logits.dim() != 3:
        raise ValueError(f'the logits must be [F, B, N]; got '
                         f'{tuple(logits.shape)}')
    f, b, n = logits.shape
    s = seeds or 1
    want = (b, n) if seeds is None else (s, b, n)
    if f % s or tuple(y.shape) != want:
        raise ValueError(f'y {tuple(y.shape)} does not match the logits '
                         f'{tuple(logits.shape)} of {s} seed(s)')
    if tuple(w.shape) != (b,):
        raise ValueError(f'weights {tuple(w.shape)} do not match the '
                         f'logits {tuple(logits.shape)}')
    if wsum is not None and wsum.numel() != 1:
        raise ValueError(f'wsum must hold one value; got '
                         f'{tuple(wsum.shape)}')
    if not (lo >= 0 and 1 <= n_active <= n and lo + f // s <= n):
        raise ValueError(f'networks {lo} .. {lo + f // s - 1} of n_active '
                         f'{n_active} do not fit {n} columns')
    tensors = [logits, y, w] + ([] if wsum is None else [wsum])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f'the reconstruction loss\'s tensors lie on '
                         f'{sorted({str(t.device) for t in tensors})}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('the reconstruction loss takes contiguous tensors')
    if logits.device.type == 'cuda':
        if logits.dtype not in (torch.float32, torch.bfloat16) or any(
                t.dtype != torch.float32 for t in tensors[1:]):
            raise ValueError(
                f'the kernels take float32 or bfloat16 logits and float32 '
                f'y, weights and wsum; got '
                f'{[str(t.dtype) for t in tensors]}')
    elif logits.device.type != 'cpu':
        raise ValueError(f'the reconstruction loss runs on CUDA or CPU, '
                         f'not {logits.device}')


def _library() -> ctypes.CDLL:
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('recon_loss: build() must run before a CUDA '
                           'graph capture')
    return build()


def _raise_on(lib, err: int, which: str, shape) -> None:
    if err != 0:
        msg = lib.recon_loss_error_string(err).decode()
        raise RuntimeError(f'recon_loss_{which} launch failed: CUDA error '
                           f'{err} ({msg}) at shape {shape}')


def _forward_kernel(logits, y, w, seeds, lo, n_active, wsum):
    """(mse, mae, denom) from one launch of the forward kernel."""
    f, b, n = logits.shape
    s = seeds or 1
    p = plan(f, b, n, s)
    dev = logits.device
    out = () if seeds is None else (s,)
    mse = torch.empty(out, dtype=torch.float32, device=dev)
    mae = torch.empty(out, dtype=torch.float32, device=dev)
    denom = torch.empty((), dtype=torch.float32, device=dev)
    partial = torch.empty(2 * s * p.bps, dtype=torch.float64, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.recon_loss_fwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            y.data_ptr(), w.data_ptr(),
            None if wsum is None else wsum.data_ptr(), partial.data_ptr(),
            ticket.data_ptr(), mse.data_ptr(), mae.data_ptr(),
            denom.data_ptr(), f, b, n, s, lo, n_active, *p.args,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, 'fwd', (f, b, n, s))
    kernels.count('recon')
    return mse, mae, denom


def _backward_kernel(g, logits, y, w, seeds, lo, n_active, denom):
    """The logits' gradient from one launch of the backward kernel."""
    f, b, n = logits.shape
    s = seeds or 1
    p = plan(f, b, n, s)
    g = g.float()
    if g.dim() and g.stride(0) not in (0, 1):
        g = g.contiguous()
    grad = torch.empty_like(logits)
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.recon_loss_bwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            y.data_ptr(), w.data_ptr(), g.data_ptr(),
            g.stride(0) if g.dim() else 0, denom.data_ptr(),
            grad.data_ptr(), f, b, n, s, lo, n_active, *p.args,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, 'bwd', (f, b, n, s))
    kernels.count('recon')
    return grad


class _ReconLoss(torch.autograd.Function):
    """(mse, mae) of CUDA logits by the kernel pair; mse differentiable."""

    @staticmethod
    def forward(ctx, logits, y, w, wsum, seeds, lo, n_active):
        mse, mae, denom = _forward_kernel(logits, y, w, seeds, lo, n_active,
                                          wsum)
        ctx.save_for_backward(logits, y, w, denom)
        ctx.layout = (seeds, lo, n_active)
        ctx.mark_non_differentiable(mae)
        return mse, mae

    @staticmethod
    def backward(ctx, g, _):
        if g is None:
            return (None,) * 7
        logits, y, w, denom = ctx.saved_tensors
        grad = _backward_kernel(g, logits, y, w, *ctx.layout, denom)
        return grad, None, None, None, None, None, None


def recon_loss(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               seeds: Optional[int] = None, lo: int = 0,
               n_active: Optional[int] = None,
               wsum: Optional[torch.Tensor] = None):
    """(mse, mae) of `torch.sigmoid(logits)` against y (see the module
    doc): the kernel pair on CUDA, `recon_loss_plain` on the CPU; mse is
    differentiable in the logits, mae is not."""
    n_active = logits.shape[-1] if n_active is None else int(n_active)
    _check(logits, y, w, seeds, int(lo), n_active, wsum)
    if logits.device.type == 'cpu':
        return recon_loss_plain(logits, y, w, seeds, int(lo), n_active, wsum)
    return _ReconLoss.apply(logits, y, w, wsum, seeds, int(lo), n_active)

"""Fused nearest-codebook search as a CUDA kernel — the counterpart of
`pgmvae_tpu/ops/pallas_vq.py`.

`vq_codes_fused(z, codebook)` returns argmin_k (|W_k|^2 - 2 z.W_k) as int32
[n, B] without building the [n, B, K] score tensor. On a CUDA tensor it
launches the kernel in `csrc/vq_argmin.cu` (design and bound are noted
there) or raises; on a CPU tensor it returns `vq_codes_plain`, the same
arithmetic in plain PyTorch.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C entry point, at first use, by `ops/_build.py`, and bound with
ctypes.

`LAUNCHES` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from pgmvae_tpu_torch.ops import _build

LAUNCHES = 0
MAX_D = 128     # widest latent the kernel takes (csrc/vq_argmin.cu)

_SRC = Path(__file__).resolve().parent / 'csrc' / 'vq_argmin.cu'
_FLAGS = ('-O3',)
_lib = None


def library_path() -> Path:
    """Where `build` puts the compiled library for this source and flags."""
    return _build.library_path('vq_argmin', _SRC, _build.BASE_FLAGS + _FLAGS)


def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel's library; see
    `_build.build`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.build('vq_argmin', _SRC, _FLAGS)
    lib.vq_argmin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.vq_argmin.restype = ctypes.c_int
    lib.vq_argmin_error_string.argtypes = [ctypes.c_int]
    lib.vq_argmin_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.dim() != 3 or codebook.dim() != 3:
        raise ValueError(f'z must be [n, B, D] and codebook [n, D, K]; got '
                         f'{tuple(z.shape)} and {tuple(codebook.shape)}')
    if z.shape[0] != codebook.shape[0] or z.shape[2] != codebook.shape[1]:
        raise ValueError(f'z {tuple(z.shape)} does not match codebook '
                         f'{tuple(codebook.shape)}')
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise ValueError(f'vq codes take float32; got {z.dtype} and '
                         f'{codebook.dtype}')
    if z.device != codebook.device:
        raise ValueError(f'z on {z.device} but codebook on {codebook.device}')
    if codebook.shape[2] < 1:
        raise ValueError('codebook has no codes (K = 0)')


def vq_codes_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: argmin over the [n, B, K]
    scores |W_k|^2 - 2 z.W_k (first index on ties), int32 [n, B]."""
    w2 = torch.sum(codebook * codebook, dim=1, keepdim=True)         # [n,1,K]
    scores = w2 - 2.0 * torch.bmm(z, codebook)                       # [n,B,K]
    return torch.argmin(scores, dim=2).to(torch.int32)


def vq_codes_fused(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices [n, B] int32. z [n, B, D] and codebook
    [n, D, K] float32 on one device: CUDA launches the kernel, CPU runs
    `vq_codes_plain`; any other device raises."""
    global LAUNCHES
    _check(z, codebook)
    if z.device.type == 'cpu':
        return vq_codes_plain(z, codebook)
    if z.device.type != 'cuda':
        raise ValueError(f'vq_codes_fused runs on CUDA or CPU, not {z.device}')
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError('the vq_argmin kernel takes contiguous z and codebook')
    n, b, d = z.shape
    k = codebook.shape[2]
    if d > MAX_D:
        raise ValueError(f'the vq_argmin kernel takes D <= {MAX_D}, got {d}')
    if n >= 2 ** 31 or k >= 2 ** 31 or b > 128 * 65535:
        raise ValueError(f'shape {(n, b, d, k)} is past the kernel\'s grid')
    out = torch.empty((n, b), dtype=torch.int32, device=z.device)
    if n == 0 or b == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.vq_argmin(z.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                        n, b, d, k, z.device.index, stream)
    if err != 0:
        msg = lib.vq_argmin_error_string(err).decode()
        raise RuntimeError(f'vq_argmin launch failed: CUDA error {err} '
                           f'({msg}) at shape {(n, b, d, k)}')
    LAUNCHES += 1
    return out

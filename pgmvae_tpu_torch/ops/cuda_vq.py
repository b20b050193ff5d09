"""Fused nearest-codebook search as a CUDA kernel — the counterpart of
`pgmvae_tpu/ops/pallas_vq.py`.

`vq_codes_fused(z, codebook)` returns argmin_k (|W_k|^2 - 2 z.W_k) as int32
[n, B] without building the [n, B, K] score tensor. On a CUDA tensor it
launches the kernel in `csrc/vq_argmin.cu` (design and bound are noted
there) or raises; on a CPU tensor it returns `vq_codes_plain`, the same
arithmetic in plain PyTorch. z and the codebook are both float32 or both
bfloat16 (bf16 compute), and each type has a kernel of its own: float32
scores by fmaf chains on the SIMT units; bfloat16 takes z.W_k on the
tensor cores (mma.sync, exact bf16 products summed in float32), so its codes
may differ from the float32 arithmetic on the widened values only on
near-ties.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C entry point, at first use, by `ops/_build.py`, and bound with
ctypes.

`plan(n, B, D, K)` chooses the float32 launch (tile sizes, variables a
block, code strips) and `plan_bf16(n, B, D, K)` the bfloat16 one (16-row
and 8-code tensor-core tiles, code strips); the C entry points check them.
Calls that launched the float32 and the bfloat16 instance (one launch or,
when K is split into strips, two) are counted as 'vq_argmin' and
'vq_argmin_bf16' (`kernels.count`), so a run can show that its path went
through them.

The wrapper is safe to capture into a CUDA graph (`graphs.StepGraph`): it
launches on `torch.cuda.current_stream()`, which is the capture stream
under `torch.cuda.graph`; its output and split-K workspaces come from the
caching allocator, so under a capture from the graph's private pool; and
the C entry point's only runtime call besides the launch is
`cudaGetLastError`. The library must be built and its kernels loaded
before a capture (the graphs' eager warm-up step does both); a first build
during a capture raises. A capture counts its launches once, and
`graphs.StepGraph` adds them again for every replay.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from pgmvae_tpu_torch.ops import _build, kernels

DTYPES = (torch.float32, torch.bfloat16)
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
    lib.vq_argmin.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                              + [ctypes.c_void_p])
    lib.vq_argmin.restype = ctypes.c_int
    lib.vq_argmin_bf16.argtypes = lib.vq_argmin.argtypes
    lib.vq_argmin_bf16.restype = ctypes.c_int
    lib.vq_argmin_error_string.argtypes = [ctypes.c_int]
    lib.vq_argmin_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


kernels.register(build, 'vq_argmin', 'vq_argmin_bf16')


SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256         # threads a block (csrc/vq_argmin.cu)
SMEM_BYTES = 48 * 1024    # static shared-memory limit of a block
RK = 4                    # codes in a thread's register micro-tile
TX = 4                    # code lanes of a warp
ROWS = 32 // TX           # sample rows of a warp
MAX_WK = 4                # warps across a code tile
MAX_WY = 2                # warps across a sample tile
SUB = 4                   # code sub-tiles a ring tile, where they pay
STAGES = 2                # code tiles in the kernel's ring
# latents the kernel is built for exactly, with no exit in its unrolled d
# loop (the D of the registry's recipes); other D run an instance unrolled
# to D rounded up
EXACT_D = (10, 20, 30)
MIN_BLOCKS = 2 * SMS      # fewer blocks than this split K across blocks
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    """One launch of the kernel. A block holds `vpb` variables and, for
    each, a sample tile of `tb` = wy * ROWS * rb samples (wy warps) against
    ring tiles of `tk` = sub * wk * TX * RK codes: wk warps split a sub-tile
    of wk * TX * RK codes, and each scores `sub` sub-tiles a ring tile. A
    thread scores rb samples x RK codes in registers. With sub > 1 (a
    strip of two ring tiles or more) the kernel keeps each thread's minimum
    by groups of RK codes and finds the code in the winning group at the
    end; with sub = 1 it compares every score. Codes are cut into `strips`
    strips of `strip_k` codes, one block each; with more than one strip a
    second launch merges the strips' partial minima."""
    rb: int
    wy: int
    wk: int
    sub: int
    vpb: int
    strip_k: int
    strips: int
    grid: Tuple[int, int, int]    # (sample tiles, variable groups, strips)
    threads: int
    smem_bytes: int

    @property
    def tb(self) -> int:
        return self.wy * ROWS * self.rb

    @property
    def tk(self) -> int:
        return self.sub * self.wk * TX * RK

    @property
    def args(self) -> Tuple[int, ...]:
        """The C entry point's plan arguments, in its order."""
        return (self.rb, self.wy, self.wk, self.sub, self.vpb, self.strip_k,
                self.strips)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _smem_bytes(d: int, rb: int, wy: int, wk: int, vpb: int,
                sub: int = 1) -> int:
    """Shared memory of a block (csrc/vq_argmin.cu `smem_floats`): the z
    tile [vpb][d][tb + 4], a ring of STAGES code tiles [STAGES][vpb][d][tk],
    |W_k|^2 of a ring tile [vpb][tk] and the merge buffer of (value, index)
    [vpb][wk][tb]."""
    tb, tk = wy * ROWS * rb, sub * wk * TX * RK
    return 4 * vpb * (d * (tb + 4) + STAGES * d * tk + tk + 2 * wk * tb)


@functools.lru_cache(maxsize=1024)
def plan(n: int, b: int, d: int, k: int) -> Plan:
    """The launch for z [n, b, d] and codebook [n, d, k] (pure: the CPU
    tests check it). Raises ValueError on what the kernel does not take."""
    if min(n, b, d, k) < 1:
        raise ValueError(f'empty shape {(n, b, d, k)}')
    if d > MAX_D:
        raise ValueError(f'the vq_argmin kernel takes D <= {MAX_D}, got {d}')
    rb = 8 if b >= 64 and d <= 32 else 4      # past D=32, rb=8 would spill
    wk = min(MAX_WK, _pow2_at_least(-(-k // (TX * RK))))
    if k <= MAX_WK * TX * RK:     # codes in two tiles: the second loads
        wk = max(1, wk // 2)      # while the first is scored
    wy = min(MAX_WY, _pow2_at_least(-(-b // (ROWS * rb))))
    while _smem_bytes(d, rb, wy, wk, 1) > SMEM_BYTES:
        if wy > 1:
            wy //= 2
        elif wk > 1:
            wk //= 2
        else:
            rb = 4
    tks, tb = wk * TX * RK, wy * ROWS * rb
    ktiles, btiles = -(-k // tks), -(-b // tb)
    vpb = 1
    if k <= MAX_WK * TX * RK:     # few codes: pack variables into a block
        while (64 * vpb * wy * wk <= 128 and vpb < n
               and -(-n // (2 * vpb)) * btiles >= 2 * MIN_BLOCKS
               and _smem_bytes(d, rb, wy, wk, 2 * vpb) <= SMEM_BYTES):
            vpb *= 2
    blocks = -(-n // vpb) * btiles
    strips = 1
    if blocks < MIN_BLOCKS and ktiles > 1:
        strips = min(ktiles, _pow2_at_least(-(-MIN_BLOCKS // blocks)))
    codes = -(-ktiles // strips) * tks        # codes a strip
    # four sub-tiles a ring tile spread the ring's wait and barriers over
    # four times the codes, where a strip holds two such tiles or more (and
    # there the kernel's grouped minimum pays for its recomputation at the
    # end); a ring tile that would not fit takes half the code warps
    sub = 1
    if d <= 32 and codes >= 2 * SUB * tks:
        for wk_sub in (wk, wk // 2):
            if wk_sub and _smem_bytes(d, rb, wy, wk_sub, vpb,
                                      SUB) <= SMEM_BYTES:
                wk, sub, tks = wk_sub, SUB, wk_sub * TX * RK
                break
    strip_k = -(-codes // (sub * tks)) * sub * tks
    strips = -(-k // strip_k)
    grid = (btiles, -(-n // vpb), strips)
    if grid[1] > MAX_GRID_Y or grid[2] > MAX_GRID_Y or btiles >= 2 ** 31:
        raise ValueError(f'shape {(n, b, d, k)} is past the kernel\'s grid')
    return Plan(rb, wy, wk, sub, vpb, strip_k, strips, grid,
                32 * wy * wk * vpb, _smem_bytes(d, rb, wy, wk, vpb, sub))


BF16_MAX_WARPS = MAX_THREADS // 32
BF16_MAX_TK = 128         # codes a ring tile of the bfloat16 instance
BF16_PAD = 8              # bf16 pad of its code-tile rows
BF16_STAGES = 2           # code tiles in its ring
BF16_MIN_WARPS = 16 * SMS     # fewer warps than this split K across blocks


class PlanBf16(NamedTuple):
    """One launch of the bfloat16 instance. A block of wm warps holds a
    sample tile of `tb` = wm * mt * 16 rows (each warp mt 16-row
    tensor-core tiles) against ring tiles of `tk` = nt * 8 codes, which
    every warp scores 16 at a time; D is padded to `dp` = 16 * ks in the
    tensor-core operands. Codes are cut into `strips` strips of `strip_k`
    codes, one block each; with more than one strip a second launch merges
    the strips' partial minima."""
    mt: int
    wm: int
    nt: int
    ks: int
    strip_k: int
    strips: int
    grid: Tuple[int, int, int]    # (sample tiles, variables, strips)
    threads: int
    smem_bytes: int

    @property
    def tb(self) -> int:
        return self.wm * self.mt * 16

    @property
    def tk(self) -> int:
        return self.nt * 8

    @property
    def dp(self) -> int:
        return 16 * self.ks

    @property
    def args(self) -> Tuple[int, ...]:
        """The C entry point's plan arguments, in its order (the float32
        entry's places: rb, wy, wk = 1, sub, vpb = 1)."""
        return (self.mt, self.wm, 1, self.nt, 1, self.strip_k, self.strips)


def _bf16_smem_bytes(d: int, ks: int, tb: int, tk: int) -> int:
    """Shared memory of a bfloat16 block (csrc/vq_argmin.cu
    `bf16_smem_bytes`): the z tile's tb * d values (rounded up to 16 bytes)
    and a ring of BF16_STAGES code tiles [dp][tk + 8] in bf16, and
    -|W_k|^2 / 2 of a tile [tk]."""
    dp = 16 * ks
    return (-(-2 * tb * d // 16) * 16
            + BF16_STAGES * 2 * dp * (tk + BF16_PAD) + 4 * tk)


def _pow2_at_most(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def plan_bf16(n: int, b: int, d: int, k: int) -> PlanBf16:
    """The bfloat16 launch for z [n, b, d] and codebook [n, d, k] (pure:
    the CPU tests check it). Raises ValueError on what the kernel does not
    take."""
    if min(n, b, d, k) < 1:
        raise ValueError(f'empty shape {(n, b, d, k)}')
    if d > MAX_D:
        raise ValueError(f'the vq_argmin kernel takes D <= {MAX_D}, got {d}')
    ks = _pow2_at_least(-(-d // 16))          # 16-deep k-steps: 1, 2, 4, 8
    mt = 2 if b > 16 and ks <= 4 else 1       # A fragments held in registers
    wm = min(BF16_MAX_WARPS, _pow2_at_least(-(-b // (16 * mt))))
    nt = min(BF16_MAX_TK // 8, 2 * _pow2_at_least(-(-k // 16)))
    while _bf16_smem_bytes(d, ks, 16 * mt * wm, 8 * nt) > SMEM_BYTES:
        if nt > 2:
            nt //= 2
        else:
            wm //= 2
    tb, tk = 16 * mt * wm, 8 * nt
    ktiles, btiles = -(-k // tk), -(-b // tb)
    # few warps: cut K into strips of two ring tiles or more, up to
    # BF16_MIN_WARPS warps in all
    strips, warps = 1, n * btiles * wm
    if warps < BF16_MIN_WARPS and ktiles > 1:
        strips = min(ktiles // 2, _pow2_at_most(BF16_MIN_WARPS // warps))
    strip_k = -(-ktiles // strips) * tk
    strips = -(-k // strip_k)
    grid = (btiles, n, strips)
    if n > MAX_GRID_Y or strips > MAX_GRID_Y or btiles >= 2 ** 31:
        raise ValueError(f'shape {(n, b, d, k)} is past the kernel\'s grid')
    return PlanBf16(mt, wm, nt, ks, strip_k, strips, grid, 32 * wm,
                    _bf16_smem_bytes(d, ks, tb, tk))


def _check(z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.dim() != 3 or codebook.dim() != 3:
        raise ValueError(f'z must be [n, B, D] and codebook [n, D, K]; got '
                         f'{tuple(z.shape)} and {tuple(codebook.shape)}')
    if z.shape[0] != codebook.shape[0] or z.shape[2] != codebook.shape[1]:
        raise ValueError(f'z {tuple(z.shape)} does not match codebook '
                         f'{tuple(codebook.shape)}')
    if z.dtype != codebook.dtype or z.dtype not in DTYPES:
        raise ValueError(f'vq codes take float32 or bfloat16, the same for '
                         f'z and codebook; got {z.dtype} and '
                         f'{codebook.dtype}')
    if z.device != codebook.device:
        raise ValueError(f'z on {z.device} but codebook on {codebook.device}')
    if codebook.shape[2] < 1:
        raise ValueError('codebook has no codes (K = 0)')


def vq_codes_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: argmin over the [n, B, K]
    scores |W_k|^2 - 2 z.W_k (first index on ties), int32 [n, B]. bfloat16
    operands are widened to float32 first (exact), and their scores taken
    in float32 as the float32 instance's are: the bfloat16 kernel's sums
    differ from these only in order and rounding."""
    z, codebook = z.float(), codebook.float()
    w2 = torch.sum(codebook * codebook, dim=1, keepdim=True)         # [n,1,K]
    scores = w2 - 2.0 * torch.bmm(z, codebook)                       # [n,B,K]
    return torch.argmin(scores, dim=2).to(torch.int32)


def vq_codes_fused(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices [n, B] int32. z [n, B, D] and codebook
    [n, D, K], both float32 or both bfloat16, on one device: CUDA launches
    the kernel for that type (float32: `plan`; bfloat16: the tensor-core
    kernel, `plan_bf16`), CPU runs `vq_codes_plain`; any other device
    raises."""
    _check(z, codebook)
    if z.device.type == 'cpu':
        return vq_codes_plain(z, codebook)
    if z.device.type != 'cuda':
        raise ValueError(f'vq_codes_fused runs on CUDA or CPU, not {z.device}')
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError('the vq_argmin kernel takes contiguous z and codebook')
    n, b, d = z.shape
    k = codebook.shape[2]
    if max(n, b, k) >= 2 ** 31:
        raise ValueError(f'shape {(n, b, d, k)} is past the kernel\'s grid')
    out = torch.empty((n, b), dtype=torch.int32, device=z.device)
    if n == 0 or b == 0:
        return out
    bf16 = z.dtype == torch.bfloat16
    p = plan_bf16(n, b, d, k) if bf16 else plan(n, b, d, k)
    if _lib is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('vq_argmin: build() must run before a CUDA graph '
                           'capture')
    lib = build()
    fn = lib.vq_argmin_bf16 if bf16 else lib.vq_argmin
    with torch.cuda.device(z.device):
        part_v = part_i = None
        if p.strips > 1:
            part_v = torch.empty((p.strips, n, b), dtype=torch.float32,
                                 device=z.device)
            part_i = torch.empty((p.strips, n, b), dtype=torch.int32,
                                 device=z.device)
        err = fn(
            z.data_ptr(), codebook.data_ptr(), out.data_ptr(),
            None if part_v is None else part_v.data_ptr(),
            None if part_i is None else part_i.data_ptr(), n, b, d, k,
            *p.args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.vq_argmin_error_string(err).decode()
        raise RuntimeError(f'vq_argmin launch failed: CUDA error {err} '
                           f'({msg}) at shape {(n, b, d, k)}, {z.dtype}')
    kernels.count('vq_argmin_bf16' if bf16 else 'vq_argmin')
    return out

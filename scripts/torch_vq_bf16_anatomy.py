#!/usr/bin/env python3
"""Where the PyTorch port's bfloat16 nearest-code kernel spends its time
on one GPU: the kernel as it is, against a build of the same source whose
epilogue (the compare and select of each score against the running
minimum) is replaced by a plain sum of the accumulators. The second build
still loads every tile, computes |W_k|^2 and issues every mma.sync, so its
time is the kernel's floor without the epilogue; its codes are meaningless
and are not read.

    python3 scripts/torch_vq_bf16_anatomy.py

Builds both variants of `pgmvae_tpu_torch/ops/csrc/vq_argmin.cu` with nvcc
into `pgmvae_tpu_torch/_build/`, launches them through the C entry point
with `cuda_vq.plan_bf16`'s plan at the port's bf16 shapes, and times each
by `chip_smoke.device_ms` (torch.profiler device time over 20 calls).
Prints one JSON line a shape, the card's name and power limit, and the
cycles an mma.sync took a scheduler at the kernel's largest shape: the
no-epilogue time at the card's top SM clock over the HMMA the plan issues
(MT x 2 x KS a warp's 16-code group, as the kernel's SASS holds them).
Needs one CUDA device; without one it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMS, SCHEDULERS = 132, 4          # H100 SXM
# (n, B, D, K): bbc's train batch at bs 250, a large K, the kdd sweep's
# train batch alone and packed (S=4)
SHAPES = [(1058, 250, 20, 50), (1058, 256, 20, 4096), (64, 32, 10, 4096),
          (256, 32, 10, 4096)]
EPILOGUE_START = '      const int kc = k0 + c0 + 2 * t4;'
EPILOGUE_END = '  // over the quad (the 4 lanes of a row)'
SUM = '''      const int kc = k0 + c0 + 2 * t4;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) best[mi][q >> 1] += acc[mi][ni][q];
      best_k[0][0] = kc;
    }
  }

'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('torch_vq_bf16_anatomy: needs a CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    from pgmvae_tpu_torch.ops import _build, cuda_vq
    src = cuda_vq._SRC.read_text()
    a, b = src.index(EPILOGUE_START), src.index(EPILOGUE_END)
    variant = _build.BUILD_DIR / 'vq_argmin_no_epilogue.cu'
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(src[:a] + SUM + src[b:])
    libs = {}
    for name, path in (('kernel', cuda_vq._SRC), ('no_epilogue', variant)):
        lib = _build.build('vq_anatomy_' + name, path, ('-O3',))
        lib.vq_argmin_bf16.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 11
                                       + [ctypes.c_void_p])
        libs[name] = lib

    def call(lib, z, w, p):
        n, b, d = z.shape
        k = w.shape[2]
        out = torch.empty((n, b), dtype=torch.int32, device='cuda')
        part = [None, None]
        if p.strips > 1:
            part = [torch.empty((p.strips, n, b), device='cuda'),
                    torch.empty((p.strips, n, b), dtype=torch.int32,
                                device='cuda')]
        err = lib.vq_argmin_bf16(
            z.data_ptr(), w.data_ptr(), out.data_ptr(),
            *[None if t is None else t.data_ptr() for t in part],
            n, b, d, k, *p.args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'launch failed: CUDA error {err}')
        return out

    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for n, b, d, k in SHAPES:
        z = torch.randn((n, b, d), generator=gen,
                        device='cuda').to(torch.bfloat16)
        w = torch.randn((n, d, k), generator=gen,
                        device='cuda').to(torch.bfloat16)
        p = cuda_vq.plan_bf16(n, b, d, k)
        row = {'shape': [n, b, d, k], 'plan': list(p.args)}
        for name, lib in libs.items():
            row[name + '_ms'] = device_ms(lambda lib=lib: call(lib, z, w, p))
        rows.append(row)
        print(json.dumps(row), flush=True)
    # HMMA a 16-code group (MT x 2 n8 tiles x KS k-steps) at the largest
    # shape, over the no-epilogue time
    n, b, d, k = SHAPES[1]
    p = cuda_vq.plan_bf16(n, b, d, k)
    hmma = n * p.grid[0] * p.wm * -(-k // 16) * p.mt * 2 * p.ks
    clock_mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], check=True, capture_output=True,
        text=True).stdout.split()[0])
    cycles = rows[1]['no_epilogue_ms'] * 1e-3 * clock_mhz * 1e6
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({'nvidia_smi': smi, 'hmma': hmma,
                      'clock_max_mhz': clock_mhz,
                      'cycles_per_hmma_per_scheduler':
                          cycles * SMS * SCHEDULERS / hmma}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

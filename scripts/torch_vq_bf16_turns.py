#!/usr/bin/env python3
"""Time the PyTorch port's bfloat16 nearest-code kernel (`vq_codes_fused`
on bfloat16 z and codebook) of several checkouts on one GPU, in turns.

    python3 scripts/torch_vq_bf16_turns.py PARENT . . PARENT

Each argument is the root of a checkout holding `pgmvae_tpu_torch/`; each
turn runs in a process of its own that imports that checkout's package,
builds its kernel (into that checkout's `_build/`) and, at the bf16 shapes
of the port's main paths, checks the codes against `vq_codes_plain` (equal
up to float64-proven near-ties, as `chip_smoke.py` holds them) and times
the kernel by torch.profiler device time over 20 calls (the kernel and its
strip merge; where the profiler sees no device time, CUDA events around
calls queued behind a sleep). One JSON line a turn, then the card's name
and power limit, then one JSON line of each checkout's per-shape times
(every turn) and their mean. Needs one CUDA device; without one it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
CALLS = 20
NEAR_TIE_REL = 1e-5
# (n, B, D, K): bbc's train batch at bs 250, 500 and 1,000, a large K, the
# kdd sweep's train batch alone and packed (S=4), nltcs's train batch (the
# command line's bf16 run)
SHAPES = [(1058, 250, 20, 50), (1058, 500, 20, 50), (1058, 1000, 20, 50),
          (1058, 256, 20, 4096), (64, 32, 10, 4096), (256, 32, 10, 4096),
          (16, 128, 10, 50)]


def _device_ms(torch, fn) -> tuple:
    """(device ms a call, timer): the profiler's device time of `CALLS`
    warm calls, else events around calls queued behind a device sleep."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / CALLS, 'profiler'
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(1 << 26)
    marks[1].record()
    for _ in range(CALLS):
        fn()
    marks[2].record()
    marks[2].synchronize()
    return marks[1].elapsed_time(marks[2]) / CALLS, 'queued_events'


def _near_ties(torch, z, w, got, ref) -> int:
    """Mismatching codes, each proven a float64 near-tie, or raise."""
    diff = (got != ref).nonzero()
    if diff.shape[0] == 0:
        return 0
    v, b = diff[:, 0], diff[:, 1]
    zz = z[v, b].double()
    dist = ((zz[:, :, None] - w[v].double()) ** 2).sum(1)
    dmin = dist.min(1).values
    pick = dist.gather(1, got[v, b].long()[:, None])[:, 0]
    tol = NEAR_TIE_REL * torch.maximum(dmin, (zz * zz).sum(1))
    if bool((pick - dmin > tol).any()):
        raise AssertionError('code mismatches that are not near-ties')
    return int(diff.shape[0])


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from pgmvae_tpu_torch.ops import cuda_vq
    assert cuda_vq.__file__.startswith(os.path.abspath(root)), \
        cuda_vq.__file__
    t0 = time.time()
    cuda_vq.build()
    build_s = time.time() - t0
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    for n, b, d, k in SHAPES:
        z = torch.randn((n, b, d), generator=gen,
                        device='cuda').to(torch.bfloat16)
        w = torch.randn((n, d, k), generator=gen,
                        device='cuda').to(torch.bfloat16)
        got = cuda_vq.vq_codes_fused(z, w)
        ref = cuda_vq.vq_codes_plain(z, w)
        torch.cuda.synchronize()
        ms, timer = _device_ms(torch, lambda: cuda_vq.vq_codes_fused(z, w))
        rows.append({'shape': [n, b, d, k], 'device_ms': ms, 'timer': timer,
                     'near_tie_mismatches': _near_ties(torch, z, w, got,
                                                       ref)})
    return {'root': root, 'build_s': build_s, 'rows': rows}


def main(argv) -> int:
    if argv[:1] == ['--worker']:
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print('torch_vq_bf16_turns: needs a CUDA device and checkout roots',
              file=sys.stderr)
        return 1
    turns = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--worker', root], check=True,
                             capture_output=True, text=True, cwd=root)
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    summary = {}
    for root in dict.fromkeys(argv):
        mine = [t['rows'] for t in turns if t['root'] == root]
        summary[root] = {str(tuple(r['shape'])): {
            'turns_ms': [rows[i]['device_ms'] for rows in mine],
            'mean_ms': sum(rows[i]['device_ms'] for rows in mine)
            / len(mine)} for i, r in enumerate(mine[0])}
    print(json.dumps({'nvidia_smi': smi, 'by_root': summary}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

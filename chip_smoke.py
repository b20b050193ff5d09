#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pgmvae_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels (the nearest-code search, with a
bfloat16 kernel of its own on the tensor cores whose SASS must hold HMMA,
the Adam update, one launch over a table of leaves, with its
bfloat16-moment instance, the EMA codebook step, the reconstruction
tail's forward and backward pair, and the masked first encoder layer over
shared rows; one nvcc each, started together) from the sources in the
checkout, holds each kernel
against its
plain PyTorch version at the shapes of the main paths (timed by CUDA
events over back-to-back calls, `ms`, and by the profiler's device time of
the kernels alone, `device_ms`, or where the profiler sees none by events
around calls queued behind a sleep on the device), and drives the system's paths, each with the kernels' launch
counts set to 0 just before it and read just after. Train epochs, streamed
chunks and Gibbs segments run as replayed CUDA graphs (a replay counts the
launches it holds), and each graph path is held bit for bit against the
eager step loop run from the same state as the reference only. At the full
width of the bbc model: the serving slice (stage-2 CPT/PLL and PgmModel),
stage-1 training (Trainer.fit, 14 steps) and a Gibbs CMLL of the trained
model (2,100 steps, held against a chain through the plain version); at
the width of the kdd sweep (K=4096) 200 train steps, a stage-2 CPT and the
test split's PLL, a checkpoint's round trip (save, load, serve, resume)
and `driver.py`'s own CMLL (18,000 steps), the same 200 steps streamed
from the host (bit-equal to in-core) and packed with three more seeds
(S=4), the sweep runner's packed command on those seeds and rows on disk
and the same in bf16 compute (then `fit_packed` in bf16, bit-equal to its
eager loop), `run_epochs`/`run_epochs_packed` over 3 epochs (bit-equal to
`fit`/`fit_packed`) and one full kdd epoch (5,628 steps); bf16 compute at
bbc width (14 steps); then the command line end to end on nltcs-shaped
data, with a checkpoint, CMLL, a resume, bfloat16 Adam moments, bf16
compute and --profile, and the sweep runner (a packed 2x2 grid, its resume
and an isolated cell). The device mesh (`pgmvae_tpu_torch/parallel`): an
NCCL world of one on the kdd cell with its collectives in the epoch's
graph, bit-equal to the unmeshed run; `dryrun_multichip(8)` (a (4, 2) mesh
of ranks sharing the card over gloo); a (2, 4) mesh at full bbc width
against its single-device twin; the command line and an isolated sweep
cell on a (2, 2) mesh. Mesh ranks are processes of their own: their
launches come back summed over the ranks. Times taken with ranks sharing
one card are labelled so and say nothing of a multi-GPU run. And the
native CSV parser against the numpy path at kdd's train size. Last, the
measurement twins in-process: `pgmvae_tpu_torch.bench` (the nltcs
headline and the JAX `bench.py`'s eight cells at full width),
`bench_packed` at the kdd sweep's shape (S=4, one epoch) and `bench_cmll`
at its defaults, each held to its record, one graph capture per kind and
run, and the launches its steps imply. And the out-of-core twin,
`bench_streaming`, at its full 4.5 GiB (18,874,368 x 64 rows, past the
Trainer's 4 GiB `stream_bytes`): its streamed epoch (73,728 steps, the
data on the host, a device peak below half the data's bytes) held bit for
bit against an in-core fit of the same steps, and stage 2 over the whole
split, fed to the card in pinned pieces, counting every row once. Then the
command line on kdd-named CSVs whose train split is those 4.5 GiB of rows
(`cli_big`: the native parser, a streamed epoch, stage 2 in pieces, the
result line). Early on, right after the build, the sweep runner's grid
in-process (`sweep_memory`: eight kdd-shaped cells at K=64, a packed pair
and a CMLL among them), with the device memory held after each cell and a
memory snapshot of what stays live. Each phase
prints one JSON line; any failed check
raises, so the script exits non-zero. The last three lines are the kernel
summary, the card's name and power limit as nvidia-smi gives them, and
`{"ok": true, "device": {...}}`.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

SEED = 0
FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12     # H100 SXM, bf16 tensor cores (dense, f32 sums)
HBM_BYTES = 3.35e12     # H100 SXM device memory rate
NEAR_TIE_REL = 1e-5
# (n, B, D, K): the four shapes of tests/test_pallas_vq.py, the slices' own
# (a stage-2 chunk, the bbc test split served at once, a bbc train batch),
# one large K, the kdd sweep's train batch (alone and packed, S=4) and
# stage-2 chunk, and a Gibbs step's (11 blocks over bbc's test split, over
# 1,024 kdd test rows and over all 34,955; the nltcs command line's 16
# blocks over its test split), and a rank's shard of mesh_bbc's (2, 4)
# mesh (265 of 1060 networks: 125 rows of a train batch, 16 of a stage-2
# chunk). The bfloat16 instance is timed at the same shapes; its main-path
# shape is bbc's train batch (phase train_bf16).
GIBBS_SHAPES = [(11, 330, 20, 50), (11, 1024, 10, 4096),
                (11, 34955, 10, 4096), (16, 3236, 10, 50)]
KERNEL_SHAPES = [(3, 9, 5, 7), (5, 32, 8, 130), (4, 17, 10, 50),
                 (2, 64, 16, 1024), (1058, 32, 20, 50), (1058, 330, 20, 50),
                 (1058, 250, 20, 50), (1058, 256, 20, 4096),
                 (64, 32, 10, 4096), (256, 32, 10, 4096),
                 (64, 118, 10, 4096), (265, 125, 20, 50),
                 (265, 16, 20, 50)] + GIBBS_SHAPES
# the measurement twins' main-path shapes (phase bench): nltcs's train
# batch, bbc's at bs 25, ad's at bs 250 and bench_cmll's Gibbs step (13
# blocks over 5,000 rows); bf16: bbc at bs 500 and 1,000
BENCH_SHAPES = [(16, 128, 10, 50), (1058, 25, 20, 50), (1556, 250, 30, 20),
                (13, 5000, 20, 15)]
BENCH_BF16_SHAPES = [(1058, 500, 20, 50), (1058, 1000, 20, 50)]
# the command line's bf16 compute run (phase cli): nltcs's train batch
CLI_BF16_SHAPES = [(16, 128, 10, 50)]
# the bfloat16 kernel's ragged edges, checked and not timed: D = 5, 8, 30,
# 33 and 128 (padded to 16, 16, 32, 64, 128 with zeros), K = 7 and 15 (odd:
# plain loads), B not a multiple of 16, and K or D whose copies go by 4
# bytes (K or D even but not a multiple of 8)
BF16_RAGGED = [(5, 37, 5, 64), (4, 50, 8, 200), (6, 45, 30, 100),
               (3, 29, 33, 96), (2, 21, 128, 300), (13, 100, 20, 15),
               (7, 70, 10, 7), (9, 33, 12, 58)]
# z and W as views 2 bytes past an alignment (a bf16 value): every copy
# takes the plain-load path though K % 8 == 0
BF16_UNALIGNED = [(16, 40, 10, 256), (64, 32, 10, 4096)]
# the out-of-core twin's (phase stream_big): a train batch of its 64-variable
# model (K=64, D=10, bs 256) and a stage-2 chunk (auto_chunk(64, 64) rows)
STREAM_SHAPES = [(64, 256, 10, 64), (64, 1365, 10, 64)]
# phase sweep_memory's own (its cells' train batches and stage-2 chunks are
# stream_big's shapes, cli_big's too): the packed pair's train batch (S=2)
# and the CMLL's Gibbs step (p1 = 6 blocks over 1,024 test rows)
SWEEP_MEMORY_SHAPES = [(128, 256, 10, 64), (6, 1024, 10, 64)]
# the float32 kernel's ragged edges, checked and not timed: K past a
# multiple of the tile and of 4 (its 4-byte copies, the +inf tail of
# |W_k|^2), and D = 33 (an instance unrolled to 48, with its exit)
F32_RAGGED = [(11, 1000, 10, 4097), (3, 29, 33, 96)]
MAIN_SHAPE = (1058, 32, 20, 50)   # the stage-2 chunk: most main-path launches
TIE_SPLIT = (64, 32, 10, 4096)    # ties across code tiles and strips
BF16_MAIN_SHAPE = (1058, 250, 20, 50)
PROFILE_CALLS = 20                # calls averaged by device_ms
PROFILER_TRIES = 3                # profiler sessions before giving up
DEVICE_TIMER = {'profiler': 0, 'queued_events': 0}   # device_ms calls
# the nearest-code kernels' launches in a profile: float32, bfloat16, merge
VQ_NAMES = ('vq_argmin_kernel', 'vq_argmin_bf16_kernel', 'vq_merge_kernel')
# vq_argmin_bf16_kernel<KS, MT>: 16-deep k-steps, 16-row tiles a warp
BF16_INSTANCES = ('bf16_1_1', 'bf16_2_1', 'bf16_4_1', 'bf16_8_1',
                  'bf16_1_2', 'bf16_2_2', 'bf16_4_2')
# the reference's shipped sweep (batch-job.sh:43-52): kdd, K=4096, D=10,
# batch 32, lr 2e-4, cost 0.35 (the first of its four), seed 5, EMA
KDD_ROWS, KDD_BATCH, KDD_LR, KDD_COST, KDD_SEED = 6400, 32, 2e-4, 0.35, 5
# Adam leaves, all in one update: the shapes of tests/test_fused_adam.py,
# bbc's three kinds of weight leaf (first/last layer, hidden layer, a bias),
# one leaf whose pointers are not 16-byte aligned (the kernel's scalar path)
# and one of zero size (left out of the table); then ADAM_MANY ragged
# leaves (more than one table holds), and a few leaves from a late step
# count (the nltcs headline's last)
ADAM_SHAPES = [(7, 9, 5), (7, 5, 5), (3, 4), (11,), (1058, 1058, 111),
               (1058, 111, 111), (1058, 1, 111)]
ADAM_UNALIGNED, ADAM_EMPTY = (1000, 3), (0, 5)
ADAM_MANY = 200
ADAM_LATE_COUNT = 16253
ADAM_STEPS = 3
ADAM_KERNEL = 'adam_table_kernel'     # the kernel's name in a profile
LR, EPS = 0.003, 1e-7
# Gibbs CMLL: bbc's chain cut to 20 sweeps (burn-in 2) of p1 = 105; the
# plain-version hold's steps; the segment profiled; kdd's test rows chained
CMLL_SMP, CMLL_BURN, CMLL_HOLD, CMLL_SEGMENT = 20, 2, 512, 64
KDD_CMLL_ROWS = 1024
RESUME_STEPS = 20
PACKED_SEEDS = (5, 6, 7, 8)       # packed_kdd: the kdd seed and three more
STREAM_CHUNK_STEPS = 64           # stream_kdd: 200 steps in 64, 64, 64, 8
RUN_EPOCHS = 3                    # run_epochs: kdd epochs a call


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


def cuda_ms(fn, target_s: float = 0.25) -> float:
    """Mean time of fn() in ms, by CUDA events over a run of calls sized to
    take about `target_s`, after a warm-up call. The host makes the calls
    back to back, so where its dispatch of a call takes longer than the
    call's kernels (below about 20 us) this times the dispatch; `device_ms`
    times the kernels alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(500, max(5, target_s * 1e3 / max(start.elapsed_time(end),
                                                     1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profile(run, min_kernels: int = 1):
    """torch.profiler's key averages of run() (which ends in a synchronize),
    from the first of PROFILER_TRIES sessions that saw device time in at
    least `min_kernels` kernels: a session can come back without any
    device events, or with some of them dropped. None if none saw
    enough."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        averages = prof.key_averages()
        if sum(e.count for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0) >= min_kernels:
            return averages
    return None


def queued_events_ms(fn, calls: int = PROFILE_CALLS) -> float:
    """Device time of fn() in ms by CUDA events around `calls` calls queued
    behind a sleep on the device, so that the host's dispatch is hidden and
    the calls' kernels run back to back (the gaps between them count). The
    sleep doubles until it outlasts the host's queueing, up to ~0.3 s."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 22
    for _ in range(8):
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if marks[0].elapsed_time(marks[1]) > queued_ms + 1.0:
            break
        cycles *= 2
    return marks[1].elapsed_time(marks[2]) / calls


def device_ms(fn, calls: int = PROFILE_CALLS) -> float:
    """Device time of fn() in ms: the sum of its CUDA kernels' device time
    (torch.profiler, as profile_run reads it), averaged over `calls` warm
    calls. Unlike cuda_ms it leaves out the host's dispatch between calls.
    Where no profiler session sees a kernel a call, queued_events_ms
    stands in (DEVICE_TIMER counts the calls each way)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = _profile(run, calls)
    if averages is None:
        DEVICE_TIMER['queued_events'] += 1
        return queued_events_ms(fn, calls)
    DEVICE_TIMER['profiler'] += 1
    total_us = sum(e.self_device_time_total for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / calls


def split_device_ms(fn, match: str, calls: int = PROFILE_CALLS):
    """(device ms of fn()'s kernels whose name holds `match`, device ms of
    its other kernels), averaged over `calls` warm calls from one profiler
    session, as device_ms reads it. Where no session sees a kernel a call,
    or sees none of the matched kernels, (queued_events_ms(fn), None): the
    whole call, not split."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = _profile(run, calls)
    cuda = [e for e in averages or ()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = sum(e.self_device_time_total for e in cuda if match in e.key)
    if mine <= 0:
        DEVICE_TIMER['queued_events'] += 1
        return queued_events_ms(fn, calls), None
    DEVICE_TIMER['profiler'] += 1
    other = sum(e.self_device_time_total for e in cuda
                if match not in e.key)
    return mine / 1e3 / calls, other / 1e3 / calls


def bound(n: int, b: int, d: int, k: int, bf16: bool = False):
    """Least time (ms) for the argmin's work on an H100 SXM, and its bound:
    z and W read once (4 bytes a value, 2 in bfloat16), the codes written
    once; 2nBDK operations at the fp32 rate, or for bfloat16 operands at
    the bf16 tensor-core rate (their products are exact in f32 sums)."""
    size = 2.0 if bf16 else 4.0
    flops_ms = 2.0 * n * b * d * k / (BF16_FLOPS if bf16 else FP32_FLOPS) \
        * 1e3
    bytes_ms = (size * n * (b * d + d * k) + 4.0 * n * b) / HBM_BYTES * 1e3
    return max(flops_ms, bytes_ms), ('operations' if flops_ms >= bytes_ms
                                     else 'bytes')


def near_ties(z, w, got, ref):
    """Rows where two code arrays disagree must be near-ties: the float64
    distance of `got`'s pick is within NEAR_TIE_REL of the true minimum
    (relative to max(d_min, |z|^2), the scale of fp32 rounding there).
    Returns (mismatches, max float64 distance gap); raises on any other."""
    diff = (got.to(ref.device) != ref).nonzero()
    if diff.shape[0] == 0:
        return 0, 0.0
    if diff.shape[0] > max(10, got.numel() // 100):
        raise AssertionError(f'{diff.shape[0]} of {got.numel()} codes '
                             f'disagree: not tie-flips')
    v, b = diff[:, 0], diff[:, 1]
    zz = z[v, b].double()                                            # [m,D]
    ww = w[v].double()                                               # [m,D,K]
    dist = ((zz[:, :, None] - ww) ** 2).sum(1)                       # [m,K]
    dmin = dist.min(1).values
    pick = dist.gather(1, got.to(ref.device)[v, b].long()[:, None])[:, 0]
    gap = pick - dmin
    tol = NEAR_TIE_REL * torch.maximum(dmin, (zz * zz).sum(1))
    bad = gap > tol
    if bool(bad.any()):
        raise AssertionError(f'{int(bad.sum())} code mismatches are not '
                             f'near-ties (max gap {float(gap.max())})')
    return int(diff.shape[0]), float(gap.max())


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
    assert torch.backends.cuda.matmul.allow_tf32 is False, 'TF32 is on'
    torch.backends.cudnn.allow_tf32 = False
    x = torch.ones(1024, device='cuda')

    def probe():                      # also starts the profiler's tracing
        x.add_(1)
        torch.cuda.synchronize()
    emit('device', nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         profiler_sees_device=_profile(probe) is not None)
    return smi


def _ptxas(log_path) -> dict:
    """ptxas register and spill lines by kernel entry, from a build log
    (absent when the library was already built)."""
    out, entry = {}, None
    if not log_path.exists():
        return out
    for line in log_path.read_text().splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif entry and ('Used' in line or 'spill' in line):
            out.setdefault(entry, []).append(line.split(':', 1)[-1].strip())
    return out


def _sass_hmma(lib_path) -> dict:
    """Tensor-core instructions (HMMA) in the SASS of each instantiation of
    the bfloat16 kernel in a built library, by `cuobjdump -sass`."""
    from pgmvae_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc('vq_argmin')),
                        'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(lib_path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split('Function : ')[1:]:
        name, body = part.split('\n', 1)
        m = re.search(r'vq_argmin_bf16_kernelILi(\d+)ELi(\d+)E', name)
        if m:
            out['bf16_%s_%s' % m.groups()] = body.count('HMMA')
    return out


def phase_build():
    """Every registered kernel library's build (`ops/kernels.py`), one
    nvcc each, started together. The bfloat16 nearest-code kernel must run
    on the tensor cores: every instantiation's SASS holds HMMA."""
    from pgmvae_tpu_torch.ops import (cuda_ema, cuda_first_layer,
                                      cuda_recon, cuda_vq, fused_adam,
                                      kernels)

    def timed(build):
        t0 = time.time()
        build()
        return time.time() - t0

    t0 = time.time()
    builds = kernels.builds()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(timed, build)
                   for name, build in builds.items()}
        seconds = {name: f.result() for name, f in futures.items()}
    vq = _ptxas(cuda_vq.library_path().with_suffix('.log'))
    # by template arguments: vq_argmin_kernel<float, DPAD, EXACT, RB, SUB>
    # -> 'DPAD_RB_SUB', with an 'x' after DPAD where EXACT;
    # vq_argmin_bf16_kernel<KS, MT> -> 'bf16_KS_MT'
    dpad = {}
    for e, lines in vq.items():
        m = re.search(r'vq_argmin_kernelIfLi(\d+)ELb([01])ELi(\d+)ELi(\d+)E',
                      e)
        if m:
            p, exact, rb, sub = m.groups()
            dpad[f'{p}{"x" * int(exact)}_{rb}_{sub}'] = lines
        m = re.search(r'vq_argmin_bf16_kernelILi(\d+)ELi(\d+)E', e)
        if m:
            dpad['bf16_%s_%s' % m.groups()] = lines
    hmma = _sass_hmma(cuda_vq.library_path())
    assert sorted(hmma) == sorted(BF16_INSTANCES) and all(
        hmma.values()), ('bf16 kernel without tensor-core SASS', hmma)
    # adam_table_kernel<M>: by moment type
    adam = {('bf16' if 'bfloat16' in e else 'f32'): lines
            for e, lines in _ptxas(
                fused_adam.library_path().with_suffix('.log')).items()}
    emit('build', seconds=seconds, wall_seconds=time.time() - t0,
         libraries=[cuda_vq.library_path().name,
                    fused_adam.library_path().name,
                    cuda_ema.library_path().name,
                    cuda_recon.library_path().name,
                    cuda_first_layer.library_path().name],
         ptxas_ema=_ptxas(cuda_ema.library_path().with_suffix('.log')),
         ptxas_recon=_ptxas(cuda_recon.library_path().with_suffix('.log')),
         ptxas_first_layer=_ptxas(
             cuda_first_layer.library_path().with_suffix('.log')),
         ptxas_vq={key: dpad.get(key) for key in (
             '10x_8_4', '10x_4_4', '10x_8_1', '20x_8_1', '20x_4_1',
             '20x_8_4', '30x_8_1', '16_4_1', '24_8_4', '128_4_1')
             + BF16_INSTANCES},
         sass_hmma_bf16=hmma, ptxas_adam=adam)


def _tie_edges(bf16: bool = False):
    """Code ranges (first copy, repeat) that straddle the kernel's code tile
    edge inside a strip and its strip edge between blocks at TIE_SPLIT,
    16 codes each side of the edge, by the float32 plan or the bfloat16
    one."""
    from pgmvae_tpu_torch.ops import cuda_vq
    p = (cuda_vq.plan_bf16 if bf16 else cuda_vq.plan)(*TIE_SPLIT)
    assert p.strips > 1 and p.strip_k > p.tk, p
    return [(range(e - 16, e), range(e, e + 16)) for e in (p.tk, p.strip_k)]


def _tie_groups():
    """Code pairs (first copies, repeats) of the float32 plan at TIE_SPLIT,
    for its first 16 code lanes: inside one thread's group of RK codes
    (4j, 4j + 2), and across a group boundary of the same lane (4j + 3, the
    first code of the lane's next group)."""
    from pgmvae_tpu_torch.ops import cuda_vq
    p = cuda_vq.plan(*TIE_SPLIT)
    step = p.tk // p.sub             # a lane's next group: the next sub-tile
    lanes = range(16)
    return ([4 * j for j in lanes] + [4 * j + 3 for j in lanes],
            [4 * j + 2 for j in lanes] + [step + 4 * j for j in lanes])


def _kernel_case(kind, n, b, d, k, gen, dtype=torch.float32):
    """Inputs (z, w) of one kernel case on the card, of `dtype`."""
    if kind in ('shape', 'ragged'):
        return (torch.randn((n, b, d), generator=gen, device='cuda'),
                torch.randn((n, d, k), generator=gen,
                            device='cuda'))
    if kind == 'unaligned':        # one value past the allocation's start
        return tuple(torch.randn(math.prod(shape) + 1, generator=gen,
                                 device='cuda').to(dtype)[1:].view(shape)
                     for shape in ((n, b, d), (n, d, k)))
    if kind in ('tie', 'tie_split'):     # every code identical
        return (torch.zeros((n, b, d), device='cuda'),
                torch.ones((n, d, k), device='cuda'))
    w = torch.randn((n, d, k), generator=gen, device='cuda')
    if kind == 'tie_tiles':              # codes 64..127 repeat codes 0..63
        w[:, :, 64:128] = w[:, :, 0:64]
        return torch.randn((n, b, d), generator=gen, device='cuda'), w
    # tie_strips: repeated codes across the tile and the strip edge (or
    # tie_groups: inside a thread's group and across its groups), each
    # sample placed next to one first copy, so the pair is its nearest
    if kind == 'tie_groups':
        src, repeat = _tie_groups()
        w[:, :, repeat] = w[:, :, src]
    else:
        src = []
        for first, repeat in _tie_edges(dtype == torch.bfloat16):
            w[:, :, repeat.start:repeat.stop] = \
                w[:, :, first.start:first.stop]
            src.extend(first)
    src = torch.tensor(src, device='cuda')[torch.arange(b) % len(src)]
    z = w[:, :, src].transpose(1, 2).contiguous()
    z += 1e-3 * torch.randn(z.shape, generator=gen, device='cuda')
    return z, w


def phase_kernel(dtype=torch.float32):
    """The nearest-code kernel's float32 instance (or its bfloat16 one)
    against its plain version at the main paths' shapes and on ties: codes
    equal up to float64-proven near-ties, repeated codes give the first
    copy. Then times beside the bound and the library call."""
    from pgmvae_tpu_torch.ops import cuda_vq
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows, max_err = {}, 0.0
    shapes = KERNEL_SHAPES + (BENCH_BF16_SHAPES + CLI_BF16_SHAPES if bf16
                              else BENCH_SHAPES + STREAM_SHAPES
                              + SWEEP_MEMORY_SHAPES)
    cases = ([('shape', s) for s in shapes]
             + [('tie', (1, 8, 4, 12)), ('tie_tiles', (2, 40, 8, 130)),
                ('tie_split', TIE_SPLIT), ('tie_strips', TIE_SPLIT)])
    if bf16:
        cases += ([('ragged', s) for s in BF16_RAGGED]
                  + [('unaligned', s) for s in BF16_UNALIGNED])
    else:
        cases += ([('tie_groups', TIE_SPLIT)]
                  + [('ragged', s) for s in F32_RAGGED])
    for kind, (n, b, d, k) in cases:
        z, w = (t.to(dtype) for t in _kernel_case(kind, n, b, d, k, gen,
                                                  dtype))
        if kind == 'unaligned':
            assert z.data_ptr() % 4 == w.data_ptr() % 4 == 2, kind
        got = cuda_vq.vq_codes_fused(z, w)
        ref = cuda_vq.vq_codes_plain(z, w)
        torch.cuda.synchronize()
        # a repeated code scores bit-equal to its first copy: the first
        # must win
        if kind in ('tie', 'tie_split'):
            assert int(got.max()) == 0 and int(ref.max()) == 0, kind
        elif kind == 'tie_tiles':
            assert not bool(((got >= 64) & (got < 128)).any()), kind
        elif kind == 'tie_strips':
            for _, repeat in _tie_edges(bf16):
                assert not bool(((got >= repeat.start)
                                 & (got < repeat.stop)).any()), kind
        elif kind == 'tie_groups':
            assert not bool(torch.isin(
                got, torch.tensor(_tie_groups()[1], dtype=got.dtype,
                                  device=got.device)).any()), kind
        mism, gap = near_ties(z, w, got, ref)
        max_err = max(max_err, gap)
        row = dict(kind=kind, shape=[n, b, d, k], mismatches=mism,
                   max_gap=gap)
        if kind == 'shape':
            w2 = torch.sum(w * w, dim=1, keepdim=True)
            bms, by = bound(n, b, d, k, bf16)
            fns = {'': lambda: cuda_vq.vq_codes_fused(z, w),
                   'plain_': lambda: cuda_vq.vq_codes_plain(z, w),
                   'library_': lambda: torch.baddbmm(
                       w2, z, w, alpha=-2).argmin(-1)}
            for name, fn in fns.items():
                row[name + 'ms'] = cuda_ms(fn)
                row[name + 'device_ms'] = device_ms(fn)
            # the stand-in timer of device_ms, held beside it on every run
            row['queued_events_ms'] = queued_events_ms(fns[''])
            row.update(bound_ms=bms, bound_by=by,
                       bound_share=bms / row['device_ms'],
                       vs_library=row['library_device_ms']
                       / row['device_ms'])
        rows[(kind, n, b, d, k)] = row
        emit('kernel_bf16' if bf16 else 'kernel', **row)
    return rows, max_err


def _leaf_bytes_bound(numel: int, per_param: float = 28.0) -> float:
    """Least time (ms) of one Adam pass over `numel` parameters on an H100
    SXM: p, m, v, g read and p, m, v written once, 28 bytes a parameter
    (20 with bfloat16 moments)."""
    return per_param * numel / HBM_BYTES * 1e3


def _adam_per_step(n_leaves: int) -> int:
    """Adam kernel launches of a train step over `n_leaves` leaves: one per
    table of leaves."""
    from pgmvae_tpu_torch.ops import fused_adam
    return fused_adam.launches_per_update(n_leaves)


def _adam_pair(specs, gen, moment_dtype=torch.float32):
    """Two identical (params, state) sets in the params layout, one leaf
    per (shape, unaligned) of `specs`; an unaligned leaf is a view 4 bytes
    past an alignment."""
    from pgmvae_tpu_torch.ops import fused_adam
    leaves = []
    for shape, unaligned in specs:
        p = torch.randn(shape, generator=gen, device='cuda') * 0.1
        if unaligned:              # same values, 4 bytes past an alignment
            buf = torch.empty(p.numel() + 1, device='cuda')
            buf[1:] = p.reshape(-1)
            p = buf[1:].view(shape)
        leaves.append(p)
    params = {'enc': [(p,) for p in leaves]}
    twin = {'enc': [(p.clone(),) for p in leaves]}
    return (params, fused_adam.adam_init(params, LR, EPS, moment_dtype),
            twin, fused_adam.adam_init(twin, LR, EPS, moment_dtype))


def _adam_cases():
    """(name, [(shape, unaligned)], first count) of the kernel's checks."""
    rng = np.random.default_rng(SEED)
    many = [((int(n),), False) for n in rng.integers(0, 12000, ADAM_MANY)]
    many[7] = ((4099,), True)
    return [('one_table', [(s, False) for s in ADAM_SHAPES]
             + [(ADAM_UNALIGNED, True), (ADAM_EMPTY, False)], 0),
            ('over_capacity', many, 0),
            ('late_count', [(s, False) for s in ADAM_SHAPES[:4]]
             + [(ADAM_UNALIGNED, True)], ADAM_LATE_COUNT)]


def phase_kernel_adam(moment_dtype=torch.float32):
    """The one-launch Adam kernel (with float32 or bfloat16 moments) against
    `adam_update_plain` on the card, ADAM_STEPS updates from the same state
    on multi-leaf tables (`_adam_cases`): p, m and v must be bit-equal, and
    each update launches once per table. Then times over the main paths'
    leaves."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import fused_adam, kernels
    from pgmvae_tpu_torch.registry import default_units
    bf16 = moment_dtype == torch.bfloat16
    name = 'kernel_adam_bf16' if bf16 else 'kernel_adam'
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    for case, specs, count in _adam_cases():
        params, st, twin, st2 = _adam_pair(specs, gen, moment_dtype)
        st = st._replace(count=st.count + count)
        st2 = st2._replace(count=st2.count + count)
        live = sum(1 for shape, _ in specs if np.prod(shape) > 0)
        before = kernels.counts()
        for _ in range(ADAM_STEPS):
            grads = {'enc': [(torch.randn(p.shape, generator=gen,
                                          device='cuda') * 0.01,)
                             for (p,) in params['enc']]}
            st = fused_adam.adam_update(params, grads, st)
            st2 = fused_adam.adam_update_plain(
                twin, vqvae.map_params(torch.clone, grads), st2)
        torch.cuda.synchronize()
        launched = kernels.since(before)
        want = ADAM_STEPS * fused_adam.launches_per_update(live)
        assert launched == _launches(**{'adam_bf16' if bf16 else 'adam':
                                         want}), (case, launched, want)
        pairs = [(params, twin), (st.mu, st2.mu), (st.nu, st2.nu)]
        for x, y in pairs:
            for i, ((a,), (b,)) in enumerate(zip(x['enc'], y['enc'])):
                assert torch.equal(a, b), (case, i, tuple(a.shape), float(
                    (a.float() - b.float()).abs().max()))
        assert st.mu['enc'][0][0].dtype == moment_dtype
        assert int(st.count) == int(st2.count) == count + ADAM_STEPS
        emit(name, case=case, leaves=len(specs), live_leaves=live,
             params=int(sum(np.prod(s) for s, _ in specs)),
             unaligned=sum(u for _, u in specs), first_count=count + 1,
             steps=ADAM_STEPS, launches=want, bit_equal=True)

    # times over the leaves of the bbc model (section train), the nltcs
    # headline's, kdd's (alone and packed, S=4), ad's, a rank's quarter of
    # mesh_bbc's padded model (265 of 1060 networks) and the out-of-core
    # twin's 64-variable model
    from pgmvae_tpu_torch import bench
    cfg = vqvae.VqVaeConfig(n_var=1058, units=default_units(1058, 20),
                            dim=20, num_codes=50, fan_mode='per_network')
    row = _adam_times(vqvae.init_model(gen, cfg)[0], gen, moment_dtype,
                      name + '_bbc')
    nltcs = vqvae.init_model(gen, bench.NLTCS_CFG)[0]
    _adam_times(nltcs, gen, moment_dtype, name + '_nltcs')
    if not bf16:
        kdd = vqvae.init_model(gen, _kdd_config())[0]
        _adam_times(kdd, gen, moment_dtype, name + '_kdd')
        packed = vqvae.map_params(
            lambda p: torch.stack([p] * len(PACKED_SEEDS)), kdd)
        _adam_times(packed, gen, moment_dtype, name + '_packed_kdd')
        del kdd, packed
        _adam_times(vqvae.init_model(gen, bench.AD_CFG)[0], gen,
                    moment_dtype, name + '_ad')
        shard = _mesh_bbc_config()
        params, _ = vqvae.init_model(gen, shard)
        params = vqvae.map_params(lambda p: p[:shard.n_var // MESH_BBC[1]]
                                  .contiguous(), params)
        _adam_times(params, gen, moment_dtype, name + '_bbc_shard')
        from pgmvae_tpu_torch import bench_streaming
        cfg = bench_streaming.model_config(
            bench_streaming.build_parser().parse_args([]))
        _adam_times(vqvae.init_model(gen, cfg)[0], gen, moment_dtype,
                    name + '_stream_big')
    return row


def _adam_times(params, gen, moment_dtype, name):
    """The one-launch Adam update over the leaves of `params`: the kernel's
    device time apart from the update's scalar operations (the step count
    and the powers b^t), the whole update's, CUDA events, the plain version
    and (float32 moments) PyTorch's fused Adam. One line `name`."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import fused_adam, kernels
    bf16 = moment_dtype == torch.bfloat16
    leaves = vqvae.param_leaves(params)
    grads = vqvae.map_params(
        lambda p: torch.randn(p.shape, generator=gen, device='cuda') * 0.01,
        params)
    state = fused_adam.adam_init(params, LR, EPS, moment_dtype)
    numel = sum(p.numel() for p in leaves)
    per_param = 20.0 if bf16 else 28.0
    before = kernels.counts()

    def kernel():
        fused_adam.adam_update(params, grads, state)

    def plain():
        fused_adam.adam_update_plain(params, grads, state)
    ms = cuda_ms(kernel)
    kernel_dev, scalar_dev = split_device_ms(kernel, ADAM_KERNEL)
    update_dev = device_ms(kernel)
    kernel_queued = queued_events_ms(kernel)
    tables = fused_adam.leaf_tables(
        list(zip(leaves, vqvae.param_leaves(state.mu),
                 vqvae.param_leaves(state.nu), vqvae.param_leaves(grads))))
    plain_ms, plain_dev = cuda_ms(plain), device_ms(plain)
    kernels.restore(before)            # timing launches are not counted
    library_ms = library_dev = None
    if not bf16:
        # yardstick only: PyTorch's own fused Adam over the same leaves (it
        # adds eps after sqrt(v)/sqrt(bc2): the same bytes, other
        # arithmetic); it keeps the moments in the parameters' dtype, so
        # there is no library call for bfloat16 moments
        lib_leaves = [p.detach().clone().requires_grad_() for p in leaves]
        for p, g in zip(lib_leaves, vqvae.param_leaves(grads)):
            p.grad = g
        opt = torch.optim.Adam(lib_leaves, lr=LR, eps=EPS, fused=True)
        library_ms, library_dev = cuda_ms(opt.step), device_ms(opt.step)
        del opt, lib_leaves
    bound_ms = _leaf_bytes_bound(numel, per_param)
    row = dict(leaves=len(leaves), params=numel,
               launches_per_step=_adam_per_step(
                   sum(1 for p in leaves if p.numel() > 0)),
               chunks=[t.chunks for t in tables],
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               device_ms=kernel_dev, scalar_device_ms=scalar_dev,
               update_device_ms=update_dev, queued_events_ms=kernel_queued,
               plain_device_ms=plain_dev, library_device_ms=library_dev,
               bound_ms=bound_ms, bound_by='bytes',
               bound_share=bound_ms / kernel_dev,
               update_bound_share=bound_ms / update_dev,
               kernel_vs_library=(None if library_dev is None
                                  else library_dev / kernel_dev),
               update_vs_library=(None if library_dev is None
                                  else library_dev / update_dev),
               bytes_per_param=per_param,
               achieved_tb_s=per_param * numel / (kernel_dev * 1e-3) / 1e12,
               shapes=[list(p.shape) for p in leaves])
    emit(name, **row)
    return row


# the EMA kernel's shapes (n, B, D, K): every main path's (the packed kdd
# sweep's train batch (S=4) and the kdd cell's alone, bbc's quality recipe
# and its bs 250, ad's at bs 250, nltcs's headline, stream_big's (and
# cli_big's and sweep_memory's)); one of odd D * K (one value at a time);
# K past one chunk, a block an SM and two; and a batch whose tables do not
# fit in shared memory. Its cases: a fresh state (step 1), a late step, the
# ragged last batch (0/1 weights), every row on one code, and zero_debias
# off at step 1 and late. The first two shapes (the training cells') are
# timed.
EMA_SHAPES = [(256, 32, 10, 4096), (1058, 25, 20, 50), (64, 32, 10, 4096),
              (1058, 250, 20, 50), (1556, 250, 30, 20), (16, 128, 10, 50),
              (64, 256, 10, 64), (40, 100, 7, 33), (16, 256, 20, 65536),
              (160, 64, 10, 65536), (4, 8192, 20, 8192)]
EMA_TIMED = 2
EMA_CASES = ('step1', 'late', 'ragged', 'one_code', 'no_debias',
             'no_debias_late')
EMA_LATE_STEP = 5627
EMA_KERNEL = 'ema_update_kernel'      # the kernel's name in a profile


def _ema_case(case, n, b, d, k, gen):
    """(state, z, codes, weights, zero_debias) of one EMA case on the
    card."""
    from pgmvae_tpu_torch.ops import quantizer as q
    zero_debias = not case.startswith('no_debias')
    cb = torch.randn((n, d, k), generator=gen, device='cuda')
    state = q.ema_init(cb, zero_debias)
    if case in ('late', 'ragged', 'one_code', 'no_debias_late'):
        state = q.EmaState(
            cb, 2 * torch.rand((n, k), generator=gen, device='cuda'),
            torch.randn((n, d, k), generator=gen, device='cuda'),
            torch.tensor(EMA_LATE_STEP, dtype=torch.int32, device='cuda'))
    z = torch.randn((n, b, d), generator=gen, device='cuda')
    idx = torch.randint(0, k, (n, b), generator=gen, device='cuda',
                        dtype=torch.int32)
    if case == 'one_code':
        idx.fill_(k // 2)
    w = torch.ones(b, device='cuda')
    if case == 'ragged':
        w[b - b // 3:] = 0.0
    return state, z, idx, w, zero_debias


def _net_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst network's max |a - b| over its max |b| (axis 0 is the
    network)."""
    a, b = a.flatten(1), b.flatten(1)
    return float(((a - b).abs().amax(1)
                  / b.abs().amax(1).clamp(min=1e-30)).max())


def phase_kernel_ema():
    """The EMA codebook step's kernel against `ema_update_plain` on the card
    at EMA_SHAPES, each of EMA_CASES from the same state: the batch counts
    and the new counts must be bit-equal, dw and the codebook within 1e-6
    relative (the worst network's largest difference over its largest
    value; the largest elementwise gap is reported beside it), the step one
    more, and the state's own tensors written, one launch a call. Then
    times at the first EMA_TIMED shapes: the kernel's device time apart
    from the debias factor's scalar operations, the whole step's, CUDA
    events, the plain version, and the bound."""
    from pgmvae_tpu_torch.ops import cuda_ema, kernels
    from pgmvae_tpu_torch.ops import quantizer as q
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = {}
    launched = kernels.counts()
    for shape in EMA_SHAPES:
        n, b, d, k = shape
        worst = {}
        for case in EMA_CASES:
            state, z, idx, w, zd = _ema_case(case, *shape, gen)
            mine = q.EmaState(*(t.clone() for t in state))
            before = kernels.counts()
            got, counts = cuda_ema.ema_update_fused(mine, z, idx, w, 0.9,
                                                    1e-5, zd)
            want, want_counts = cuda_ema.ema_update_plain(state, z, idx, w,
                                                          0.9, 1e-5, zd)
            torch.cuda.synchronize()
            assert kernels.since(before) == _launches(ema=1), case
            assert all(a is b for a, b in zip(got[:3], mine[:3])), case
            assert torch.equal(counts, want_counts), (shape, case)
            assert torch.equal(got.counts, want.counts), (shape, case)
            assert int(got.step) == int(want.step) == int(state.step) + 1
            rel = {name: _net_rel(getattr(got, name), getattr(want, name))
                   for name in ('dw', 'codebook')}
            elem = {name: _max_rel(getattr(got, name), getattr(want, name))
                    for name in ('dw', 'codebook')}
            assert max(rel.values()) <= 1e-6, (shape, case, rel, elem)
            worst[case] = {'rel': rel, 'elementwise_rel': elem,
                           'dw_bit_equal': torch.equal(got.dw, want.dw),
                           'codebook_bit_equal':
                               torch.equal(got.codebook, want.codebook)}
            del state, z, idx, w, mine, got, want, counts, want_counts
        row = dict(shape=list(shape), cases=worst,
                   plan=cuda_ema.plan(*shape)._asdict())
        rows[shape] = row
        if len(rows) > EMA_TIMED:
            emit('kernel_ema', **row)
            continue
        state, z, idx, w, zd = _ema_case('late', *shape, gen)

        def kernel():
            cuda_ema.ema_update_fused(state, z, idx, w, 0.9, 1e-5, True)

        def plain():
            cuda_ema.ema_update_plain(state, z, idx, w, 0.9, 1e-5, True)
        ms = cuda_ms(kernel)
        kernel_dev, scalar_dev = split_device_ms(kernel, EMA_KERNEL)
        step_dev = device_ms(kernel)
        plain_ms, plain_dev = cuda_ms(plain), device_ms(plain)
        nbytes = 4.0 * n * (3 * d * k + 2 * k)
        bound_ms = nbytes / HBM_BYTES * 1e3
        row.update(ms=ms, device_ms=kernel_dev, scalar_device_ms=scalar_dev,
                   step_device_ms=step_dev, plain_ms=plain_ms,
                   plain_device_ms=plain_dev, library_ms=None,
                   library_device_ms=None, bound_ms=bound_ms,
                   bound_by='bytes', bound_share=bound_ms / kernel_dev,
                   achieved_tb_s=nbytes / (kernel_dev * 1e-3) / 1e12)
        emit('kernel_ema', **row)
        del state, z, idx, w
    kernels.restore(launched)          # comparison and timing only
    return rows


# The reconstruction tail's kernel pair, (F, B, N, S, lo, n_active, dtype,
# case): bbc's quality recipe and its batch 250 (its ragged step: 170
# rows of weight 1), packed kdd (S=4, the packed step's upstream gradient
# expanded from one value), a mesh_bbc rank's networks (the last of four
# model ranks over 1,060 networks, two of them padding; 125 rows and the
# global batch's weight sum), the padded model whole (n_active 1,058 of
# 1,060; bbc's ragged step at batch 25, 20 rows of weight 1), bfloat16 at
# batch 250 and at an odd width, and the pair-free paths: an odd width and
# logits one value past an alignment
RECON_CASES = [(1058, 25, 1058, 1, 0, 1058, 'float32', 'full'),
               (1058, 250, 1058, 1, 0, 1058, 'float32', 'ragged'),
               (256, 32, 64, 4, 0, 64, 'float32', 'full'),
               (265, 125, 1060, 1, 795, 1058, 'float32', 'shard'),
               (1060, 25, 1060, 1, 0, 1058, 'float32', 'ragged'),
               (1058, 250, 1058, 1, 0, 1058, 'bfloat16', 'ragged'),
               (9, 33, 9, 1, 0, 9, 'bfloat16', 'full'),
               (21, 10, 7, 3, 0, 6, 'float32', 'ragged'),
               (64, 32, 64, 1, 0, 64, 'float32', 'unaligned')]
RECON_TIMED = 3          # the first cases timed: bbc 25, bbc 250, packed kdd
RECON_KERNELS = ('recon_loss_fwd_kernel', 'recon_loss_bwd_kernel')


def _recon_case(f, b, n, s, lo, na, dtype, case, gen):
    """(logits, y, w, wsum, g, seeds) of one reconstruction case on the
    card: logits ~ N(0, 2^2), binary labels, 0/1 weights. A ragged case
    keeps the rows of bbc's last step at its batch (1,670 train rows), or
    two thirds where the batch divides them."""
    from pgmvae_tpu_torch.registry import REGISTRY
    dt = getattr(torch, dtype)
    size = f * b * n
    x = 2.0 * torch.randn(size + (case == 'unaligned'), generator=gen,
                          device='cuda')
    x = x[1:] if case == 'unaligned' else x
    x = x.view(f, b, n).to(dt)
    y = (torch.rand((s, b, n), generator=gen, device='cuda') < 0.3).float()
    w = torch.ones(b, device='cuda')
    if case == 'ragged':
        w[REGISTRY['bbc'].n_train % b or b - b // 3:] = 0.0
    wsum = (torch.tensor(2.0 * b - 3.0, device='cuda') if case == 'shard'
            else None)
    g = (torch.ones((), device='cuda').expand(s) if s > 1
         else 0.5 + torch.rand((), generator=gen, device='cuda'))
    return x, (y if s > 1 else y[0]), w, wsum, g, (s if s > 1 else None)


def _recon_terms64(x, y, w, wsum, seeds, lo, na):
    """The plain version's per-element float32 terms of the MSE and MAE
    summed in float64: (mse, mae) [S] of exact sums of the same terms."""
    from pgmvae_tpu_torch.ops import cuda_recon
    recon = torch.sigmoid(x)
    mask = cuda_recon._mask(x, seeds, lo, na, torch.float32)
    d = cuda_recon._denominator(na, w, wsum).double()
    sq = cuda_recon.recon_error(recon, y.to(x.dtype), seeds) ** 2
    ab = torch.abs(cuda_recon.recon_error(recon, y, seeds))
    dims = (1, 2, 3) if seeds is not None else (0, 1, 2)
    return tuple(torch.sum((t * mask * w[None, :, None]).double(), dims) / d
                 for t in (sq, ab))


def phase_kernel_recon():
    """The reconstruction tail's kernel pair against its plain versions
    (`recon_loss_plain`, autograd through it) on the card at RECON_CASES:
    mse and mae within (2 ceil(N / 64) + 1) 2^-24 relative of the float64
    sums of the plain version's own float32 terms (a lane's float32 partial
    of a row holds at most 2 ceil(N / 64) nonnegative terms, then float64,
    then one rounding; the plain version's float32 sums, within 1e-4 of the
    same, are reported), D bit-equal, the gradient within 1e-6 of its
    largest element in float32 and within 2^-8 (one bfloat16 rounding) in
    bfloat16, two launches a forward and backward; then the pair captured
    in a CUDA graph, whose two replays must be bit-equal to the eager call.
    Times at the first RECON_TIMED cases: each kernel's device time, the
    plain version's, CUDA events, and the bytes bound (the logits read by
    the forward, read and their gradient written by the backward, y read
    by each)."""
    from pgmvae_tpu_torch.ops import cuda_recon, kernels
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    launched = kernels.counts()
    rows = {}
    for spec in RECON_CASES:
        f, b, n, s, lo, na, dtype, case = spec
        x, y, w, wsum, g, seeds = _recon_case(*spec, gen)
        xk = x.detach().requires_grad_()
        before = kernels.counts()
        mse, mae = cuda_recon.recon_loss(xk, y, w, seeds, lo, na, wsum)
        grad, = torch.autograd.grad(mse, xk, g)
        torch.cuda.synchronize()
        assert kernels.since(before) == _launches(recon=2), spec
        xp = x.detach().requires_grad_()
        pmse, pmae = cuda_recon.recon_loss_plain(xp, y, w, seeds, lo, na,
                                                 wsum)
        pgrad, = torch.autograd.grad(pmse, xp, g)
        ref = _recon_terms64(x, y, w, wsum, seeds, lo, na)
        tol = (2 * -(-n // 64) + 1) * 2.0 ** -24

        def rel(a, r):
            a, r = a.double().reshape(-1), r.reshape(-1)
            return float(((a - r).abs() / r.abs().clamp(min=1e-300)).max())
        gaps = {'mse': rel(mse.detach(), ref[0]), 'mae': rel(mae, ref[1]),
                'plain_mse': rel(pmse.detach(), ref[0]),
                'plain_mae': rel(pmae, ref[1])}
        assert max(gaps['mse'], gaps['mae']) <= tol, (spec, gaps, tol)
        assert max(gaps['plain_mse'], gaps['plain_mae']) <= 1e-4, (spec,
                                                                   gaps)
        grad_rel = float((grad.float() - pgrad.float()).abs().max()
                         / pgrad.float().abs().max())
        assert grad_rel <= (1e-6 if dtype == 'float32' else 2.0 ** -8), (
            spec, grad_rel)
        assert grad.dtype == x.dtype and grad.shape == x.shape
        denom = cuda_recon._forward_kernel(x, y, w, seeds, lo, na, wsum)[2]
        assert torch.equal(denom, cuda_recon._denominator(na, w, wsum)), (
            spec, float(denom))
        row = dict(shape=[f, b, n], seeds=s, lo=lo, n_active=na,
                   dtype=dtype, case=case, gaps=gaps, tol=tol,
                   grad_rel=grad_rel,
                   grad_bit_equal_share=float(
                       (grad == pgrad).double().mean()),
                   plan=cuda_recon.plan(f, b, n, s)._asdict())

        # the pair in a CUDA graph: replays bit-equal to the eager call
        xs = x.detach().requires_grad_()
        outs = [torch.empty_like(mse), torch.empty_like(mae),
                torch.empty_like(grad)]

        def body():
            m1, m2 = cuda_recon.recon_loss(xs, y, w, seeds, lo, na, wsum)
            d, = torch.autograd.grad(m1, xs, g)
            for dst, src in zip(outs, (m1, m2, d)):
                dst.copy_(src)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        for _ in range(2):
            for t in outs:
                t.fill_(float('nan'))
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(
                outs, (mse, mae, grad))), ('replay', spec)
        del graph, outs, xs
        rows[spec] = row
        if len(rows) > RECON_TIMED:
            emit('kernel_recon', **row)
            del x, y, xk, xp, grad, pgrad
            continue

        def fwd():
            with torch.no_grad():
                cuda_recon.recon_loss(x, y, w, seeds, lo, na, wsum)

        def pair():
            m1, _ = cuda_recon.recon_loss(xk, y, w, seeds, lo, na, wsum)
            torch.autograd.grad(m1, xk, g)

        def plain():
            m1, _ = cuda_recon.recon_loss_plain(xp, y, w, seeds, lo, na,
                                                wsum)
            torch.autograd.grad(m1, xp, g)
        fwd_dev = split_device_ms(fwd, RECON_KERNELS[0])[0]
        pair_dev = device_ms(pair)
        bwd_dev = split_device_ms(pair, RECON_KERNELS[1])[0]
        size = x.element_size()
        nbytes = {'fwd': size * f * b * n + 4.0 * s * b * n,
                  'bwd': 2.0 * size * f * b * n + 4.0 * s * b * n}
        bound_ms = {k: v / HBM_BYTES * 1e3 for k, v in nbytes.items()}
        pair_bound = bound_ms['fwd'] + bound_ms['bwd']
        row.update(ms=cuda_ms(pair), device_ms=pair_dev,
                   fwd_device_ms=fwd_dev, bwd_device_ms=bwd_dev,
                   plain_ms=cuda_ms(plain), plain_device_ms=device_ms(plain),
                   library_ms=None, library_device_ms=None,
                   bound_ms=pair_bound, bound_by='bytes',
                   fwd_bound_ms=bound_ms['fwd'],
                   bwd_bound_ms=bound_ms['bwd'],
                   bound_share=pair_bound / pair_dev,
                   fwd_share=bound_ms['fwd'] / fwd_dev,
                   bwd_share=bound_ms['bwd'] / bwd_dev)
        emit('kernel_recon', **row)
        del x, y, xk, xp, grad, pgrad
    kernels.restore(launched)          # comparison and timing only
    return rows


# The masked first layer's kernel, (S, F, B, N, O, lo, n_active): bbc's
# shared rows at 1, 25, 246, 250 and 330 (a one-row request, the quality
# recipe's batch, bbc-score's 95th-percentile request, batch 250, the test
# split at once), the packed kdd step (S=4), a mesh_bbc rank's networks
# (the last of four model ranks over 1,060 networks; 125 rows), and the
# padded model whole (n_active 1,058 of 1,060) at 33 rows
FIRST_LAYER_CASES = [(1, 1058, 1, 1058, 111, 0, 1058),
                     (1, 1058, 25, 1058, 111, 0, 1058),
                     (1, 1058, 246, 1058, 111, 0, 1058),
                     (1, 1058, 250, 1058, 111, 0, 1058),
                     (1, 1058, 330, 1058, 111, 0, 1058),
                     (4, 64, 32, 64, 50, 0, 64),
                     (1, 265, 125, 1060, 111, 795, 1060),
                     (1, 1060, 33, 1060, 111, 0, 1058)]
FIRST_LAYER_TIMED = 7     # the first cases timed: the main paths' shapes
FIRST_LAYER_GRAD = ((1, 1058, 250, 1058, 111, 0, 1058),
                    (4, 64, 32, 64, 50, 0, 64),
                    (1, 265, 125, 1060, 111, 795, 1060),
                    (1, 1060, 33, 1060, 111, 0, 1058))
FIRST_LAYER_KERNEL = 'first_layer_kernel'


def _first_layer_case(s, f, b, n, o, lo, na, gen):
    """(w0, b0, y, seeds) of one case on the card: weights ~ N(0, 0.05^2),
    biases ~ N(0, 0.1^2), binary rows (30% ones)."""
    w0 = 0.05 * torch.randn((s * f, n, o), generator=gen, device='cuda')
    b0 = 0.1 * torch.randn((s * f, 1, o), generator=gen, device='cuda')
    y = (torch.rand((s, b, n), generator=gen, device='cuda') < 0.3).float()
    return w0, b0, (y if s > 1 else y[0]), (s if s > 1 else None)


def _first_layer64(w0, b0, y, seeds, lo, na):
    """(the layer in float64, the float64 sums of its terms' magnitudes),
    network by network in chunks: the masked input of `loo_mask`."""
    from pgmvae_tpu_torch.ops import cuda_first_layer
    s = seeds or 1
    f = w0.shape[0] // s
    mask = cuda_first_layer.first_layer_mask(w0, y, seeds, lo,
                                             na).double()
    rows = y.double().view(s, -1, y.shape[-1])
    out = torch.empty(w0.shape[0], rows.shape[1], w0.shape[2],
                      dtype=torch.float64, device='cuda')
    mag = torch.empty_like(out)
    for i in range(s):
        for c in range(0, f, 128):
            nets = slice(i * f + c, i * f + min(c + 128, f))
            x = rows[i][None] * mask[c:c + 128]
            w = w0[nets].double()
            out[nets] = torch.baddbmm(b0[nets].double(), x, w)
            mag[nets] = torch.bmm(x.abs(), w.abs())
    return out, mag


def phase_kernel_first_layer():
    """The masked first layer's kernel against its plain version (the
    [F, B, N] masked input and `baddbmm`) on the card at FIRST_LAYER_CASES:
    every output within N 2^-24 of the float64 sum of its terms'
    magnitudes of the float64 layer (the bound of any float32 order of the
    sum), a network past n_active exactly its bias, one launch a call.
    At FIRST_LAYER_GRAD the autograd Function's weight and bias gradients
    against autograd through the plain version (within B 2^-24 of the
    float64 sums of their terms' magnitudes), each network's own row and
    the padding's an exact zero, the device memory that the forward and
    backward hold past their inputs and results below the [n, B, n] masked
    input, and
    the pair captured in a CUDA graph, whose two replays must be bit-equal
    to the eager call. Times at the first FIRST_LAYER_TIMED cases: the
    kernel's device time and CUDA events, the plain version's, the
    library's (`baddbmm` alone on a masked input built before), and the
    bound, the larger of 2 S B N F O operations at the float32 peak and the
    weights, rows and output moved once at HBM bandwidth; at bbc batch 250
    also the forward and backward of a training step, kernel and plain."""
    from pgmvae_tpu_torch.ops import cuda_first_layer as cfl, kernels
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    launched = kernels.counts()
    rows = {}
    for i, spec in enumerate(FIRST_LAYER_CASES):
        s, f, b, n, o, lo, na = spec
        w0, b0, y, seeds = _first_layer_case(*spec, gen)
        before = kernels.counts()
        out = cfl.first_layer(w0, b0, y, seeds, lo, na)
        torch.cuda.synchronize()
        assert kernels.since(before) == _launches(first_layer=1), spec
        plain = cfl.first_layer_plain(w0, b0, y, seeds, lo, na)
        ref, mag = _first_layer64(w0, b0, y, seeds, lo, na)
        tol = n * 2.0 ** -24 * mag + 1e-30

        def over(t):
            return float(((t.double() - ref).abs() / tol).max())
        gaps = {'kernel': over(out), 'plain': over(plain),
                'kernel_rel': float((out.double() - ref).abs().max()
                                    / ref.abs().max()),
                'plain_rel': float((plain.double() - ref).abs().max()
                                   / ref.abs().max())}
        assert gaps['kernel'] <= 1.0 and gaps['plain'] <= 1.0, (spec, gaps)
        dead = [v for v in range(f) if lo + v >= na]
        assert all(torch.equal(out[v], b0[v].expand(b, o))
                   for v in dead), spec
        row = dict(shape=[s, f, b, n, o], lo=lo, n_active=na, gaps=gaps,
                   networks_past_n_active=len(dead),
                   plan=cfl.plan(b)._asdict())
        del ref, mag, plain
        if spec in FIRST_LAYER_GRAD:
            row.update(_first_layer_grad(w0, b0, y, seeds, lo, na, gen))
        if i < FIRST_LAYER_TIMED:
            row.update(_first_layer_times(w0, b0, y, seeds, lo, na))
        rows[spec] = row
        emit('kernel_first_layer', **row)
        del w0, b0, y, out
        torch.cuda.empty_cache()
    kernels.restore(launched)          # comparison and timing only
    return rows


def _first_layer_grad(w0, b0, y, seeds, lo, na, gen) -> dict:
    """The Function's gradients against autograd through the plain
    version, its memory and its graph replays (see the phase)."""
    from pgmvae_tpu_torch.ops import cuda_first_layer as cfl
    s, f = seeds or 1, w0.shape[0] // (seeds or 1)
    b, n, o = y.shape[-2], y.shape[-1], w0.shape[-1]
    g = torch.randn((s * f, b, o), generator=gen, device='cuda')
    wk, bk = w0.detach().requires_grad_(), b0.detach().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gw, gb = torch.autograd.grad(cfl.first_layer(wk, bk, y, seeds, lo, na),
                                 (wk, bk), g)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base
    # past the output and the two gradients: less than the masked input
    results = 4 * s * f * (b * o + n * o + o)
    masked_bytes = 4 * s * f * b * n
    assert held - results < masked_bytes, (held, results, masked_bytes)
    wp, bp = w0.detach().requires_grad_(), b0.detach().requires_grad_()
    pw, pb = torch.autograd.grad(
        cfl.first_layer_plain(wp, bp, y, seeds, lo, na), (wp, bp), g)
    mask = cfl.first_layer_mask(w0, y, seeds, lo, na)
    x = (y.view(s, 1, b, n) * mask).view(s * f, b, n).double()
    mag_w = torch.bmm(x.transpose(1, 2).abs(), g.double().abs())
    tol_w = b * 2.0 ** -24 * mag_w + 1e-30
    ref_w = torch.bmm(x.transpose(1, 2), g.double())
    del x
    gap_w = float(((gw.double() - ref_w).abs() / tol_w).max())
    plain_gap_w = float(((pw.double() - ref_w).abs() / tol_w).max())
    ref_b = g.double().sum(1, keepdim=True)
    tol_b = b * 2.0 ** -24 * g.double().abs().sum(1, keepdim=True) + 1e-30
    gap_b = float(((gb.double() - ref_b).abs() / tol_b).max())
    assert max(gap_w, plain_gap_w, gap_b) <= 1.0, (gap_w, plain_gap_w, gap_b)
    nets = gw.view(s, f, n, o)
    own = nets.diagonal(offset=lo, dim1=1, dim2=2)
    assert torch.count_nonzero(own) == 0
    assert torch.count_nonzero(nets[:, :, na:]) == 0
    assert torch.count_nonzero(nets[:, max(0, na - lo):]) == 0
    bit_equal = float((gw == pw).double().mean())
    del ref_w, mag_w, tol_w, pw, pb

    # forward and backward in a CUDA graph: replays bit-equal to eager
    outs = [torch.empty_like(gw), torch.empty_like(gb)]
    wg, bg = w0.detach().requires_grad_(), b0.detach().requires_grad_()

    def body():
        dw, db = torch.autograd.grad(cfl.first_layer(wg, bg, y, seeds, lo,
                                                     na), (wg, bg), g)
        outs[0].copy_(dw)
        outs[1].copy_(db)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(2):
        for t in outs:
            t.fill_(float('nan'))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], gw) and torch.equal(outs[1], gb)
    del graph, outs
    return dict(grad_w_gap=gap_w, plain_grad_w_gap=plain_gap_w,
                grad_b_gap=gap_b, grad_w_bit_equal_share=bit_equal,
                fwd_bwd_bytes_held=held, masked_input_bytes=masked_bytes)


def _first_layer_times(w0, b0, y, seeds, lo, na) -> dict:
    """Kernel, plain and library times of one case (see the phase)."""
    from pgmvae_tpu_torch.ops import cuda_first_layer as cfl
    s, f = seeds or 1, w0.shape[0] // (seeds or 1)
    b, n, o = y.shape[-2], y.shape[-1], w0.shape[-1]
    mask = cfl.first_layer_mask(w0, y, seeds, lo, na)
    x = (y.view(s, 1, b, n) * mask).view(s * f, b, n)

    def kernel():
        cfl.first_layer(w0, b0, y, seeds, lo, na)

    def plain():
        cfl.first_layer_plain(w0, b0, y, seeds, lo, na)

    def library():
        torch.baddbmm(b0, x, w0)
    flops = 2.0 * s * b * n * f * o
    nbytes = 4.0 * (s * f * n * o + s * b * n + s * f * b * o)
    bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES) * 1e3
    dev = device_ms(kernel)
    times = dict(ms=cuda_ms(kernel), device_ms=dev, plain_ms=cuda_ms(plain),
                 plain_device_ms=device_ms(plain), library_ms=cuda_ms(library),
                 library_device_ms=device_ms(library), bound_ms=bound_ms,
                 bound_by='operations' if flops / FP32_FLOPS
                 > nbytes / HBM_BYTES else 'bytes',
                 bound_share=bound_ms / dev,
                 achieved_tflops=flops / (dev * 1e-3) / 1e12)
    del x
    if (s, f, b, n) == (1, 1058, 250, 1058):
        g = torch.randn((f, b, o), device='cuda')
        wk = w0.detach().requires_grad_()
        bk = b0.detach().requires_grad_()

        def step(fn):
            def run():
                torch.autograd.grad(fn(wk, bk, y, seeds, lo, na), (wk, bk),
                                    g)
            return run
        times.update(
            fwd_bwd_device_ms=device_ms(step(cfl.first_layer), 5),
            plain_fwd_bwd_device_ms=device_ms(step(cfl.first_layer_plain),
                                              5))
    return times


def _bbc_like_splits(n_var: int):
    """Synthetic binary data at bbc's split sizes: independent columns with
    sparse, word-frequency-like rates, made with numpy from SEED."""
    from pgmvae_tpu_torch.registry import REGISTRY
    info = REGISTRY['bbc']
    rng = np.random.default_rng(SEED)
    rate = rng.beta(0.5, 8.0, size=n_var)
    return {split: (rng.random((rows, n_var)) < rate).astype(np.float32)
            for split, rows in (('train', info.n_train),
                                ('valid', info.n_valid),
                                ('test', info.n_test))}


def _stage2_plls(s2, params, codebook, splits):
    dist = s2.cpt(params, codebook, splits['train'])
    out, secs = {}, {}
    for split, y in splits.items():
        t0 = time.time()
        out[split] = s2.pseudo_log_likelihood(params, codebook, y, dist)
        secs[split] = time.time() - t0
    return dist, out, secs


def _chunk_codes(s2, params, codebook, y):
    """(z, kernel codes, plain codes) of a split, chunked exactly as
    Stage2.counts chunks it, so z is bit-equal to the stage-2 run's."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import cuda_vq
    rows = -(-y.shape[0] // s2.chunk) * s2.chunk
    yp = torch.zeros((rows, y.shape[1]), device='cuda')
    yp[:y.shape[0]] = torch.from_numpy(y).cuda()
    zs, ks, ps = [], [], []
    with torch.no_grad():
        for start in range(0, rows, s2.chunk):
            z = vqvae.encode(params, yp[start:start + s2.chunk],
                             activation=s2.cfg.activation,
                             first_layer=s2.cfg.first_layer)
            zs.append(z)
            ks.append(cuda_vq.vq_codes_fused(z, codebook))
            ps.append(cuda_vq.vq_codes_plain(z, codebook))
    return torch.cat(zs, 1), torch.cat(ks, 1), torch.cat(ps, 1)


def phase_slice():
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig, init_model
    from pgmvae_tpu_torch.ops import cuda_vq, kernels
    from pgmvae_tpu_torch.registry import default_units
    from pgmvae_tpu_torch.serving import PgmModel
    from pgmvae_tpu_torch.stage2 import Stage2, select_parents

    n_var = 1058            # the flagship bbc model (RESULTS.md): K=50 D=20
    cfg = VqVaeConfig(n_var=n_var, units=default_units(n_var, 20), dim=20,
                      num_codes=50, fan_mode='per_network', quantizer='ema')
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    params, codebook = init_model(gen, cfg)
    splits = _bbc_like_splits(n_var)
    parents = select_parents(splits['train'], 4)
    torch.cuda.synchronize()

    # ---- the main path, counted: every kernel launch from here to the read
    kernels.reset()
    t0 = time.time()
    s2 = Stage2(cfg)
    dist, pll, secs = _stage2_plls(s2, params, codebook, splits)
    s2p = Stage2(cfg, parents=parents)
    _, pll_p, secs_p = _stage2_plls(s2p, params, codebook, splits)
    model = PgmModel(cfg, params, codebook, dist)
    y_test = splits['test']
    scores = model.score(y_test)
    codes = model.codes(y_test)
    cond = model.conditional_probability(y_test, np.arange(n_var))
    torch.cuda.synchronize()
    main_seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run

    chunks = sum(-(-y.shape[0] // s2.chunk) for y in splits.values())
    # two stage-2 runs, score and codes; conditional_probability selects
    # its networks (var_ids), so its search has no first-layer kernel
    encodes = 2 * (chunks + -(-splits['train'].shape[0] // s2.chunk)) + 2
    assert launches == _launches(vq_argmin=encodes + 1,
                                 first_layer=encodes), launches
    assert s2.chunk == s2p.chunk == 32, (s2.chunk, s2p.chunk)
    for name, vals in (('pll', pll), ('pll_parents', pll_p)):
        assert all(np.isfinite(v) and v < 0 for v in vals.values()), (
            name, vals)
    # the count path (index_add_, float32 adds in any order on the card)
    # gives the integers of a float64 histogram of the same kernel codes
    y = splits['train']
    n1, n0 = s2p.counts(params, codebook, y)
    cells = _chunk_codes(s2p, params, codebook, y)[1][:, :y.shape[0]]
    words = (y[:, parents].astype(np.int64) << np.arange(4)).sum(-1).T
    cells = cells.cpu().numpy().astype(np.int64) * 16 + words
    for got, labels in ((n1, y.T), (n0, 1.0 - y.T)):
        want = np.zeros((n_var, 50 * 16))
        np.add.at(want, (np.arange(n_var)[:, None], cells),
                  labels.astype(np.float64))
        np.testing.assert_array_equal(got.reshape(n_var, -1), want)
    assert scores.shape == (y_test.shape[0],) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores.mean(), pll['test'], rtol=1e-5)
    assert codes.shape == (y_test.shape[0], n_var) and codes.dtype == np.int32
    assert codes.min() >= 0 and codes.max() < cfg.num_codes
    expect = dist[np.arange(n_var)[:, None], codes.T].astype(np.float32)
    np.testing.assert_array_equal(cond, expect)

    # serving throughput (warm): score() of the whole test split per call
    reps = 10
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        model.score(y_test)
    serve_s = (time.time() - t0) / reps

    # the same stage-2 runs forced through the plain version on the card
    with mock.patch.object(cuda_vq, 'vq_codes_fused', cuda_vq.vq_codes_plain):
        _, pll_plain, _ = _stage2_plls(Stage2(cfg), params, codebook, splits)
        _, pll_p_plain, _ = _stage2_plls(Stage2(cfg, parents=parents),
                                         params, codebook, splits)
    flips, max_gap = 0, 0.0
    for got, ref in ((pll, pll_plain), (pll_p, pll_p_plain)):
        if all(abs(got[s] - ref[s]) <= 1e-9 for s in got):
            continue
        for y in splits.values():       # account for tie-flips, or fail
            z, kc, pc = _chunk_codes(s2, params, codebook, y)
            m, g = near_ties(z, codebook, kc, pc)
            flips, max_gap = flips + m, max(max_gap, g)
        assert flips > 0, (got, ref)
        break
    emit('slice', model=dict(n_var=n_var, units=list(cfg.units), dim=20,
                             num_codes=50, fan_mode='per_network'),
         splits={s: int(y.shape[0]) for s, y in splits.items()},
         chunk=s2.chunk, launches=launches, main_path_seconds=main_seconds,
         pll=pll, pll_parents=pll_p, pll_plain_kernel_off=pll_plain,
         seconds_per_split=secs, seconds_per_split_parents=secs_p,
         score_mean=float(scores.mean()),
         serving_samples_per_s=y_test.shape[0] / serve_s,
         serving_score_ms=serve_s * 1e3, tie_flips_vs_plain=flips,
         tie_flip_max_gap=max_gap)
    profile_run('profile_stage2_test_pll',
                lambda: s2.pseudo_log_likelihood(params, codebook, y_test,
                                                 dist), watch=VQ_NAMES)
    profile_run('profile_serving_score', lambda: model.score(y_test),
                watch=VQ_NAMES)
    return launches, max_gap


def profile_run(phase: str, fn, top: int = 8, watch=()) -> None:
    """Device time by kernel (torch.profiler) of one warm call of fn, and
    the device's busy share of that call's unprofiled wall time; for each
    name in `watch`, the device time and count of the kernels whose name
    holds it. Where no profiler session sees device time, the line says so
    and carries the wall time alone. Returns the line's fields."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3

    def run():
        fn()
        torch.cuda.synchronize()
    averages = _profile(run)
    if averages is None:
        emit(phase, wall_ms=wall_ms, profiler_saw_device=False)
        return {'wall_ms': wall_ms}
    # device-side events only: a host op's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # the same device time by the PyTorch operator that launched it
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in averages
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    watched = {w: [sum(r[1] for r in rows if w in r[0]),
                   sum(r[2] for r in rows if w in r[0])] for w in watch}
    fields = dict(wall_ms=wall_ms, device_ms=device_ms,
                  busy_share=device_ms / wall_ms, watched=watched,
                  top=[[name[:80], ms, count]
                       for name, ms, count in rows[:top]],
                  top_ops=[[name[:60], ms, count]
                           for name, ms, count in ops[:top]])
    emit(phase, **fields)
    return fields


def phase_small_reference():
    """The slice at nltcs width on the CPU (plain version) and on the card
    (kernel), from the same weights and data."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.stage2 import Stage2
    cfg = vqvae.VqVaeConfig(n_var=16, units=(15, 14, 13, 12), dim=10,
                            num_codes=50)
    params, codebook = vqvae.init_model(
        torch.Generator().manual_seed(SEED), cfg, device='cpu')
    gparams = vqvae.map_params(lambda p: p.cuda(), params)
    rng = np.random.default_rng(SEED)
    splits = {s: (rng.random((r, 16)) < rng.random(16)).astype(np.float32)
              for s, r in (('train', 2000), ('valid', 300), ('test', 400))}
    flips, gap = 0, 0.0
    for y in splits.values():
        y = torch.from_numpy(y)
        codes_cpu = vqvae.encode_codes(params, codebook, y, cfg)
        codes_gpu = vqvae.encode_codes(gparams, codebook.cuda(), y.cuda(),
                                       cfg).cpu()
        m, g = near_ties(vqvae.encode(params, y), codebook, codes_gpu,
                         codes_cpu)
        flips, gap = flips + m, max(gap, g)
    _, cpu, _ = _stage2_plls(Stage2(cfg, device='cpu'), params, codebook,
                             splits)
    _, gpu, _ = _stage2_plls(Stage2(cfg), gparams, codebook.cuda(), splits)
    if flips == 0:
        for s in cpu:
            assert abs(cpu[s] - gpu[s]) <= 1e-9, (s, cpu[s], gpu[s])
    emit('small_reference', pll_cpu=cpu, pll_gpu=gpu, code_flips=flips,
         flip_max_gap=gap)
    return gap


def _bbc_train_config():
    """The flagship bbc recipe (RESULTS.md:15) at the JAX package's bbc
    benchmark batch of 250."""
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.registry import default_units
    return VqVaeConfig(n_var=1058, units=default_units(1058, 20), dim=20,
                       num_codes=50, cost=0.05, decay=0.9, quantizer='ema',
                       dead_code_threshold=0.25, fan_mode='per_network')


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def _kernel_vs_plain_step(tr, state, yb, w):
    """One more train step from copies of `state` three ways on the card:
    through the kernels; with the Adam kernel's plain version, which must
    give the same state to 1e-6 relative (both run on the same codes); and
    with both plain versions, which must agree to 1e-6 relative unless the
    codes differ, and then only by near-ties. Returns (max abs difference
    of the Adam-only comparison, max relative difference of the all-plain
    one, code flips, flip gap)."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import cuda_vq, fused_adam, kernels
    from pgmvae_tpu_torch.train import copy_state

    def leaves(st):
        return (vqvae.param_leaves(st.params)
                + vqvae.param_leaves(st.opt_state.mu)
                + vqvae.param_leaves(st.opt_state.nu) + list(st.ema))

    def compare(a, b):
        pairs = list(zip(leaves(a), leaves(b)))
        return (max(float((x - y).abs().max()) for x, y in pairs),
                max(_max_rel(x.float(), y.float()) for x, y in pairs))

    with torch.no_grad():
        z = vqvae.encode(state.params, yb, first_layer=tr.cfg.first_layer)
        cb = tr.codebook(state)
        flips, gap = near_ties(z, cb, cuda_vq.vq_codes_fused(z, cb),
                               cuda_vq.vq_codes_plain(z, cb))
    launches = kernels.counts()
    ker, _ = tr.train_step(copy_state(state), yb, w)
    with mock.patch.object(fused_adam, 'adam_update',
                           fused_adam.adam_update_plain):
        adam_plain, _ = tr.train_step(copy_state(state), yb, w)
        with mock.patch.object(cuda_vq, 'vq_codes_fused',
                               cuda_vq.vq_codes_plain):
            all_plain, _ = tr.train_step(copy_state(state), yb, w)
    # comparison only
    kernels.restore(launches)
    torch.cuda.synchronize()
    adam_abs, adam_rel = compare(ker, adam_plain)
    assert adam_rel <= 1e-6, ('Adam kernel step vs plain', adam_rel)
    _, rel = compare(ker, all_plain)
    if flips == 0:
        assert rel <= 1e-6, ('kernel step vs plain step', rel)
    return adam_abs, rel, flips, gap


def _bbc_init(trainer):
    return trainer.init_state(torch.Generator(device='cuda').manual_seed(SEED))


def phase_train():
    """Stage-1 training at bbc width through both kernels: Trainer.fit for 2
    epochs (14 steps, the last one ragged, restarts at 0.25) with
    adam_impl='pallas', its epochs replayed as a CUDA graph, counted; held
    bit-equal to the eager loop from the same init; a kernel step against a
    plain step; stage-2 PLLs of the trained model; profiles of one warm
    eager step and of one replayed epoch."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer

    cfg = _bbc_train_config()
    splits = _bbc_like_splits(cfg.n_var)
    y = splits['train']
    tr = Trainer(cfg, LR, 250, y.shape[0], adam_impl='pallas')
    state = _bbc_init(tr)
    n_leaves = len(vqvae.param_leaves(state.params))
    mark = _memory_mark()
    ends = []

    def log_fn(epoch, m):            # called after the epoch's host read
        ends.append(time.time())

    # ---- the main path, counted: every kernel launch from here to the read
    kernels.reset()
    t0 = time.time()
    state, hist = tr.fit(state, y, 2, seed=SEED, log_fn=log_fn)
    torch.cuda.synchronize()
    fit_seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    memory = _memory_since(mark)

    steps = 2 * tr.steps_per_epoch
    assert tr.steps_per_epoch == 7 and steps == 14, tr.steps_per_epoch
    assert launches == _train_launches(cfg, steps, 'pallas'), launches
    assert n_leaves == 20, n_leaves
    assert all(np.isfinite(list(m)).all() for m in hist), hist
    assert hist[1].loss < hist[0].loss, hist
    graph = tr.graph_stats['epoch']
    assert graph['replays'] == steps - 1, graph
    warm_s = ends[1] - ends[0]
    eager_ends = []
    hold = _hold_eager(
        tr, _bbc_init,
        lambda t, st: t.fit(st, y, 2, seed=SEED,
                            log_fn=lambda e, m: eager_ends.append(
                                time.time()))[0], state, 'bbc f32')
    eager_warm_s = eager_ends[1] - eager_ends[0]
    yb = torch.from_numpy(y[:250]).cuda()
    w = torch.ones(250, device='cuda')
    adam_abs, rel, flips, gap = _kernel_vs_plain_step(tr, state, yb, w)

    cb = tr.codebook(state)
    dist, pll, secs = _stage2_plls(Stage2(cfg), state.params, cb, splits)
    assert all(np.isfinite(v) and v < 0 for v in pll.values()), pll
    # the trained model for the CMLL phase (the profiles below step on)
    trained = dict(cfg=cfg, params=vqvae.map_params(torch.clone,
                                                    state.params),
                   codebook=cb.clone(), dist=dist, y_test=splits['test'],
                   final_loss=hist[-1].loss)
    emit('train', model=dict(n_var=cfg.n_var, units=list(cfg.units),
                             dim=cfg.dim, num_codes=cfg.num_codes,
                             quantizer=cfg.quantizer, decay=cfg.decay,
                             cost=cfg.cost, dead_code_threshold=0.25,
                             fan_mode=cfg.fan_mode, lr=LR, batch=250,
                             adam_impl='pallas'),
         steps=steps, launches=launches,
         adam_launches_per_step=_adam_per_step(n_leaves),
         fit_seconds=fit_seconds, epoch_metrics=[m._asdict() for m in hist],
         warm_epoch_seconds=warm_s,
         warm_steps_per_s=tr.steps_per_epoch / warm_s,
         warm_samples_per_s=y.shape[0] / warm_s,
         eager_warm_steps_per_s=tr.steps_per_epoch / eager_warm_s,
         capture_ms=graph['capture_ms'], graph_replays=graph['replays'],
         memory_graphs=memory, **hold,
         peak_memory_gb=memory['peak_allocated_gb'],
         adam_kernel_vs_plain_step_max_abs=adam_abs,
         all_kernels_vs_plain_step_max_rel=rel, step_code_flips=flips,
         step_flip_gap=gap, pll_trained=pll, stage2_seconds=secs)
    trained['step'] = profile_run('profile_train_step',
                                  lambda: tr.train_step(state, yb, w),
                                  top=10, watch=VQ_NAMES)
    _profile_epoch_graph('profile_train_epoch_graph', tr, state, y)
    return launches, adam_abs, gap, trained


def _profile_epoch_graph(phase: str, tr, state, y, seeds=None) -> dict:
    """A profile of one replayed epoch (its graph captured by a warm call
    first): the device's busy share under graphs. `seeds` profiles a packed
    epoch. The graphs are released after it."""
    data = torch.as_tensor(y, device='cuda')

    def epoch():
        if seeds is None:
            tr.run_epoch(state, data, tr.epoch_generator(SEED, 0))
        else:
            tr.run_epoch_packed(state, data, [tr.epoch_generator(s, 0)
                                              for s in seeds])
    fields = profile_run(phase, epoch, top=10, watch=VQ_NAMES)
    tr.release_graphs()
    return fields


def _kdd_like_splits():
    """Synthetic binary data at kdd's shape (64 columns, 180092/19907/34955
    rows), made with numpy from SEED: sparse columns driven by 16 shared
    latent factors with 2% noise, one loading for all three splits
    (`data.synthetic.shared_factor_splits`; scripts/synth_kdd.py draws its
    loading per split), so that training has structure to learn and stage
    2 sees it."""
    from pgmvae_tpu_torch.data.synthetic import shared_factor_splits
    return shared_factor_splits('kdd', SEED)


@contextlib.contextmanager
def _uncounted():
    """Kernel launches in the block are comparisons, not the main path:
    the counters are put back after it."""
    from pgmvae_tpu_torch.ops import kernels
    before = kernels.counts()
    try:
        yield
    finally:
        kernels.restore(before)


def _eager_twin(tr):
    """A Trainer like `tr` that runs the eager step loop (no graphs): the
    reference each graph path is held against."""
    from pgmvae_tpu_torch.train import Trainer
    return Trainer(tr.cfg, tr.learning_rate, tr.batch_size, tr.n_train,
                   adam_eps=tr.adam_eps, stream_bytes=tr.stream_bytes,
                   stream_chunk_bytes=tr.stream_chunk_bytes,
                   adam_impl=tr.adam_impl, graphs=False)


def _assert_bit_equal(a, b, what: str) -> int:
    """Every tensor of two port TrainStates equal bit for bit (same dtype);
    returns the number of leaves, else fails with the largest gap."""
    pairs = list(zip(_state_leaves(a), _state_leaves(b), strict=True))
    bad = [(i, float((x.double() - y.double()).abs().max()))
           for i, (x, y) in enumerate(pairs)
           if x.dtype != y.dtype or not torch.equal(x, y)]
    assert not bad, (what, 'leaves differ (index, max abs gap)', bad[:8])
    return len(pairs)


def _memory_mark():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _memory_since(mark) -> dict:
    """Peak allocated and reserved device memory over a run (GB), and
    their growth over what was held when `_memory_mark` was taken."""
    torch.cuda.synchronize()
    alloc, reserved = (torch.cuda.max_memory_allocated(),
                       torch.cuda.max_memory_reserved())
    return {'peak_allocated_gb': alloc / 1e9,
            'peak_reserved_gb': reserved / 1e9,
            'allocated_growth_gb': (alloc - mark[0]) / 1e9,
            'reserved_growth_gb': (reserved - mark[1]) / 1e9}


def _hold_eager(tr, init, fit, graph_state, what: str) -> dict:
    """The eager loop from the same init as a graph run (`fit(trainer,
    state)`), uncounted: every leaf must be bit-equal to `graph_state`.
    Returns the leaves compared, the eager run's seconds and memory."""
    eager = _eager_twin(tr)
    state = init(eager)
    mark = _memory_mark()
    with _uncounted():
        t0 = time.time()
        state = fit(eager, state)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    memory = _memory_since(mark)
    leaves = _assert_bit_equal(graph_state, state, what)
    return {'bit_equal_leaves': leaves, 'eager_seconds': seconds,
            'eager_memory': memory}


def _kdd_config():
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.registry import REGISTRY
    info = REGISTRY['kdd']
    return vqvae.VqVaeConfig(n_var=info.n_var, units=info.units, dim=10,
                             num_codes=4096, cost=KDD_COST, quantizer='ema')


def _kdd_init(trainer):
    return trainer.init_state(KDD_SEED)    # drawn on the CPU, as driver.py


def phase_train_kdd():
    """The kdd sweep's cell at its full width (n_var 64, units 50_40_30_20,
    D=10, K=4096, EMA, batch 32) through both kernels, cut to one epoch of
    200 steps (replayed as a graph) over the first KDD_ROWS rows, a stage-2
    CPT on those rows and the PLL of the whole test split; each part
    counted. The epoch is held bit-equal to the eager loop, and the test
    PLL must rise above the initial model's. Then a kernel step against a
    plain step, the test PLL against a run through the plain version, and
    profiles of one warm eager step and of one replayed epoch."""
    from pgmvae_tpu_torch.ops import cuda_vq, kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer, copy_state

    cfg = _kdd_config()
    splits = _kdd_like_splits()
    y = splits['train'][:KDD_ROWS]
    y_test = splits['test']
    tr = Trainer(cfg, KDD_LR, KDD_BATCH, y.shape[0], adam_impl='pallas')
    state = _kdd_init(tr)
    s2 = Stage2(cfg)
    with _uncounted():                 # the initial model's test PLL
        pll_init = s2.pseudo_log_likelihood(
            state.params, tr.codebook(state), y_test,
            s2.cpt(state.params, tr.codebook(state), y))
    mark = _memory_mark()

    # ---- the training path, counted
    kernels.reset()
    t0 = time.time()
    state, hist = tr.fit(state, y, 1, seed=KDD_SEED)
    torch.cuda.synchronize()
    fit_seconds = time.time() - t0
    launches = kernels.counts()
    # ---- the stage-2 path, counted
    cb = tr.codebook(state)
    kernels.reset()
    t0 = time.time()
    dist = s2.cpt(state.params, cb, y)
    pll_test = s2.pseudo_log_likelihood(state.params, cb, y_test, dist)
    stage2_seconds = time.time() - t0
    s2_all = kernels.counts()
    s2_launches = s2_all['vq_argmin']
    # ---- end of the counted runs
    memory = _memory_since(mark)

    steps = tr.steps_per_epoch
    chunks = -(-y.shape[0] // s2.chunk) + -(-y_test.shape[0] // s2.chunk)
    assert steps == 200 and s2.chunk == 118 and chunks == 55 + 297, (
        steps, s2.chunk, chunks)
    assert launches == _train_launches(cfg, steps, 'pallas'), launches
    assert s2_all == _encodes(chunks), (s2_all, chunks)
    assert all(np.isfinite(list(m)).all() for m in hist), hist
    assert np.isfinite(pll_test) and pll_test < 0, pll_test
    # shared-factor data: the trained state shows in stage 2
    assert pll_test > pll_init, (pll_init, pll_test)
    graph = tr.graph_stats['epoch']
    hold = _hold_eager(tr, _kdd_init,
                       lambda t, st: t.fit(st, y, 1, seed=KDD_SEED)[0],
                       state, 'kdd')

    # the trained state and its CPT for the checkpoint and CMLL phases (the
    # profile below steps on in place)
    trained = dict(tr=tr, state=copy_state(state), dist=dist, splits=splits,
                   pll_test=pll_test, y=y, fit_seconds=fit_seconds)
    yb = torch.from_numpy(y[:KDD_BATCH]).cuda()
    w = torch.ones(KDD_BATCH, device='cuda')
    adam_abs, rel, flips, gap = _kernel_vs_plain_step(tr, state, yb, w)
    with mock.patch.object(cuda_vq, 'vq_codes_fused', cuda_vq.vq_codes_plain):
        pll_plain = s2.pseudo_log_likelihood(state.params, cb, y_test, dist)
    s2_flips, s2_gap = 0, 0.0
    if abs(pll_test - pll_plain) > 1e-9:     # account for tie-flips, or fail
        z, kc, pc = _chunk_codes(s2, state.params, cb, y_test)
        s2_flips, s2_gap = near_ties(z, cb, kc, pc)
        assert s2_flips > 0, (pll_test, pll_plain)
    emit('train_kdd', model=dict(n_var=cfg.n_var, units=list(cfg.units),
                                 dim=cfg.dim, num_codes=cfg.num_codes,
                                 quantizer=cfg.quantizer, decay=cfg.decay,
                                 cost=cfg.cost, fan_mode=cfg.fan_mode,
                                 lr=KDD_LR, batch=KDD_BATCH, seed=KDD_SEED,
                                 adam_impl='pallas'),
         splits={s: int(v.shape[0]) for s, v in splits.items()},
         reduced=[f'200 steps: one epoch over the first {KDD_ROWS} train '
                  f'rows (the sweep: 200 epochs over 180092)',
                  f'stage 2: CPT on those {KDD_ROWS} rows and the PLL of '
                  f'the test split only',
                  'synthetic shared-factor columns, not kdd data'],
         steps=steps, launches=launches, stage2_launches=s2_launches,
         stage2_chunk=s2.chunk, fit_seconds=fit_seconds,
         steps_per_s=steps / fit_seconds, stage2_seconds=stage2_seconds,
         eager_steps_per_s=steps / hold['eager_seconds'],
         capture_ms=graph['capture_ms'], memory_graphs=memory, **hold,
         epoch_metrics=[m._asdict() for m in hist], pll_test=pll_test,
         pll_test_initial=pll_init, pll_move=pll_test - pll_init,
         pll_test_plain_kernel_off=pll_plain,
         adam_kernel_vs_plain_step_max_abs=adam_abs,
         all_kernels_vs_plain_step_max_rel=rel, step_code_flips=flips,
         step_flip_gap=gap, stage2_code_flips=s2_flips,
         stage2_flip_gap=s2_gap)
    profile_run('profile_train_kdd_step',
                lambda: tr.train_step(state, yb, w), top=10, watch=VQ_NAMES)
    _profile_epoch_graph('profile_train_kdd_epoch_graph', tr, state, y)
    return ({'train': launches, 'stage2': s2_all},
            max(gap, s2_gap), adam_abs, trained)


def phase_train_bf16(f32: dict):
    """bf16 compute at bbc width: the `train` phase's 14 steps (2 epochs,
    from its seed, replayed as a graph) with compute_dtype='bf16', counted:
    every step's nearest-code search goes to the kernel's bfloat16 instance
    and none to the float32 one. Held bit-equal to the eager loop. Masters,
    moments and EMA state stay float32, the loss falls and ends within 10%
    of the float32 run's (the JAX package's sanity band,
    tests/test_compute_dtype.py). Then profiles of one warm eager step and
    of one replayed epoch."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.train import Trainer

    cfg = _bbc_train_config()._replace(compute_dtype='bf16')
    y = _bbc_like_splits(cfg.n_var)['train']
    tr = Trainer(cfg, LR, 250, y.shape[0], adam_impl='pallas')
    state = _bbc_init(tr)
    mark = _memory_mark()
    ends = []

    def log_fn(epoch, m):
        ends.append(time.time())

    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    state, hist = tr.fit(state, y, 2, seed=SEED, log_fn=log_fn)
    torch.cuda.synchronize()
    fit_seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    memory = _memory_since(mark)

    assert launches == _train_launches(cfg, 14, 'pallas'), launches
    masters = (vqvae.param_leaves(state.params)
               + vqvae.param_leaves(state.opt_state.mu)
               + vqvae.param_leaves(state.opt_state.nu) + list(state.ema[:3]))
    assert all(t.dtype == torch.float32 for t in masters)
    assert all(np.isfinite(list(m)).all() for m in hist), hist
    assert hist[1].loss < hist[0].loss, hist
    rel = abs(hist[-1].loss - f32['final_loss']) / abs(f32['final_loss'])
    assert rel < 0.1, (hist[-1].loss, f32['final_loss'])
    warm_s = ends[1] - ends[0]
    graph = tr.graph_stats['epoch']
    hold = _hold_eager(tr, _bbc_init,
                       lambda t, st: t.fit(st, y, 2, seed=SEED)[0], state,
                       'bbc bf16')
    yb = torch.from_numpy(y[:250]).cuda()
    w = torch.ones(250, device='cuda')
    step = profile_run('profile_train_bf16_step',
                       lambda: tr.train_step(state, yb, w), top=10,
                       watch=VQ_NAMES)
    replayed = _profile_epoch_graph('profile_train_bf16_epoch_graph', tr,
                                    state, y)
    emit('train_bf16', compute_dtype='bf16', steps=14, launches=launches,
         fit_seconds=fit_seconds, warm_epoch_seconds=warm_s,
         warm_steps_per_s=tr.steps_per_epoch / warm_s,
         epoch_metrics=[m._asdict() for m in hist],
         final_loss_f32=f32['final_loss'], final_loss_rel_gap=rel,
         capture_ms=graph['capture_ms'], memory_graphs=memory, **hold,
         peak_memory_gb=memory['peak_allocated_gb'],
         step_device_ms=step.get('device_ms'),
         f32_step_device_ms=f32['step'].get('device_ms'),
         busy_share_graph=replayed.get('busy_share'))
    return launches


def phase_stream_kdd(kdd: dict):
    """The kdd phase's 200 steps again from the same init, streamed from
    the host (stream_bytes=0, chunks of STREAM_CHUNK_STEPS steps, the last
    ragged; one chunk graph replayed over a static device chunk buffer),
    counted: params, EMA state and moments must be bit-equal to the in-core
    `train_kdd` result. Then in-core, streamed and eager fits in turns for
    steps/s."""
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.train import Trainer

    core, ref, y = kdd['tr'], kdd['state'], kdd['y']
    row = KDD_BATCH * core.cfg.n_var * 4
    tr = Trainer(core.cfg, KDD_LR, KDD_BATCH, y.shape[0], stream_bytes=0,
                 stream_chunk_bytes=STREAM_CHUNK_STEPS * row,
                 adam_impl='pallas')
    state = _kdd_init(tr)
    torch.cuda.synchronize()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    state, _ = tr.fit(state, y, 1, seed=KDD_SEED)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    assert launches == _train_launches(core.cfg, 200, 'pallas'), launches
    leaves = _assert_bit_equal(state, ref, 'streamed vs in-core')
    graph = tr.graph_stats['chunk']
    turns = {'in_core': [], 'streamed': [], 'eager': []}
    trainers = {'in_core': core, 'streamed': tr, 'eager': _eager_twin(core)}
    with _uncounted():
        for name in ('in_core', 'streamed', 'eager', 'eager', 'streamed',
                     'in_core'):
            trainer = trainers[name]
            st = _kdd_init(trainer)
            torch.cuda.synchronize()
            t0 = time.time()
            trainer.fit(st, y, 1, seed=KDD_SEED)
            torch.cuda.synchronize()
            turns[name].append(200 / (time.time() - t0))
    emit('stream_kdd', chunk_steps=STREAM_CHUNK_STEPS,
         chunk_bytes=STREAM_CHUNK_STEPS * row,
         chunks=[min(STREAM_CHUNK_STEPS, 200 - c)
                 for c in range(0, 200, STREAM_CHUNK_STEPS)],
         launches=launches, bit_equal_leaves=leaves, seconds=seconds,
         steps_per_s=200 / seconds, capture_ms=graph['capture_ms'],
         graph_replays=graph['replays'], steps_per_s_in_turns=turns)
    return launches, turns


def phase_packed_kdd(kdd: dict, turns: dict):
    """Seeds PACKED_SEEDS (the kdd seed first) packed, S=4, over the kdd
    phase's rows: one packed step against an unpacked step of each seed
    from the same init (every leaf within 1e-6 of its largest magnitude,
    unless a code flips, and then only on a float64-proven near-tie); then
    200 packed steps replayed as a graph, counted (one nearest-code launch
    and one Adam launch a step for all four seeds) and held
    bit-equal to the eager loop, and the kdd seed's test PLL within 0.1 nat
    of `train_kdd`'s. Then profiles of one warm eager packed step and of
    one replayed packed epoch."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import cuda_vq, kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import copy_state

    tr, y, y_test = kdd['tr'], kdd['y'], kdd['splits']['test']
    seeds = list(PACKED_SEEDS)
    n_seeds, n = len(seeds), tr.cfg.n_var

    def init():
        return tr.init_states_packed(seeds)
    states = init()
    yb = torch.from_numpy(y[:n_seeds * KDD_BATCH]).cuda().view(
        n_seeds, KDD_BATCH, -1)
    w = torch.ones(KDD_BATCH, device='cuda')
    counts = kernels.counts()
    with torch.no_grad():              # the first step's codes, packed
        z_packed = vqvae.encode(tr._step_layout(states, n_seeds).params, yb,
                                seeds=n_seeds)
    packed1, _ = tr.train_step_packed(copy_state(states), yb, w)
    flips, flip_gap, step_gaps = [], 0.0, []
    for s in range(n_seeds):           # each seed against its unpacked step
        one = tr.unpack_seed(states, s)
        cb = tr.codebook(one)
        with torch.no_grad():
            f, g = near_ties(z_packed[s * n:(s + 1) * n], cb,
                             cuda_vq.vq_codes_fused(
                                 z_packed[s * n:(s + 1) * n], cb),
                             cuda_vq.vq_codes_fused(
                                 vqvae.encode(one.params, yb[s]), cb))
        unpacked1, _ = tr.train_step(one, yb[s], w)
        gap = max(float((a.double() - b.double()).abs().max())
                  / max(float(b.double().abs().max()), 1e-30)
                  for a, b in zip(_state_leaves(tr.unpack_seed(packed1, s)),
                                  _state_leaves(unpacked1)))
        if f == 0:
            assert gap <= 1e-6, ('packed vs unpacked step', seeds[s], gap)
        flips.append(f)
        flip_gap = max(flip_gap, g)
        step_gaps.append(gap)
        del unpacked1
    kernels.restore(counts)
    del packed1, z_packed

    states = init()
    mark = _memory_mark()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    states, ms = tr.fit_packed(states, y, 1, seeds)     # reads the metrics
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    memory = _memory_since(mark)
    assert launches == _train_launches(tr.cfg, 200, 'pallas'), launches
    assert np.isfinite(ms.loss).all(), ms
    graph = tr.graph_stats['packed']
    hold = _hold_eager(
        tr, lambda t: t.init_states_packed(seeds),
        lambda t, st: t.fit_packed(st, y, 1, seeds)[0], states, 'packed')
    st = tr.unpack_seed(states, 0)
    cb = tr.codebook(st)
    s2 = Stage2(tr.cfg)
    pll = s2.pseudo_log_likelihood(st.params, cb, y_test,
                                   s2.cpt(st.params, cb, y))
    shift = pll - kdd['pll_test']
    assert np.isfinite(pll) and abs(shift) <= 0.1, (pll, kdd['pll_test'])
    unpacked_sps = [y.shape[0] * s / 200 for s in turns['in_core']]
    packed_sps = n_seeds * y.shape[0] / seconds
    step = profile_run('profile_packed_kdd_step',
                       lambda: tr.train_step_packed(states, yb, w), top=10,
                       watch=VQ_NAMES)
    replayed = _profile_epoch_graph('profile_packed_kdd_epoch_graph', tr,
                                    states, y, seeds)
    emit('packed_kdd', seeds=seeds, steps=200, launches=launches,
         seconds=seconds, step_code_flips_by_seed=flips,
         step_flip_gap=flip_gap, step_max_rel_gap_by_seed=step_gaps,
         pll_test_seed5=pll,
         pll_test_train_kdd=kdd['pll_test'], pll_shift=shift,
         final_loss_by_seed=ms.loss[:, -1].tolist(),
         samples_per_s_packed=packed_sps,
         samples_per_s_unpacked_in_turns=unpacked_sps,
         samples_per_s_train_kdd=y.shape[0] / kdd['fit_seconds'],
         speedup_vs_in_turns=packed_sps / max(unpacked_sps),
         eager_samples_per_s_packed=n_seeds * y.shape[0]
         / hold['eager_seconds'],
         capture_ms=graph['capture_ms'], memory_graphs=memory, **hold,
         busy_share_eager_step=step.get('busy_share'),
         busy_share_graph=replayed.get('busy_share'))
    return launches, flip_gap, pll, ms.loss[:, -1].tolist()


def _state_leaves(st) -> list:
    """Every tensor of a port TrainState, in a fixed order."""
    from pgmvae_tpu_torch.models import vqvae
    opt = st.opt_state
    return (vqvae.param_leaves(st.params) + list(st.ema or ())
            + vqvae.param_leaves(opt.mu) + vqvae.param_leaves(opt.nu)
            + [opt.count, opt.learning_rate, st.step])


def _uniforms(chain, steps: int, seed: int) -> torch.Tensor:
    """Uniforms [steps, blocks, B] for `steps` steps of `chain`, drawn on
    the card up front from a generator seeded `seed`."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return torch.rand((steps, chain.blocks, chain.x.shape[0]), generator=gen,
                      device='cuda')


def _gibbs_hold(model: dict, p1: int, steps: int):
    """Two eager chains from the same state and the same uniforms for
    `steps` steps, one through the kernel and one through its plain version
    (burn-in 0, so every step after the first counts). Their counts must be
    equal; else the first step at which the chains part must be a code flip
    that is a float64-proven near-tie. Returns (equal, first parting step or
    None, code flips there, their largest gap). Not counted."""
    from pgmvae_tpu_torch import gibbs
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import cuda_vq
    args = (model['params'], model['codebook'], model['cfg'], model['dist'],
            model['y_test'], p1, 0)
    ker = gibbs.GibbsChain(*args, graphs=False)
    plain = gibbs.GibbsChain(*args, graphs=False)
    us = _uniforms(ker, steps, SEED + 1)
    with _uncounted():
        for i in range(steps):
            before = ker.state.clone()
            ker.run(i, 1, us.__getitem__)
            with mock.patch.object(cuda_vq, 'vq_codes_fused',
                                   cuda_vq.vq_codes_plain):
                plain.run(i, 1, us.__getitem__)
            if torch.equal(ker.state, plain.state):
                continue
            # the step's codes both ways, from the state before it
            y = ker.marker + torch.remainder(i, ker.vol)
            sub, cb = vqvae.gather_variables(ker.params, ker.codebook, y)
            with torch.no_grad():
                z = vqvae.encode(sub, before, y, ker.cfg.activation,
                                 ker.cfg.first_layer)
                flips, gap = near_ties(z, cb, cuda_vq.vq_codes_fused(z, cb),
                                       cuda_vq.vq_codes_plain(z, cb))
            assert flips > 0, ('the chains parted without a code flip', i)
            return False, i, flips, gap
    assert torch.equal(ker.counts, plain.counts)
    return True, None, 0, 0.0


def _gibbs_graph_hold(params, codebook, cfg, dist, x, p1: int, steps: int,
                      seed: int) -> dict:
    """A chain replayed as a graph against the eager chain, from the same
    state with the same uniforms for `steps` steps (burn-in 0): state and
    counts must be equal. Not counted. Returns the capture time, and the
    steps/s of a second run of each, in turns."""
    from pgmvae_tpu_torch import gibbs
    chains = {name: gibbs.GibbsChain(params, codebook, cfg, dist, x, p1, 0,
                                     graphs=name == 'graph')
              for name in ('graph', 'eager')}
    us = _uniforms(chains['graph'], steps, seed)
    rates = {'graph': [], 'eager': []}
    with _uncounted():
        for chain in chains.values():
            chain.run(0, steps, us.__getitem__)
        torch.cuda.synchronize()
        g, e = chains['graph'], chains['eager']
        assert torch.equal(g.state, e.state), 'graph vs eager Gibbs state'
        assert torch.equal(g.counts, e.counts), 'graph vs eager counts'
        for name in ('graph', 'eager', 'eager', 'graph'):
            torch.cuda.synchronize()
            t0 = time.time()
            chains[name].run(0, steps, us.__getitem__)
            torch.cuda.synchronize()
            rates[name].append(steps / (time.time() - t0))
    capture_ms = chains['graph'].graph.capture_ms
    chains['graph'].release()
    return {'graph_hold_steps': steps, 'graph_hold_counts_equal': True,
            'capture_ms': capture_ms, 'steps_per_s_in_turns': rates}


def phase_cmll(model: dict):
    """The Gibbs CMLL of the bbc model that `train` trained, through the
    public entry point (its step replayed as a graph), counted: bbc's test
    split, `driver.py`'s p1 = 105 (11 blocks, the last of 8), cut to
    CMLL_SMP sweeps with burn-in CMLL_BURN. Then the kernel's hold against
    the plain version, the graph's hold against the eager chain and a
    profile of a replayed CMLL_SEGMENT-step segment."""
    from pgmvae_tpu_torch import gibbs
    from pgmvae_tpu_torch.ops import kernels
    cfg, y_test = model['cfg'], model['y_test']
    p1 = max(cfg.n_var // 10, 1)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    torch.cuda.synchronize()

    # ---- the main path, counted: every kernel launch from here to the read
    kernels.reset()
    t0 = time.time()
    value = gibbs.conditional_marginal_log_likelihood(
        model['params'], model['codebook'], cfg, model['dist'], y_test,
        p1=p1, num_smp=CMLL_SMP, burn_in=CMLL_BURN, generator=gen)
    seconds = time.time() - t0          # it ends in a read of the device
    launches = kernels.counts()
    # ---- end of the counted run

    steps = CMLL_SMP * p1
    assert p1 == 105 and steps == 2100, p1
    assert launches == _launches(vq_argmin=steps), launches
    assert np.isfinite(value) and value < 0, value
    equal, first, flips, gap = _gibbs_hold(model, p1, CMLL_HOLD)
    held = _gibbs_graph_hold(model['params'], model['codebook'], cfg,
                             model['dist'], y_test, p1, CMLL_HOLD, SEED + 4)
    chain = gibbs.GibbsChain(model['params'], model['codebook'], cfg,
                             model['dist'], y_test, p1, CMLL_BURN)
    assert chain.blocks == 11 and chain.vol_last == 8, chain.blocks
    full = 3000 * p1                    # the driver's 3000 sweeps
    us = _uniforms(chain, CMLL_SEGMENT, SEED + 2)
    replayed = profile_run('profile_cmll_segment',
                           lambda: chain.run(0, CMLL_SEGMENT, us.__getitem__),
                           top=10,
                           watch=VQ_NAMES)
    chain.release()
    emit('cmll', model=dict(n_var=cfg.n_var, units=list(cfg.units),
                            dim=cfg.dim, num_codes=cfg.num_codes),
         rows=int(y_test.shape[0]), p1=p1, blocks=chain.blocks,
         vol_last=chain.vol_last, num_smp=CMLL_SMP, burn_in=CMLL_BURN,
         steps=steps, launches=launches, cmll=value, seconds=seconds,
         steps_per_s=steps / seconds, full_steps=full,
         full_seconds_extrapolated=full * seconds / steps,
         uniform_sub_steps=chain.sub_steps,
         hold_steps=CMLL_HOLD, hold_counts_equal=equal,
         hold_first_parting_step=first, hold_code_flips=flips,
         hold_flip_gap=gap, **held,
         busy_share_graph=replayed.get('busy_share'),
         reduced=[f'{CMLL_SMP} sweeps with burn-in {CMLL_BURN} (the driver: '
                  f'3000 and 150)', 'the 14-step model of phase train',
                  'synthetic independent columns, not bbc data'])
    return launches, gap


def phase_checkpoint(kdd: dict):
    """A checkpoint of the kdd-width model that `train_kdd` trained: save;
    load into a fresh template (every leaf bit-equal); serve the file with
    `PgmModel.from_checkpoint` (the test split's mean score equals the
    stage-2 test PLL to 1e-5 relative) and resume RESUME_STEPS train steps
    from the loaded state, both counted; the same steps from an in-memory
    copy must give the same state bit for bit."""
    from pgmvae_tpu_torch import checkpoint as ckpt
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.serving import PgmModel
    from pgmvae_tpu_torch.train import copy_state

    tr, state, dist = kdd['tr'], kdd['state'], kdd['dist']
    y_test = kdd['splits']['test']
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'kdd.ckpt')
        torch.cuda.synchronize()
        t0 = time.time()
        ckpt.save(path, tr.cfg, state, dist,
                  extra={'identifier': 'kdd-sweep-cell',
                         'pll': {'test': kdd['pll_test']}})
        save_s = time.time() - t0
        nbytes = os.path.getsize(path)
        template = tr.init_state(
            torch.Generator(device='cuda').manual_seed(SEED + 1))
        torch.cuda.synchronize()
        t0 = time.time()
        cfg, loaded, dist2, extra = ckpt.load(path, state_template=template)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        assert cfg == tr.cfg and np.array_equal(dist2, dist), cfg
        assert extra['identifier'] == 'kdd-sweep-cell', extra
        for a, b in zip(_state_leaves(loaded), _state_leaves(state)):
            assert (a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)), (a.shape, a.dtype, b.dtype)
        assert loaded.opt_state.eps == state.opt_state.eps

        # ---- serving from the file, counted
        kernels.reset()
        t0 = time.time()
        scores = PgmModel.from_checkpoint(path).score(y_test)
        serve_s = time.time() - t0
        serve_launches = kernels.counts()['vq_argmin']
        # ---- end of the counted run
    assert serve_launches == 1, serve_launches
    np.testing.assert_allclose(scores.mean(), kdd['pll_test'], rtol=1e-5)

    y = kdd['y']
    w = torch.ones(KDD_BATCH, device='cuda')
    batches = [torch.from_numpy(y[i * KDD_BATCH:(i + 1) * KDD_BATCH]).cuda()
               for i in range(RESUME_STEPS)]
    mem = copy_state(state)
    torch.cuda.synchronize()
    # ---- resumed training from the file, counted
    kernels.reset()
    for yb in batches:
        loaded, _ = tr.train_step(loaded, yb, w)
    torch.cuda.synchronize()
    resume = kernels.counts()
    # ---- end of the counted run; the in-memory twin is the comparison
    with _uncounted():
        for yb in batches:
            mem, _ = tr.train_step(mem, yb, w)
    torch.cuda.synchronize()
    pairs = list(zip(_state_leaves(loaded), _state_leaves(mem)))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    gap = 0.0 if bit_equal else max(_max_rel(a.float(), b.float())
                                    for a, b in pairs)
    assert gap < 1e-6, ('resumed vs in-memory', gap)
    assert resume == _train_launches(tr.cfg, RESUME_STEPS, 'pallas'), resume
    emit('checkpoint', model='kdd sweep cell (phase train_kdd)',
         file_bytes=nbytes, save_seconds=save_s, load_seconds=load_s,
         leaves=len(pairs), load_bit_equal=True,
         serve_rows=int(y_test.shape[0]), serve_seconds=serve_s,
         serve_launches=serve_launches, score_mean=float(scores.mean()),
         pll_test=kdd['pll_test'], resume_steps=RESUME_STEPS,
         resume_launches=resume, resume_bit_equal=bit_equal,
         resume_max_rel_gap=gap)
    return _sum_launches(resume, _encodes(serve_launches))


def phase_cmll_kdd(kdd: dict):
    """The driver's own CMLL at the kdd sweep's width on the model
    `train_kdd` trained, through the public entry point (replayed as a
    graph), counted: p1 = 6 (11 blocks, the last of 4), 3000 sweeps,
    burn-in 150, so 18,000 steps, over the first KDD_CMLL_ROWS test rows.
    Then the graph's hold against the eager chain over those rows, and a
    replayed CMLL_SEGMENT-step segment over the whole test split, timed
    and profiled."""
    from pgmvae_tpu_torch import gibbs
    from pgmvae_tpu_torch.ops import kernels
    tr, state = kdd['tr'], kdd['state']
    cfg, cb = tr.cfg, tr.codebook(state)
    p1 = max(cfg.n_var // 10, 1)
    y_all = kdd['splits']['test']
    y = y_all[:KDD_CMLL_ROWS]
    gen = torch.Generator(device='cuda').manual_seed(KDD_SEED)
    torch.cuda.synchronize()

    # ---- the main path, counted: every kernel launch from here to the read
    kernels.reset()
    t0 = time.time()
    value = gibbs.conditional_marginal_log_likelihood(
        state.params, cb, cfg, kdd['dist'], y, p1=p1, num_smp=3000,
        burn_in=150, generator=gen)
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run

    steps = 3000 * p1
    assert p1 == 6 and steps == 18000, p1
    assert launches == _launches(vq_argmin=steps), launches
    assert np.isfinite(value) and value < 0, value
    held = _gibbs_graph_hold(state.params, cb, cfg, kdd['dist'], y, p1,
                             CMLL_HOLD, SEED + 5)
    chain = gibbs.GibbsChain(state.params, cb, cfg, kdd['dist'], y_all, p1,
                             150)
    assert chain.blocks == 11 and chain.vol_last == 4, chain.blocks
    us = _uniforms(chain, CMLL_SEGMENT, SEED + 3)
    with _uncounted():
        full_s = []
        for _ in range(2):              # the first run captures the step
            torch.cuda.synchronize()
            t0 = time.time()
            chain.run(0, CMLL_SEGMENT, us.__getitem__)
            torch.cuda.synchronize()
            full_s.append(time.time() - t0)
        replayed = profile_run('profile_cmll_kdd_full_split_segment',
                               lambda: chain.run(0, CMLL_SEGMENT,
                                                 us.__getitem__),
                               top=10, watch=VQ_NAMES)
    emit('cmll_kdd', rows=int(y.shape[0]), p1=p1, blocks=chain.blocks,
         vol_last=chain.vol_last, num_smp=3000, burn_in=150, steps=steps,
         launches=launches, cmll=value, seconds=seconds,
         steps_per_s=steps / seconds, **held,
         full_split_rows=int(y_all.shape[0]),
         full_split_uniform_sub_steps=chain.sub_steps,
         full_split_segment_steps=CMLL_SEGMENT,
         full_split_segment_seconds=full_s[1],
         full_split_steps_per_s=CMLL_SEGMENT / full_s[1],
         full_split_first_run_seconds=full_s[0],
         full_split_capture_ms=chain.graph.capture_ms,
         busy_share_graph_full_split=replayed.get('busy_share'),
         reduced=[f'the first {KDD_CMLL_ROWS} of {y_all.shape[0]} test rows '
                  f'(the whole split: one {CMLL_SEGMENT}-step segment, '
                  f'timed)', 'the 200-step model of phase train_kdd',
                  'synthetic shared-factor columns, not kdd data'])
    chain.release()
    return launches


def phase_run_epochs(kdd: dict) -> dict:
    """`run_epochs` and `run_epochs_packed` (the JAX package's public
    multi-epoch entry points) over RUN_EPOCHS kdd epochs on the device
    data, each counted, with its metrics read once ([E, 4] and [S, E, 4]);
    held bit-equal (state and metrics) to `fit` and `fit_packed` from the
    same init, which are not counted."""
    from pgmvae_tpu_torch.ops import kernels
    tr, y = kdd['tr'], kdd['y']
    seeds = list(PACKED_SEEDS)
    data = torch.as_tensor(y, device='cuda')
    steps = RUN_EPOCHS * tr.steps_per_epoch
    out, launches = {}, {}
    for name in ('run_epochs', 'run_epochs_packed'):
        packed = name == 'run_epochs_packed'
        state = tr.init_states_packed(seeds) if packed else _kdd_init(tr)
        torch.cuda.synchronize()
        # ---- the main path, counted
        kernels.reset()
        t0 = time.time()
        if packed:
            state, ms = tr.run_epochs_packed(state, data, seeds, 0,
                                             RUN_EPOCHS)
        else:
            state, ms = tr.run_epochs(state, data, KDD_SEED, 0, RUN_EPOCHS)
        ms = ms.cpu().numpy()
        seconds = time.time() - t0
        launches[name] = kernels.counts()
        # ---- end of the counted run
        tr.release_graphs()
        assert launches[name] == _train_launches(tr.cfg, steps,
                                                 'pallas'), launches
        assert ms.shape == ((len(seeds),) if packed else ()) + (
            RUN_EPOCHS, 4), ms.shape
        with _uncounted():
            if packed:
                ref, hist = tr.fit_packed(tr.init_states_packed(seeds), y,
                                          RUN_EPOCHS, seeds)
                ref_ms = np.stack(hist, -1)
            else:
                ref, hist = tr.fit(_kdd_init(tr), y, RUN_EPOCHS,
                                   seed=KDD_SEED)
                ref_ms = np.array([list(m) for m in hist], np.float32)
        leaves = _assert_bit_equal(state, ref, name + ' vs fit')
        assert np.array_equal(ms, ref_ms), (name, ms, ref_ms)
        out[name] = dict(epochs=RUN_EPOCHS, steps=steps,
                         launches=launches[name], seconds=seconds,
                         steps_per_s=steps / seconds,
                         samples_per_s=(len(seeds) if packed else 1)
                         * RUN_EPOCHS * y.shape[0] / seconds,
                         capture_ms=tr.graph_stats[
                             'packed' if packed else 'epoch']['capture_ms'],
                         bit_equal_leaves=leaves, metrics_equal=True)
    emit('run_epochs', **out)
    return launches


def phase_train_kdd_full(splits: dict) -> dict:
    """One full kdd epoch at realistic size: 180,092 train rows, 5,628
    steps of batch 32 (K=4096, lr 2e-4, cost 0.35, seed 5) through `fit`'s
    graph path, counted, on the shared-factor splits; its wall time and
    steps/s, and the test PLL's move from the initial model's (stage 2 on
    the whole train split, uncounted)."""
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer
    cfg = _kdd_config()
    y, y_test = splits['train'], splits['test']
    tr = Trainer(cfg, KDD_LR, KDD_BATCH, y.shape[0], adam_impl='pallas')
    state = _kdd_init(tr)
    s2 = Stage2(cfg)

    def pll():
        cb = tr.codebook(state)
        return s2.pseudo_log_likelihood(state.params, cb, y_test,
                                        s2.cpt(state.params, cb, y))
    with _uncounted():
        pll_init = pll()
    mark = _memory_mark()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    state, hist = tr.fit(state, y, 1, seed=KDD_SEED)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    memory = _memory_since(mark)
    steps = tr.steps_per_epoch
    assert steps == 5628 and launches == _train_launches(
        cfg, steps, 'pallas'), (steps, launches)
    assert np.isfinite(list(hist[0])).all(), hist
    with _uncounted():
        t1 = time.time()
        pll_after = pll()
        stage2_seconds = time.time() - t1
    assert np.isfinite(pll_after) and pll_after > pll_init, (pll_init,
                                                            pll_after)
    emit('train_kdd_full', rows=int(y.shape[0]), batch=KDD_BATCH,
         steps=steps, launches=launches, seconds=seconds,
         steps_per_s=steps / seconds, samples_per_s=y.shape[0] / seconds,
         capture_ms=tr.graph_stats['epoch']['capture_ms'],
         memory_graphs=memory, epoch_metrics=hist[0]._asdict(),
         pll_test_initial=pll_init, pll_test=pll_after,
         pll_move=pll_after - pll_init, stage2_seconds=stage2_seconds,
         reduced=['one epoch of the sweep cell\'s 200',
                  'synthetic shared-factor columns, not kdd data'])
    return launches


def _write_nltcs_like(root: str) -> None:
    """Synthetic splits at nltcs's shape (16 columns, 16181/2157/3236 rows)
    in the TRW format, from SEED."""
    rng = np.random.default_rng(SEED)
    rate = rng.random(16)
    for split, rows in (('train', 16181), ('valid', 2157), ('test', 3236)):
        y = (rng.random((rows, 16)) < rate).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


# the reference run's flags (ROADMAP.md), epochs and Adam per run
CLI_FLAGS = ['-n', 'nltcs', '-k', '50', '-d', '10', '-b', '128', '-r',
             '0.01', '-c', '0.25', '-m', '-s', '1']


# the sweep runner's packed 2x2 grid (K x seed) and its isolated cell
PIPELINE_FLAGS = ['-n', 'nltcs', '-k', '8,16', '-d', '10', '-b', '128',
                  '-e', '3', '-r', '0.01', '-c', '0.25', '-m', '-s', '1,2',
                  '--pack-seeds', '2', '--adam-impl', 'pallas']
ISOLATE_FLAGS = ['-n', 'nltcs', '-k', '8', '-d', '10', '-b', '128', '-e',
                 '3', '-r', '0.01', '-c', '0.25', '-m', '-s', '3',
                 '--isolate', '--cell-timeout', '300', '--adam-impl',
                 'pallas']
# the kdd sweep's packed command (ROADMAP.md), cut to one epoch
SWEEP_KDD_FLAGS = ['-n', 'kdd', '-k', '4096', '-d', '10', '-b', '32', '-e',
                   '1', '-r', '2e-4', '-c', '0.35', '-m', '-s', '5,6,7,8',
                   '--pack-seeds', '4', '--adam-impl', 'pallas']
# the JAX package's bf16 kdd sweep (ROADMAP, slice 5), cut to one epoch
PACKED_BF16_FLAGS = ['-n', 'kdd', '-k', '4096', '-d', '10', '-b', '32', '-e',
                     '1', '-r', '2e-4', '-c', '0.35', '-m', '-s', '5,6,7,8',
                     '--pack-seeds', '4', '--compute-dtype', 'bf16']


def _cli(tmp: str, flags: list, module=None, base=CLI_FLAGS):
    """One run of a command line (`run`, or `module`'s main) in `tmp` (its
    logs, joblog and result.txt land there), counted: (exit code, its
    result lines, launches, seconds)."""
    from pgmvae_tpu_torch import run
    from pgmvae_tpu_torch.ops import kernels
    module = module or run
    result = os.path.join(tmp, 'result.txt')
    seen = 0
    if os.path.exists(result):
        with open(result) as f:
            seen = len(f.read().splitlines())
    cwd = os.getcwd()
    os.chdir(tmp)
    # ---- the main path, counted
    kernels.reset()
    try:
        t0 = time.time()
        rc = module.main(base + flags + ['--data-dir', tmp])
        seconds = time.time() - t0
    finally:
        os.chdir(cwd)
    launches = kernels.counts()
    # ---- end of the counted run
    lines = []
    if os.path.exists(result):
        with open(result) as f:
            lines = f.read().splitlines()[seen:]
    return rc, lines, launches, seconds


def phase_cli():
    """The command line end to end on the card, on nltcs-shaped data, each
    run counted: the reference run's flags with the Adam kernel for 3
    epochs; the same with --checkpoint and --cmll; --resume from that file
    for 1 epoch; --adam-impl fused_bf16 (the kernel's bfloat16 variant);
    --compute-dtype bf16 (the nearest-code kernel's bfloat16 instance);
    --profile for 1 epoch (its trace read back). Then
    PgmModel.from_checkpoint serves the file, and the sweep runner
    runs a packed 2x2 grid (pk-2 lines), the same command again (no cell
    runs) and one --isolate cell (in its own process on the card)."""
    from pgmvae_tpu_torch.data.loader import load_split
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.serving import PgmModel
    from pgmvae_tpu_torch.utils.logging import run_identifier
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_nltcs_like(tmp)
        path = os.path.join(tmp, 'm.ckpt')
        for name, epochs, flags in (
                ('pallas', 3, ['--adam-impl', 'pallas']),
                ('checkpoint_cmll', 3, ['--adam-impl', 'pallas',
                                        '--checkpoint', path, '--cmll']),
                ('resume', 1, ['--adam-impl', 'pallas', '--resume', path]),
                ('fused_bf16', 3, ['--adam-impl', 'fused_bf16']),
                ('compute_bf16', 3, ['--adam-impl', 'pallas',
                                     '--compute-dtype', 'bf16'])):
            rc, lines, launches, seconds = _cli(tmp, ['-e', str(epochs)]
                                                + flags)
            assert rc == 0 and len(lines) == 1, (name, rc, lines)
            ident, rest = lines[0].split(' ', 1)
            fields = {k: float(v) for k, v in
                      (kv.split(':') for kv in rest.split())}
            runs[name] = dict(identifier=ident, result=fields,
                              launches=launches, seconds=seconds)
        # --profile: a torch.profiler trace of a 1-epoch run in its log
        # directory (counted like the 1-epoch resume run)
        rc, lines, prof_launches, prof_s = _cli(
            tmp, ['-e', '1', '--adam-impl', 'pallas', '--profile'])
        assert rc == 0 and len(lines) == 1, (rc, lines)
        with open(os.path.join(tmp, 'logs', 'tuning',
                               lines[0].split(' ', 1)[0], 'trace.json')) as f:
            events = json.load(f)['traceEvents']
        trace = dict(events=len(events), seconds=prof_s,
                     launches=prof_launches,
                     aten_ops=sum('aten::' in str(e.get('name'))
                                  for e in events),
                     kernel_events=sum(e.get('cat') == 'kernel'
                                       for e in events),
                     vq_argmin_events=sum('vq_argmin_kernel'
                                          in str(e.get('name'))
                                          for e in events))
        assert trace['aten_ops'] > 0, trace
        y_test = load_split('nltcs', 'test', tmp)
        # ---- serving the checkpoint, counted
        kernels.reset()
        scores = PgmModel.from_checkpoint(path).score(y_test)
        served = kernels.counts()
        serve_launches = served['vq_argmin']
        # ---- end of the counted run
        sweep = _sweep(tmp)
    for name, r in runs.items():
        epochs = 1 if name == 'resume' else 3
        expect = run_identifier(
            'nltcs', 50, 10, 128, epochs, 0.01, 0.25, True, 0.99, 1,
            adam_impl='fused_bf16' if name == 'fused_bf16' else 'pallas',
            compute_dtype='bf16' if name == 'compute_bf16' else 'f32')
        assert r['identifier'] == expect, (name, r['identifier'], expect)
        plls = [r['result'][k] for k in ('pll-train', 'pll-valid',
                                         'pll-test')]
        assert all(np.isfinite(v) and v < 0 for v in plls), (name, plls)
        cmll = r['result']['cmll-test']
        if name == 'checkpoint_cmll':
            assert np.isfinite(cmll) and cmll != 1 and cmll < 0, cmll
        else:
            assert cmll == 1, (name, cmll)
    assert runs['pallas']['identifier'].endswith('_ad-pallas')
    assert runs['fused_bf16']['identifier'].endswith('_ad-fused_bf16')
    assert runs['compute_bf16']['identifier'].endswith('_cd-bf16')
    # launches: the CMLL's 3000 steps (p1 = 1), one epoch fewer for the
    # resume; the bfloat16 moments take the variant and only it; bf16
    # compute trains through the bfloat16 instance, stage 2 stays float32
    steps = -(-16181 // 128)
    cfg = VqVaeConfig(n_var=16, units=REGISTRY['nltcs'].encoder_units(10),
                      dim=10, num_codes=50, quantizer='ema')

    def train(n, vq=0):
        """n train steps of the command line's model and `vq` stage-2
        encodes."""
        return _sum_launches(_train_launches(cfg, n, 'pallas'), _encodes(vq))
    vq = {name: r['launches']['vq_argmin'] for name, r in runs.items()}
    assert vq['checkpoint_cmll'] - vq['pallas'] == 3000, vq
    assert vq['pallas'] - vq['resume'] == 2 * steps, vq
    assert vq['fused_bf16'] == vq['pallas'], vq
    assert vq['compute_bf16'] == vq['pallas'] - 3 * steps, vq
    assert {name: r['launches']['vq_argmin_bf16']
            for name, r in runs.items()} == {
        name: 3 * steps if name == 'compute_bf16' else 0 for name in runs}
    # the packed grid: 2 groups of 2 seeds, one launch a step (a nearest-
    # code call, an Adam update; the reconstruction tail two) for both
    # seeds; stage 2 per seed as in an unpacked cell
    stage2 = vq['pallas'] - 3 * steps
    assert sweep['grid']['launches'] == train(2 * 3 * steps,
                                              vq=4 * stage2), sweep
    # the isolated cell ran on the card in its own process, through the
    # three kernels: one launch a step of each, and its stage 2
    iso = sweep['isolate']['cell_process']
    assert iso == {'device': 'cuda:0',
                   'launches': train(3 * steps, vq=stage2)}, iso
    # the first layer's kernel: every float32 train step and stage-2 chunk
    # (the CMLL's Gibbs steps select their networks; bf16 compute trains
    # without it)
    assert {name: r['launches']['first_layer']
            for name, r in runs.items()} == {
        name: stage2 + (0 if name == 'compute_bf16' else
                        (1 if name == 'resume' else 3) * steps)
        for name in runs}, runs
    # every kernel but the searches and the first layer (above), by run
    for name, r in runs.items():
        want = _train_launches(cfg, (1 if name == 'resume' else 3) * steps,
                               'fused_bf16' if name == 'fused_bf16'
                               else 'pallas')
        want = {k: n for k, n in want.items()
                if not k.startswith('vq_argmin') and k != 'first_layer'}
        got = {k: r['launches'][k] for k in want}
        assert got == want, (name, got, want)
    assert serve_launches == served['first_layer'] == 1, served
    assert prof_launches == train(steps, vq=vq['resume'] - steps), \
        prof_launches
    np.testing.assert_allclose(scores.mean(),
                               runs['checkpoint_cmll']['result']['pll-test'],
                               rtol=1e-5)
    emit('cli', runs=runs, serve_launches=serve_launches,
         serve_score_mean=float(scores.mean()), profile_trace=trace,
         sweep=sweep)
    total = {k: sum(r['launches'][k] for r in runs.values())
             + sweep['grid']['launches'][k] + iso['launches'][k]
             + prof_launches[k]
             for k in _launches()}
    total['vq_argmin'] += serve_launches
    total['first_layer'] += served['first_layer']
    return total


def _sweep(tmp: str) -> dict:
    """The sweep runner in `tmp`, each run counted: the packed grid, which
    writes four pk-2 lines; the same command again, which runs no cell; one
    --isolate cell, whose launches are its own process's (this process
    counts none; the cell's joblog record carries the device and launches
    of its process)."""
    from pgmvae_tpu_torch import run_pipeline
    from pgmvae_tpu_torch.utils.logging import run_identifier
    joblog = os.path.join(tmp, 'logs', 'sweep-joblog.jsonl')
    out = {}
    for name, flags in (('grid', PIPELINE_FLAGS), ('resume', PIPELINE_FLAGS),
                        ('isolate', ISOLATE_FLAGS)):
        rc, lines, launches, seconds = _cli(tmp, [], run_pipeline, flags)
        with open(joblog) as f:
            records = [json.loads(line) for line in f]
        out[name] = dict(rc=rc, identifiers=[l.split(' ', 1)[0]
                                             for l in lines],
                         launches=launches, seconds=seconds,
                         joblog_lines=len(records),
                         cell_process=records[-1].get('cell_process'))
        assert rc == 0 and all(r['ok'] for r in records), (name, records)
    grid = [run_identifier('nltcs', k, 10, 128, 3, 0.01, 0.25, True, 0.99,
                           s, adam_impl='pallas', packed_seeds=2)
            for k in (8, 16) for s in (1, 2)]
    assert out['grid']['identifiers'] == grid, out
    assert out['resume']['identifiers'] == [] and set(
        out['resume']['launches'].values()) == {0}, out
    assert out['resume']['joblog_lines'] == 4, out
    assert out['isolate']['identifiers'] == [run_identifier(
        'nltcs', 8, 10, 128, 3, 0.01, 0.25, True, 0.99, 3,
        adam_impl='pallas')] and set(
            out['isolate']['launches'].values()) == {0}, out
    return out


def _write_kdd_csvs(tmp: str, kdd: dict) -> tuple:
    """The kdd phase's KDD_ROWS train rows and the whole valid and test
    splits as kdd's CSVs in `tmp`: (rows by split, seconds)."""
    splits = kdd['splits']
    rows = {'train': kdd['y'], 'valid': splits['valid'],
            'test': splits['test']}
    t0 = time.time()
    for split, y in rows.items():
        np.savetxt(os.path.join(tmp, f'kdd.{split}.data'),
                   y.astype(np.uint8), fmt='%d', delimiter=',')
    return rows, time.time() - t0


def phase_sweep_kdd(kdd: dict, packed_pll: float):
    """The sweep runner's main path at the kdd sweep's width:
    `run_pipeline -n kdd -k 4096 ... -s 5,6,7,8 --pack-seeds 4`, on
    kdd-shaped splits written to disk (the kdd phase's KDD_ROWS train rows,
    the whole valid and test splits), counted: 200 packed steps (one
    nearest-code launch a step and one Adam launch a step for all four
    seeds), then per seed a stage-2 CPT and the three splits' PLLs; four
    pk-4 joblog and result lines; seed 5's test PLL equal to `packed_kdd`'s
    (the same init, data and packed program) within 1e-5 relative, and
    within 0.1 nat of `train_kdd`'s."""
    from pgmvae_tpu_torch import run_pipeline
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.utils.logging import run_identifier
    tr = kdd['tr']
    with tempfile.TemporaryDirectory() as tmp:
        rows, write_s = _write_kdd_csvs(tmp, kdd)
        rc, lines, launches, seconds = _cli(tmp, [], run_pipeline,
                                            SWEEP_KDD_FLAGS)
        with open(os.path.join(tmp, 'logs', 'sweep-joblog.jsonl')) as f:
            records = [json.loads(line) for line in f]
    idents = [run_identifier('kdd', 4096, 10, KDD_BATCH, 1, KDD_LR, KDD_COST,
                             True, 0.99, s, adam_impl='pallas',
                             packed_seeds=4) for s in PACKED_SEEDS]
    assert rc == 0 and [l.split(' ', 1)[0] for l in lines] == idents, (
        rc, lines)
    assert [r['identifier'] for r in records] == idents and all(
        r['ok'] and r['platform'] == 'gpu' for r in records), records
    chunk = Stage2(tr.cfg).chunk
    # per seed: the CPT over the train rows, then each split's PLL
    stage2 = sum(-(-y.shape[0] // chunk)
                 for y in (rows['train'], *rows.values()))
    assert launches == _sum_launches(_train_launches(tr.cfg, 200, 'pallas'),
                                     _encodes(4 * stage2)), launches
    plls = [r['pll_test'] for r in records]
    assert all(np.isfinite(v) and v < 0 for v in plls), plls
    assert abs(plls[0] - packed_pll) <= 1e-5 * abs(packed_pll), (
        plls[0], packed_pll)
    assert abs(plls[0] - kdd['pll_test']) <= 0.1, (plls[0], kdd['pll_test'])
    emit('sweep_kdd', command=SWEEP_KDD_FLAGS,
         splits={s: int(v.shape[0]) for s, v in rows.items()},
         reduced=[f'one epoch over the first {KDD_ROWS} train rows (the '
                  f'sweep: 200 epochs over 180092)',
                  'synthetic independent columns, not kdd data'],
         identifiers=idents, launches=launches,
         stage2_launches_per_seed=stage2,
         write_splits_seconds=write_s, seconds=seconds,
         pll_test_by_seed=plls, pll_test_packed_kdd=packed_pll,
         pll_test_train_kdd=kdd['pll_test'],
         samples_per_sec_packed=records[0]['samples_per_sec_packed'],
         train_wall=records[0]['train_wall'])
    return launches


def phase_packed_kdd_bf16(kdd: dict, f32_losses: list):
    """The JAX package's bf16 kdd sweep at full width, cut to one epoch:
    `run_pipeline -n kdd -k 4096 -d 10 -b 32 -e 1 -r 2e-4 -c 0.35 -m -s
    5,6,7,8 --pack-seeds 4 --compute-dtype bf16` on the kdd phase's rows
    written as CSVs, counted: 200 packed bf16 steps (one launch a step of
    the nearest-code kernel's bfloat16 instance, at (256, 32, 10, 4096),
    and of Adam, for all four seeds), then per seed a float32 stage-2 CPT
    and the three splits' PLLs (the float32 instance only); four pk-4
    cd-bf16 lines with the JAX identifiers and finite PLLs. Then the same
    seeds and rows through `Trainer.fit_packed` with compute_dtype='bf16',
    counted: the replayed epoch bit-equal to the eager loop, masters,
    moments and EMA state float32, each seed's final loss within 10% of
    the float32 packed run's (the JAX package's sanity band,
    tests/test_compute_dtype.py). Last, a profile of one replayed packed
    bf16 epoch and the kernel's share of its device time."""
    from pgmvae_tpu_torch import run_pipeline
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer
    from pgmvae_tpu_torch.utils.logging import run_identifier
    seeds, y = list(PACKED_SEEDS), kdd['y']
    cfg = kdd['tr'].cfg._replace(compute_dtype='bf16')
    with tempfile.TemporaryDirectory() as tmp:
        rows, write_s = _write_kdd_csvs(tmp, kdd)
        rc, lines, cli_launches, cli_s = _cli(tmp, [], run_pipeline,
                                              PACKED_BF16_FLAGS)
        with open(os.path.join(tmp, 'logs', 'sweep-joblog.jsonl')) as f:
            records = [json.loads(line) for line in f]
    idents = [run_identifier('kdd', 4096, 10, KDD_BATCH, 1, KDD_LR, KDD_COST,
                             True, 0.99, s, packed_seeds=4,
                             compute_dtype='bf16') for s in seeds]
    assert rc == 0 and [l.split(' ', 1)[0] for l in lines] == idents, (
        rc, lines)
    assert [r['identifier'] for r in records] == idents and all(
        r['ok'] and r['platform'] == 'gpu' for r in records), records
    chunk = Stage2(cfg).chunk
    stage2 = sum(-(-v.shape[0] // chunk) for v in (rows['train'],
                                                  *rows.values()))
    train = _train_launches(cfg, 200, 'pallas')
    assert cli_launches == _sum_launches(
        train, _encodes(4 * stage2)), cli_launches
    plls = {k: [r[k] for r in records]
            for k in ('pll_train', 'pll_valid', 'pll_test')}
    assert all(np.isfinite(v) and v < 0 for vs in plls.values()
               for v in vs), plls

    tr = Trainer(cfg, KDD_LR, KDD_BATCH, y.shape[0], adam_impl='pallas')
    states = tr.init_states_packed(seeds)
    mark = _memory_mark()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    states, ms = tr.fit_packed(states, y, 1, seeds)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    memory = _memory_since(mark)
    assert launches == train, launches
    masters = (vqvae.param_leaves(states.params)
               + vqvae.param_leaves(states.opt_state.mu)
               + vqvae.param_leaves(states.opt_state.nu)
               + list(states.ema[:3]))
    assert all(t.dtype == torch.float32 for t in masters)
    losses = ms.loss[:, -1].tolist()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses,
                                                strict=True)]
    assert np.isfinite(losses).all() and max(rel) < 0.1, (losses,
                                                          f32_losses)
    graph = tr.graph_stats['packed']
    hold = _hold_eager(
        tr, lambda t: t.init_states_packed(seeds),
        lambda t, st: t.fit_packed(st, y, 1, seeds)[0], states,
        'packed bf16')
    replayed = _profile_epoch_graph('profile_packed_kdd_bf16_epoch_graph',
                                    tr, states, y, seeds)
    kernel_ms = None
    if 'watched' in replayed:
        kernel_ms = (replayed['watched']['vq_argmin_bf16_kernel'][0]
                     + replayed['watched']['vq_merge_kernel'][0])
    emit('packed_kdd_bf16', command=PACKED_BF16_FLAGS, seeds=seeds,
         steps=200, splits={k: int(v.shape[0]) for k, v in rows.items()},
         reduced=[f'one epoch over the first {KDD_ROWS} train rows (the '
                  f'sweep: 200 epochs over 180092)',
                  'synthetic shared-factor columns, not kdd data'],
         identifiers=idents, cli_launches=cli_launches,
         stage2_launches_per_seed=stage2, write_splits_seconds=write_s,
         cli_seconds=cli_s, plls_by_seed=plls, launches=launches,
         seconds=seconds, samples_per_s_packed=len(seeds) * y.shape[0]
         / seconds, final_loss_by_seed=losses,
         final_loss_f32_by_seed=f32_losses, final_loss_rel_gap=rel,
         capture_ms=graph['capture_ms'], memory_graphs=memory, **hold,
         epoch_device_ms=replayed.get('device_ms'),
         kernel_device_ms=kernel_ms,
         kernel_share=None if kernel_ms is None
         else kernel_ms / replayed['device_ms'],
         busy_share_graph=replayed.get('busy_share'))
    return {'cli': cli_launches, 'fit': launches}


# --------------------------------------------------------- the mesh --

MESH_BBC = (2, 4)                 # mesh_bbc: (data, model), 8 ranks
MESH_CLI = ['--mesh-data', '2', '--mesh-model', '2']
SHARED = 'gloo, 8 ranks sharing one H100'
# the first mesh step against one device's, per leaf max|a-b| / max|b|: the
# data axis sums each gradient in two parts, and Adam's first update
# g / (|g| + eps) turns that rounding into a few 1e-6 of a zero-initialised
# bias where |g| is near eps. Readings: 5.58e-6 on the H100 (param11, the
# same in two runs), 1.4e-5 in a CPU rehearsal at n_var 60; the limit sits
# twice above the larger. The leaves past 1e-6 are reported.
FIRST_STEP_NORMWISE = 3e-5


def _mesh_bbc_config():
    """bbc's recipe with its variable axis padded to a multiple of the
    model axis: 1060 networks, 1058 active."""
    return _bbc_train_config()._replace(n_var=1060, n_active=1058)


def _mesh_bbc_batch(splits):
    """The first step's global batch: the first rows of the train split,
    padded to the model's width, and its weights."""
    cfg = _mesh_bbc_config()
    y = np.zeros((250, cfg.n_var), np.float32)
    y[:, :cfg.n_active] = splits['train'][:250]
    return torch.as_tensor(y, device='cuda'), torch.ones(250, device='cuda')


def _step_leaves(st) -> dict:
    """The leaves held after the first step, by name."""
    from pgmvae_tpu_torch.models import vqvae
    out = {f'param{i}': x for i, x in enumerate(vqvae.param_leaves(
        st.params))}
    out.update({f'ema_{f}': getattr(st.ema, f)
                for f in ('codebook', 'counts', 'dw')})
    for m in ('mu', 'nu'):
        out.update({f'{m}{i}': x for i, x in enumerate(
            vqvae.param_leaves(getattr(st.opt_state, m)))})
    return out


def _mesh_bbc_rank(device, splits, out_dir):
    """One rank of mesh_bbc: the layout, stage-2 counts of the initial
    params, the first step (every rank writes its shard for the
    comparison), then Trainer.fit for 2 epochs and stage 2."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import quantizer as q
    from pgmvae_tpu_torch.parallel import MeshContext, make_mesh
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer, copy_state
    torch.cuda.reset_peak_memory_stats(device)
    ctx = MeshContext(make_mesh(*MESH_BBC, device=device))
    cfg = _mesh_bbc_config()
    tr = Trainer(cfg, LR, 250, splits['train'].shape[0], mesh_ctx=ctx,
                 adam_impl='pallas')
    st = tr.init_state(SEED)
    lo, hi = tr.var_range
    layout = {name: (list(x.shape), x.numel() * x.element_size())
              for name, x in _step_leaves(st).items()}
    s2 = Stage2(cfg, mesh_ctx=ctx)
    n1, n0 = s2.counts(st.params, tr.codebook(st), splits['test'])
    yb, w = _mesh_bbc_batch(splits)
    with torch.no_grad(), _uncounted():     # a comparison's codes
        z = vqvae.encode(st.params, ctx.local_rows(yb), lo=lo)
        codes = q.vq_codes(z, tr.codebook(st)).cpu().numpy()
    first, _ = tr.train_step(copy_state(st), yb, w,
                             torch.Generator(device=device).manual_seed(7))
    torch.save({k: v.cpu() for k, v in _step_leaves(first).items()},
               os.path.join(out_dir, f'shard-{ctx.rank}.pt'))
    del first
    torch.cuda.synchronize(device)
    t0 = time.time()
    st, hist = tr.fit(st, splits['train'], 2, seed=SEED)
    torch.cuda.synchronize(device)
    fit_s = time.time() - t0
    cb = tr.codebook(st)
    dist = s2.cpt(st.params, cb, splits['train'])
    pll = s2.pseudo_log_likelihood(st.params, cb, splits['test'], dist)
    return dict(rank=ctx.rank, coords=[ctx.data_rank, ctx.model_rank],
                var_range=[lo, hi], layout=layout,
                counts=(n1, n0) if ctx.rank == 0 else None, codes=codes,
                loss=[m.loss for m in hist], pll_test=pll, fit_s=fit_s,
                steps=2 * tr.steps_per_epoch, chunk=s2.chunk,
                backend=ctx.describe()['backend'],
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)


def _normwise(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| over a leaf (0 for two zero leaves)."""
    gap = float((a.double() - b.double()).abs().max())
    return gap / max(float(b.double().abs().max()), 1e-30) if gap else 0.0


def phase_mesh_bbc():
    """The (2, 4) mesh at full bbc width: 1060 networks (1058 active,
    units 111, D 20, K 50, EMA, restarts at 0.25) on 8 ranks sharing the
    card over gloo, against a single-device twin of the same padded config
    from the same int seed. Holds: each rank's bytes of every stacked leaf
    are the total's quarter, exactly; every rank's first-step params, EMA
    state and moments within FIRST_STEP_NORMWISE of the twin's rows (per
    leaf, max|a-b| / max|b|; the leaves past 1e-6 reported), leaving out
    only the networks whose codes flip by float64-proven near-ties, and
    bit-equal to those of the rank with the same model coordinate on data
    rank 0; stage-2 counts of the initial params bit-equal; after 2 epochs
    the loss within 1e-4 relative and the test PLL within 0.01 nat; the ranks' summed launches as expected. Times are
    those of ranks sharing one card and say nothing of a multi-GPU run."""
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.ops import quantizer as q
    from pgmvae_tpu_torch.parallel import mesh as pmesh
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer, copy_state
    cfg = _mesh_bbc_config()
    splits = _bbc_like_splits(cfg.n_active)
    tr = Trainer(cfg, LR, 250, splits['train'].shape[0], adam_impl='pallas')
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        ranks = pmesh.spawn(_mesh_bbc_rank, (splits, out_dir),
                            world_size=MESH_BBC[0] * MESH_BBC[1],
                            device='cuda:0', timeout=600,
                            collective_timeout=300)
        world_s = time.time() - t0
        res = [r.value for r in ranks]
        launches = pmesh.summed_launches(ranks)

        # the single-device twin: same config, seed, batch and draws
        st = tr.init_state(SEED)
        with _uncounted():
            n1, n0 = Stage2(cfg).counts(st.params, tr.codebook(st),
                                        splits['test'])
            yb, w = _mesh_bbc_batch(splits)
            with torch.no_grad():
                z = vqvae.encode(st.params, yb)
                codes = q.vq_codes(z, tr.codebook(st))
            cb0 = tr.codebook(st).clone()
            first, _ = tr.train_step(copy_state(st), yb, w, torch.Generator(
                device='cuda').manual_seed(7))
        whole = _step_leaves(first)
        del first
        for r in res:                               # the layout, exactly
            for name, (shape, nbytes) in r['layout'].items():
                full = whole[name]
                assert nbytes * MESH_BBC[1] == (full.numel()
                                                * full.element_size()), (
                    name, shape, list(full.shape))
        # codes of the first step: each rank's rows of its networks; a
        # network whose codes flip (on a proven near-tie) is left out of
        # the comparison below, every other network's rows are held
        per = -(-250 // MESH_BBC[0])
        flips, gap, flipped = 0, 0.0, set()
        for r in res:
            (lo, hi), (d, _) = r['var_range'], r['coords']
            rows = slice(d * per, min((d + 1) * per, 250))
            mine = torch.as_tensor(r['codes'][:, :rows.stop - rows.start],
                                   device='cuda')
            ref = codes[lo:hi, rows]
            m, g = near_ties(z[lo:hi, rows].contiguous(), cb0[lo:hi], mine,
                             ref)
            flips, gap = flips + m, max(gap, g)
            flipped.update((lo + (mine != ref).any(1).nonzero()[:, 0])
                           .tolist())
        keep = torch.ones(cfg.n_var, dtype=torch.bool)
        keep[sorted(flipped)] = False
        # every rank's shard, in rank order (data rank 0 first): against
        # the twin's rows, and bit-equal to its data-rank-0 replica
        first_rel, replicas = {}, {}
        for r in res:
            (lo, hi), (d, m) = r['var_range'], r['coords']
            shard = torch.load(os.path.join(out_dir, f'shard-{r["rank"]}.pt'))
            rows = keep[lo:hi]
            for name, x in shard.items():
                if d == 0:
                    replicas[m, name] = x
                else:
                    assert torch.equal(x, replicas[m, name]), (
                        'a data replica drifted', r['rank'], name)
                first_rel[name] = max(first_rel.get(name, 0.0), _normwise(
                    x[rows].to('cuda'), whole[name][lo:hi][rows.cuda()]))
            del shard
        del whole, replicas
    worst = max(first_rel.values())
    over = sorted(((k, v) for k, v in first_rel.items() if v > 1e-6),
                  key=lambda kv: -kv[1])
    assert worst <= FIRST_STEP_NORMWISE, (
        'first mesh step vs one device', over[:5])
    mn1, mn0 = res[0]['counts']
    np.testing.assert_array_equal(mn1, n1)          # bit-equal
    np.testing.assert_array_equal(mn0, n0)

    torch.cuda.synchronize()
    t0 = time.time()
    with _uncounted():
        st, hist = tr.fit(st, splits['train'], 2, seed=SEED)
    torch.cuda.synchronize()
    one_fit_s = time.time() - t0
    s2 = Stage2(cfg)
    with _uncounted():
        cb = tr.codebook(st)
        dist = s2.cpt(st.params, cb, splits['train'])
        pll = s2.pseudo_log_likelihood(st.params, cb, splits['test'], dist)
    loss_rel = abs(res[0]['loss'][-1] - hist[-1].loss) / abs(hist[-1].loss)
    assert loss_rel <= 1e-4, (res[0]['loss'], [m.loss for m in hist])
    assert abs(res[0]['pll_test'] - pll) <= 0.01, (res[0]['pll_test'], pll)
    assert all(r['pll_test'] == res[0]['pll_test'] for r in res)

    steps, chunk, n_ranks = res[0]['steps'], res[0]['chunk'], len(res)
    chunks = sum(-(-splits[s].shape[0] // chunk)
                 for s in ('test', 'train', 'test'))
    expect_vq = n_ranks * (1 + steps + chunks)
    expect_adam = n_ranks * (1 + steps) * _adam_per_step(20)
    assert launches['vq_argmin'] == expect_vq, (launches, expect_vq)
    assert launches['adam'] == expect_adam, (launches, expect_adam)
    assert launches['recon'] == 2 * n_ranks * (1 + steps), launches
    # each rank's networks from its first (lo), on its rows: one first-layer
    # kernel a search
    assert launches['first_layer'] == expect_vq, launches
    # two 'data' ranks: the EMA step is the dense one, all-reduced
    assert launches['ema'] == 0, launches
    emit('mesh_bbc', mesh=list(MESH_BBC), backend=res[0]['backend'],
         timed_as=SHARED, n_var=cfg.n_var, n_active=cfg.n_active,
         units=list(cfg.units), launches=launches,
         first_step_normwise_max=worst, first_step_over_1e6=over,
         first_step_flips=flips, first_step_flip_gap=gap,
         first_step_networks_left_out=sorted(flipped),
         first_step_replicas_bit_equal=True, counts_bit_equal=True,
         loss=res[0]['loss'], loss_one_device=[m.loss for m in hist],
         loss_rel=loss_rel, pll_test=res[0]['pll_test'],
         pll_test_one_device=pll, steps=steps,
         mesh_step_ms=1e3 * max(r['fit_s'] for r in res) / steps,
         one_device_step_ms=1e3 * one_fit_s / steps, world_s=world_s,
         rank_peak_gb=[r['peak_gb'] for r in res])
    return launches


def phase_mesh_dryrun():
    """`dryrun_multichip(8)` on the card: a (4, 2) mesh of 8 ranks sharing
    it over gloo, n_var 18 with 17 active, 2 EMA epochs and stage 2 against
    the single-device replay, and the restart step, at the JAX package's
    tolerances; printed beside MULTICHIP_r05.json's line (the JAX package
    on 8 CPU devices)."""
    from pgmvae_tpu_torch.__graft_entry__ import dryrun_report
    t0 = time.time()
    report = dryrun_report(8, device='cuda')
    seconds = time.time() - t0
    print(report['line'], flush=True)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'MULTICHIP_r05.json')) as f:
        jax_line = json.load(f)['tail'].strip()
    emit('mesh_dryrun', line=report['line'], jax_line=jax_line,
         launches=report['launches'], seconds=seconds)
    # every rank's train step: the reconstruction tail's two kernels and
    # one Adam update (one table of leaves)
    launches = report['launches']
    assert launches['recon'] == 2 * launches['adam'] > 0, launches
    return launches


def _nccl_rank(device, y, graphs):
    """One NCCL rank (a world of one) training the kdd cell for one epoch
    through the mesh step; returns its state and how the epoch ran."""
    from pgmvae_tpu_torch.parallel import MeshContext, make_mesh
    from pgmvae_tpu_torch.train import Trainer
    ctx = MeshContext(make_mesh(1, 1, device=device))
    tr = Trainer(_kdd_config(), KDD_LR, KDD_BATCH, len(y), mesh_ctx=ctx,
                 adam_impl='pallas', graphs=graphs)
    st, hist = tr.fit(_kdd_init(tr), y, 1, seed=KDD_SEED)
    return dict(backend=ctx.describe()['backend'],
                leaves=[x.cpu() for x in _state_leaves(st)],
                loss=hist[0].loss, graph=tr.graph_stats.get('epoch'))


def phase_mesh_nccl(kdd: dict):
    """An NCCL world of one on the kdd cell (200 steps): the mesh step with
    its collectives captured into the epoch's graph, held bit-equal to the
    unmeshed graph run (an all-reduce over one rank changes nothing). If
    the capture fails, the eager mesh step is held instead, and the line
    says so."""
    from pgmvae_tpu_torch.parallel import mesh as pmesh
    from pgmvae_tpu_torch.train import Trainer
    y = kdd['y']
    captured, error = True, None
    try:
        ranks = pmesh.spawn(_nccl_rank, (y, True), world_size=1,
                            device='cuda:0', timeout=300,
                            collective_timeout=120)
    except Exception as e:  # noqa: BLE001 — reported, the eager step held
        captured, error = False, f'{type(e).__name__}: {str(e)[-800:]}'
        ranks = pmesh.spawn(_nccl_rank, (y, False), world_size=1,
                            device='cuda:0', timeout=300,
                            collective_timeout=120)
    got = ranks[0].value
    assert got['backend'] == 'nccl', got['backend']
    with _uncounted():
        tr = Trainer(_kdd_config(), KDD_LR, KDD_BATCH, len(y),
                     adam_impl='pallas')
        st, hist = tr.fit(_kdd_init(tr), y, 1, seed=KDD_SEED)
    ref = _state_leaves(st)
    bad = [i for i, (a, b) in enumerate(zip(got['leaves'], ref, strict=True))
           if not torch.equal(a.to('cuda'), b)]
    assert not bad, ('NCCL mesh epoch vs unmeshed graph epoch', bad[:8])
    steps = tr.steps_per_epoch
    assert ranks[0].launches == _train_launches(tr.cfg, steps, 'pallas'), \
        ranks[0].launches
    emit('mesh_nccl', backend='nccl', world=1, captured=captured,
         capture_error=error, graph=got['graph'], steps=tr.steps_per_epoch,
         loss=got['loss'], loss_unmeshed=hist[0].loss,
         bit_equal_leaves=len(ref), launches=ranks[0].launches)
    return ranks[0].launches


def phase_cli_mesh():
    """The command line with the reference flags and a (2, 2) mesh for one
    epoch on nltcs-shaped splits, and the sweep runner's isolated cell
    with the same mesh: the JAX identifier of the unmeshed run, PLLs within
    0.01 nat of it, the backend and the ranks' devices recorded."""
    from pgmvae_tpu_torch import run_pipeline
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_nltcs_like(tmp)
        rc, lines, _, one_s = _cli(tmp, ['-e', '1', '--adam-impl', 'pallas'])
        assert rc == 0 and len(lines) == 1, (rc, lines)
        ident, rest = lines[0].split(' ', 1)
        one = {k: float(v) for k, v in (kv.split(':') for kv in rest.split())}
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, lines, _, mesh_s = _cli(tmp, ['-e', '1', '--adam-impl',
                                              'pallas'] + MESH_CLI)
        assert rc == 0 and len(lines) == 1, (rc, lines, err.getvalue())
        m_ident, rest = lines[0].split(' ', 1)
        got = {k: float(v) for k, v in (kv.split(':') for kv in rest.split())}
        assert m_ident == ident, (m_ident, ident)
        for k in ('pll-train', 'pll-valid', 'pll-test'):
            assert abs(got[k] - one[k]) <= 0.01, (k, got[k], one[k])
        mesh = json.loads(next(line for line in err.getvalue().splitlines()
                               if line.startswith('mesh: '))[6:])
        assert mesh['backend'] == 'gloo' and mesh['shape'] == [2, 2], mesh
        assert mesh['devices'] == ['cuda:0'] * 4, mesh
        out['cli'] = dict(identifier=ident, pll=got, pll_one_device=one,
                          mesh=mesh, seconds=mesh_s, one_device_s=one_s)

        flags = ['-n', 'nltcs', '-k', '50', '-d', '10', '-b', '128', '-e',
                 '1', '-r', '0.01', '-c', '0.25', '-m', '-s', '1',
                 '--adam-impl', 'pallas', '--isolate', '--cell-timeout',
                 '300'] + MESH_CLI
        rc, lines, _, pipe_s = _cli(tmp, flags, module=run_pipeline, base=[])
        assert rc == 0 and len(lines) == 1, (rc, lines)
        with open(os.path.join(tmp, 'logs', 'sweep-joblog.jsonl')) as f:
            rec = [json.loads(line) for line in f][-1]
        assert rec['ok'] and rec['identifier'] == ident, rec
        assert abs(rec['pll_test'] - one['pll-test']) <= 0.01, rec
        assert rec['mesh']['backend'] == 'gloo', rec['mesh']
        assert rec['mesh']['devices'] == ['cuda:0'] * 4, rec['mesh']
        out['sweep'] = dict(identifier=rec['identifier'],
                            pll_test=rec['pll_test'], mesh=rec['mesh'],
                            cell_process=rec['cell_process'],
                            seconds=pipe_s)
    launches = {k: mesh['launches'][k] + rec['mesh']['launches'][k]
                for k in mesh['launches']}
    # two 'data' ranks: the EMA step is the dense one, all-reduced; every
    # rank's step launches the reconstruction tail's two kernels and one
    # Adam update (one table of leaves)
    assert launches['ema'] == 0, launches
    assert launches['recon'] == 2 * launches['adam'] > 0, launches
    emit('cli_mesh', launches=launches, **out)
    return launches


def _write_csv(path: str, y: np.ndarray, block: int = 1 << 20) -> int:
    """Rows of 0/1 values y [N, n] written in the TRW files' single-char
    CSV layout (2n bytes a row), `block` rows at a time; returns the
    file's bytes."""
    with open(path, 'wb') as f:
        for start in range(0, y.shape[0], block):
            part = y[start:start + block].astype(np.uint8)
            text = np.full((part.shape[0], 2 * part.shape[1]), ord(','),
                           np.uint8)
            text[:, ::2] = part + ord('0')
            text[:, -1] = ord('\n')
            text.tofile(f)
    return os.path.getsize(path)


def phase_native_csv():
    """The port's native CSV parser, built here from native/fastcsv.cpp,
    against the numpy path on a CSV of kdd's train size (180,092 x 64):
    equal arrays, and the seconds of each path."""
    from pgmvae_tpu_torch.data import loader, native
    from pgmvae_tpu_torch.registry import REGISTRY
    info = REGISTRY['kdd']
    rng = np.random.default_rng(SEED)
    y = (rng.random((info.n_train, info.n_var)) < 0.1).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'kdd.train.data')
        _write_csv(path, y)
        t0 = time.time()
        assert native.available(), native.unavailable()
        build_s = time.time() - t0
        before = native.PARSES
        t0 = time.time()
        got = loader.load_binary_csv(path, info.n_var)
        native_s = time.time() - t0
        assert native.PARSES == before + 1, 'the native path was not taken'
        with mock.patch.object(native, 'parse_binary_csv',
                               lambda *a: None):
            t0 = time.time()
            ref = loader.load_binary_csv(path, info.n_var)
            numpy_s = time.time() - t0
    np.testing.assert_array_equal(got, y)
    np.testing.assert_array_equal(got, ref)
    emit('native_csv', rows=info.n_train, n_var=info.n_var,
         library=native.library_path().name, build_s=build_s,
         native_s=native_s, numpy_s=numpy_s, equal=True)


# sweep_memory: the sweep runner in-process (no --isolate) on kdd-shaped
# splits (the test split cut to KDD_CMLL_ROWS) at K=64, one epoch a cell:
# three cells, a packed pair, a cell with --cmll, two more cells
SWEEP_MEMORY_FLAGS = ['-n', 'kdd', '-k', '64', '-d', '10', '-b', '256',
                      '-e', '1', '-r', '0.01', '-c', '0.25', '-m',
                      '--adam-impl', 'pallas']
SWEEP_MEMORY_GRIDS = (['-s', '1,2,3'], ['-s', '4,5', '--pack-seeds', '2'],
                      ['-s', '6', '--cmll'], ['-s', '7,8'])
SWEEP_MEMORY_SLACK = 64 << 20     # bytes the last cell may hold over the first


def _live_blocks(snapshot: dict) -> list:
    """The live blocks of a `torch.cuda.memory._snapshot()`, grouped by
    their size and the port's frames that allocated them (none: a thread
    without Python frames, as autograd's), with the streams they are on,
    the largest groups first."""
    groups = {}
    for seg in snapshot['segments']:
        for blk in seg['blocks']:
            if blk['state'] != 'active_allocated':
                continue
            frames = tuple(
                f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
                for f in blk.get('frames') or ()
                if 'pgmvae_tpu_torch' in f['filename'])[:3]
            groups.setdefault((blk['size'], frames), []).append(seg['stream'])
    return [{'block_bytes': size, 'blocks': len(streams),
             'streams': len(set(streams)), 'gb': size * len(streams) / 1e9,
             'frames': list(frames)}
            for (size, frames), streams
            in sorted(groups.items(), key=lambda kv: -kv[0][0] * len(kv[1]))]


def phase_sweep_memory() -> dict:
    """The sweep runner's grid run in-process, as users run one, counted:
    `run_pipeline` on kdd-shaped splits written to disk (K=64, one epoch):
    three cells, a packed pair (--pack-seeds 2), a cell with --cmll and two
    more cells, so that train, packed and Gibbs graphs and stage 2's pinned
    pieces all run. After each cell (or packed pair) the device memory
    allocated and reserved; the live blocks after the grid from a memory
    snapshot (by size and allocating frames, with their streams; the
    history is recorded over the grid); then the memory that freeing
    cuBLAS's workspaces gives back. Allocated memory after the last cell
    must be within SWEEP_MEMORY_SLACK of its value after the first, and the
    launches those of the cells' steps, stage-2 chunks and Gibbs steps."""
    import gc

    from pgmvae_tpu_torch import driver, run_pipeline
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.utils.logging import run_identifier
    splits = _kdd_like_splits()
    splits['test'] = splits['test'][:KDD_CMLL_ROWS]
    cells = []
    run_one, run_packed = driver.run_experiment, driver.run_packed_experiments

    def after(results):
        gc.collect()
        torch.cuda.synchronize()
        cells.append({'identifiers': [r['identifier'] for r in results],
                      'allocated_gb': torch.cuda.memory_allocated() / 1e9,
                      'reserved_gb': torch.cuda.memory_reserved() / 1e9})
        return results

    def one(*a, **k):
        return after([run_one(*a, **k)])[0]

    def packed(*a, **k):
        return after(run_packed(*a, **k))
    gc.collect()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.memory._record_memory_history(max_entries=10_000,
                                             stacks='python')
    runs = []
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(driver, 'run_experiment', one), \
            mock.patch.object(driver, 'run_packed_experiments', packed):
        for split, y in splits.items():
            _write_csv(os.path.join(tmp, f'kdd.{split}.data'), y)
        for grid in SWEEP_MEMORY_GRIDS:
            rc, lines, launches, seconds = _cli(tmp, grid, run_pipeline,
                                                SWEEP_MEMORY_FLAGS)
            runs.append(dict(grid=grid, rc=rc, launches=launches,
                             seconds=seconds,
                             identifiers=[l.split(' ', 1)[0]
                                          for l in lines]))
    live = _live_blocks(torch.cuda.memory._snapshot())
    torch.cuda.memory._record_memory_history(enabled=None)
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    workspaces_gb = (held - torch.cuda.memory_allocated()) / 1e9
    torch.cuda.empty_cache()
    growth_gb = cells[-1]['allocated_gb'] - cells[0]['allocated_gb']
    emit('sweep_memory', command=SWEEP_MEMORY_FLAGS, runs=runs,
         splits={k: int(v.shape[0]) for k, v in splits.items()},
         start_allocated_gb=start_gb, cells=cells,
         last_minus_first_gb=growth_gb, live_after_grid=live,
         cublas_workspaces_freed_gb=workspaces_gb,
         after_freeing_gb=torch.cuda.memory_allocated() / 1e9)
    assert all(r['rc'] == 0 for r in runs), runs
    want = [[run_identifier('kdd', 64, 10, 256, 1, 0.01, 0.25, True, 0.99,
                            s, adam_impl='pallas', packed_seeds=pack)
             for s in seeds]
            for seeds, pack in (((1, 2, 3), 1), ((4, 5), 2), ((6,), 1),
                                ((7, 8), 1))]
    assert [r['identifiers'] for r in runs] == want, runs
    assert len(cells) == 7, cells
    assert growth_gb * 1e9 < SWEEP_MEMORY_SLACK, (
        'device memory grows from cell to cell', cells)
    # launches: a cell's steps and stage-2 chunks; the pair's steps once
    # for both seeds; the CMLL's 3000 sweeps of p1 = 6 blocks
    steps = -(-REGISTRY['kdd'].n_train // 256)
    v = [r['launches']['vq_argmin'] for r in runs]
    stage2 = v[0] // 3 - steps
    assert v == [3 * (steps + stage2), steps + 2 * stage2,
                 steps + stage2 + 3000 * 6, 2 * (steps + stage2)], v
    # the first layer's kernel: each search but the CMLL's (its Gibbs
    # steps select their networks)
    assert [r['launches']['first_layer'] for r in runs] == [
        3 * (steps + stage2), steps + 2 * stage2, steps + stage2,
        2 * (steps + stage2)], runs
    # every kernel but the searches and the first layer: the steps of 3,
    # 1, 1 and 2 cells
    for r, cells_run in zip(runs, (3, 1, 1, 2), strict=True):
        want = _train_launches(_kdd_config(), cells_run * steps, 'pallas')
        want = {k: n for k, n in want.items()
                if not k.startswith('vq_argmin') and k != 'first_layer'}
        assert {k: r['launches'][k] for k in want} == want, (r, want)
    return _sum_launches(*(r['launches'] for r in runs))


# the measurement twins' runs: bench_packed at the kdd sweep's shape, one
# epoch; bench and bench_cmll at their defaults
BENCH_PACKED_FLAGS = ['-n', 'kdd', '-k', '4096', '-d', '10', '-b', '32',
                      '-e', '1', '-s', '4']


def _twin(module, argv: list):
    """One run of a measurement twin's `main(argv)` in-process, counted:
    (exit code, the JSON lines it printed, launches, seconds)."""
    from pgmvae_tpu_torch.ops import kernels
    out = io.StringIO()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    seconds = time.time() - t0
    launches = kernels.counts()
    # ---- end of the counted run
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith('{')]
    return rc, lines, launches, seconds


def _launches(**counts) -> dict:
    """Launch counts by name, as `kernels.counts()` gives them: the
    counters named here, every other counter 0."""
    from pgmvae_tpu_torch.ops import kernels
    names = kernels.counts()
    unknown = set(counts) - set(names)
    assert not unknown, unknown
    return {**dict.fromkeys(names, 0), **counts}


def _train_launches(cfg, steps: int, adam_impl: str) -> dict:
    """The launches of `steps` train steps of `cfg`: one nearest-code call
    a step (the bf16 instance under bf16 compute), one Adam launch a
    table of leaves a step (the bf16-moment variant for fused_bf16), one
    EMA step a step (EMA quantizer), the reconstruction tail's forward
    and backward kernels a step, and the masked first layer's kernel a
    step under float32 compute (one for all packed seeds)."""
    want = _launches()
    if cfg.quantizer == 'ema':
        want['ema'] = steps
    want['recon'] = 2 * steps
    if cfg.compute_dtype == 'f32' and cfg.first_layer == 'masked':
        want['first_layer'] = steps
    want['vq_argmin_bf16' if cfg.compute_dtype == 'bf16'
         else 'vq_argmin'] = steps
    want['adam_bf16' if adam_impl == 'fused_bf16' else 'adam'] = (
        steps * _adam_per_step(4 * (len(cfg.units) + 1)))
    return want


def _encodes(calls: int) -> dict:
    """The launches of `calls` float32 encodes of shared rows (stage 2,
    serving): the first layer's kernel and one nearest-code search each."""
    return _launches(vq_argmin=calls, first_layer=calls)


def _sum_launches(*counts) -> dict:
    """Sums by kernel."""
    return {k: sum(c[k] for c in counts) for k in _launches()}


def phase_bench() -> dict:
    """The measurement twins' main(argv), each counted: `bench` with no
    arguments (the nltcs headline and bench.py's eight cells at full
    width), `bench_packed` at the kdd sweep's shape (S=4, one epoch) and
    `bench_cmll` at its defaults. Each must exit 0 with its record on the
    card, every cell measured (no `_error`), MFU at most 100% of the
    card's peak for its arithmetic, one graph capture per kind and run,
    and the launches its epochs, batches and Gibbs steps imply."""
    from pgmvae_tpu_torch import bench, bench_cmll, bench_packed
    from pgmvae_tpu_torch.models import vqvae
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.stage2 import Stage2
    out, total = {}, []

    rc, lines, launches, seconds = _twin(bench, [])
    assert rc == 0 and len(lines) == 1, (rc, lines)
    line = lines[0]
    assert not [k for k in line if k.endswith('_error')], line
    assert line['platform'] == 'gpu' and line['unit'] == 'samples/sec/chip'
    head = line['headline']
    nltcs = REGISTRY['nltcs']
    steps = 2 * bench.HEADLINE_EPOCHS * -(-nltcs.n_train // 128)
    assert head['launches'] == _train_launches(bench.NLTCS_CFG, steps,
                                               'optax'), head['launches']
    assert head['replays'] == steps - 1, head
    chunk = Stage2(bench.NLTCS_CFG, device='cuda').chunk
    chunks = -(-nltcs.n_train // chunk) + -(-nltcs.n_test // chunk)
    assert head['stage2_launches'] == _encodes(chunks), head
    recorded = [head['launches'], head['stage2_launches']]
    for cell in bench.CELLS:
        rec = line[cell.key]
        rows = (bench.AD_ROWS if cell.data == bench.AD_UNIFORM
                else REGISTRY[cell.data].n_train)
        steps = 2 * cell.epochs * -(-rows // cell.batch)
        want = _train_launches(cell.cfg, steps, cell.adam_impl)
        assert rec['launches'] == want, (cell.key, rec['launches'], want)
        assert rec['replays'] == steps - 1, (cell.key, rec)
        assert rec['samples_per_sec'] > 0, (cell.key, rec)
        assert 0 < rec['mfu_pct'] <= 100, (cell.key, rec)
        assert rec['peak_tflops'] == bench.peak_flops(cell.cfg) / 1e12
        recorded.append(rec['launches'])
    assert launches == _sum_launches(*recorded), (launches, recorded)
    total.append(launches)
    out['bench'] = dict(seconds=seconds, line=line)

    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(tmp, 'bench_packed_torch.jsonl')
        rc, lines, launches, seconds = _twin(
            bench_packed, BENCH_PACKED_FLAGS + ['--out', out_file])
        with open(out_file) as f:
            written = [json.loads(line) for line in f]
    assert rc == 0 and len(lines) == 1 and written == lines, (rc, lines)
    rec = lines[0]
    assert rec['platform'] == 'gpu' and rec['speedup'] > 0, rec
    args = bench_packed.build_parser().parse_args(BENCH_PACKED_FLAGS)
    assert rec['steps_per_epoch'] == -(-REGISTRY['kdd'].n_train
                                       // args.batch), rec
    steps = args.epochs * rec['steps_per_epoch']
    # serial: the warm run and S seeds; packed: warm and timed, one
    # launch a step of each kernel for all S seeds
    want = _train_launches(_kdd_config(), (1 + args.seeds) * steps
                           + 2 * steps, 'optax')
    assert launches == rec['launches'] == want, (launches, want)
    assert rec['graphs']['serial']['replays'] == (
        (1 + args.seeds) * steps - 1), rec
    assert rec['graphs']['packed']['replays'] == 2 * steps - 1, rec
    total.append(launches)
    out['bench_packed'] = dict(seconds=seconds, record=rec)

    rc, lines, launches, seconds = _twin(bench_cmll, [])
    assert rc == 0 and len(lines) == 1, (rc, lines)
    rec = lines[0]
    assert rec['platform'] == 'gpu', rec
    assert np.isfinite(rec['cmll']) and rec['cmll'] < 0, rec
    args = bench_cmll.build_parser().parse_args([])
    p1 = args.vars // 12
    assert rec['steps'] == args.num_smp * p1, rec
    assert rec['blocks'] == -(-args.vars // p1), rec
    cfg = vqvae.VqVaeConfig(n_var=args.vars, units=(70, 50, 30),
                            dim=args.dim, num_codes=args.k)
    # 2 epochs at batch 256, then the two CMLL calls
    want = _train_launches(cfg, 2 * -(-args.samples // 256), 'optax')
    want['vq_argmin'] += 2 * rec['steps']      # two CMLL calls
    assert launches == rec['launches'] == want, (launches, want)
    assert rec['capture_ms_steady'] is not None, rec
    total.append(launches)
    out['bench_cmll'] = dict(seconds=seconds, record=rec)
    # where a bench_cmll step's time goes: a replayed segment of its chain
    # from the same model, profiled (a diagnostic, uncounted)
    from pgmvae_tpu_torch.gibbs import GibbsChain
    with _uncounted():
        cfg, st, tr, data, dist = bench_cmll.model(args, torch.device('cuda'))
        chain = GibbsChain(st.params, tr.codebook(st), cfg, dist, data, p1,
                           args.burn_in)
        us = _uniforms(chain, CMLL_SEGMENT, SEED)
        profile_run('profile_bench_cmll_segment',
                    lambda: chain.run(0, CMLL_SEGMENT, us.__getitem__),
                    top=10, watch=VQ_NAMES)
        chain.release()

    emit('bench', **out)
    return _sum_launches(*total)


def _largest_cuda_tensors(top: int = 8) -> list:
    """[shape, dtype, GB] of the largest CUDA tensors alive (a diagnostic
    of what earlier phases still hold)."""
    import gc
    found = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                storage = obj.untyped_storage()
                found[storage.data_ptr()] = (list(obj.shape), str(obj.dtype),
                                             storage.nbytes() / 1e9)
        except (ReferenceError, RuntimeError):   # dead proxies, sparse
            continue
    return sorted(found.values(), key=lambda t: -t[2])[:top]


def phase_stream_big() -> dict:
    """The out-of-core twin, `bench_streaming`, at its defaults (4.5 GiB:
    18,874,368 x 64 rows of float32, past the Trainer's 4 GiB
    `stream_bytes`), counted through `_twin`: exit 0, its record, the
    launches of the streamed epoch and the in-core comparator's two subset
    epochs, and a streamed peak of device memory, over what earlier phases
    still hold, below half the dataset's bytes (the data never went to
    the card). Then, from the twin's own data and streamed state: an
    in-core fit of the same steps from the same init and seed (the card
    holding all 4.5 GiB; uncounted) must be bit-equal leaf by leaf; and
    stage 2 over the whole split, counted (a CPT and the split's PLL, the
    split fed in pinned pieces): one nearest-code launch a chunk of each
    pass, device memory growth below the same bound, every row counted
    once for every variable, counts equal to those of the split's two
    halves cut off a chunk boundary, a finite PLL, and the largest count
    cell against 2^24 (f32 counts are exact below it)."""
    from pgmvae_tpu_torch import bench_streaming
    from pgmvae_tpu_torch.ops import cuda_vq, kernels
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer

    args = bench_streaming.build_parser().parse_args([])
    cfg = bench_streaming.model_config(args)
    rows = bench_streaming.dataset_rows(args.gib, args.vars)
    assert rows == 18_874_368, rows
    kept, measure = [], bench_streaming.measure

    def keep(*a, **k):               # the twin's data and streamed state
        kept.append(measure(*a, **k))
        return kept[-1]
    # the twin's peaks count what earlier phases still hold: its own share
    # is the growth over this
    held = _memory_mark()
    held_gb = held[0] / 1e9
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(bench_streaming, 'measure', keep):
        out_file = os.path.join(tmp, 'bench_streaming_torch.jsonl')
        rc, lines, launches, seconds = _twin(bench_streaming,
                                             ['--out', out_file])
        with open(out_file) as f:
            written = [json.loads(line) for line in f]
    assert rc == 0 and len(lines) == 1 and written == lines, (rc, lines)
    rec, (_, state, data) = lines[0], kept[0]
    half_gb = data.nbytes / 2 / 1e9
    steps = -(-rows // args.batch)
    sub_steps = -(-min(rows, bench_streaming.SUBSET_ROWS) // args.batch)
    assert (rec['rows'], rec['platform'], steps) == (rows, 'gpu', 73_728)
    want = _train_launches(cfg, steps + 2 * sub_steps, 'optax')
    assert launches == rec['launches'] == want, (launches, want)
    assert rec['peak_gb_streamed'] - held_gb < half_gb, (held_gb, rec)
    assert rec['capture_ms'] is not None, rec
    assert np.isfinite(rec['loss']) and rec['stream_sps'] > 0, rec

    # the in-core fit of the same steps, the card holding the data
    core = Trainer(cfg, 0.001, args.batch, rows,
                   stream_bytes=2 * data.nbytes)
    mark = _memory_mark()
    with _uncounted():
        t0 = time.time()
        ref, _ = core.fit(core.init_state(0), data, 1, seed=1)
        torch.cuda.synchronize()
        core_seconds = time.time() - t0
    core_memory = _memory_since(mark)
    leaves = _assert_bit_equal(state, ref, 'streamed vs in-core, 4.5 GiB')
    core_graph = core.graph_stats['epoch']
    del ref
    torch.cuda.empty_cache()

    # stage 2 over the whole split, its counts kept for the checks
    s2 = Stage2(cfg)
    counted, counts = [], s2.counts

    def keep_counts(*a):
        counted.append(counts(*a))
        return counted[-1]
    s2.counts = keep_counts
    codebook = core.codebook(state)
    mark = _memory_mark()
    # ---- the main path, counted
    kernels.reset()
    t0 = time.time()
    dist = s2.cpt(state.params, codebook, data)
    cpt_seconds = time.time() - t0
    pll = s2.pseudo_log_likelihood(state.params, codebook, data, dist)
    stage2_seconds = time.time() - t0
    s2_launches = kernels.counts()
    # ---- end of the counted run
    s2_memory = _memory_since(mark)
    chunks = -(-rows // s2.chunk)
    assert (s2.chunk, chunks) == (1365, 13_828), (s2.chunk, chunks)
    assert s2_launches == _encodes(2 * chunks), s2_launches
    assert s2_memory['allocated_growth_gb'] < half_gb, s2_memory
    (n1, n0), again = counted
    for a, b in zip(again, (n1, n0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal((n1 + n0).sum(1),
                                  np.full(cfg.n_var, float(rows)))
    assert np.isfinite(pll), pll
    cut = rows // 2 + s2.chunk // 3
    assert cut % s2.chunk, cut
    with _uncounted():
        low, high = (counts(state.params, codebook, part)
                     for part in (data[:cut], data[cut:]))
    np.testing.assert_array_equal(low[0] + high[0], n1)
    np.testing.assert_array_equal(low[1] + high[1], n0)
    largest = float(max(n1.max(), n0.max()))
    del core, state, data, kept
    torch.cuda.empty_cache()
    # a call whose plan splits K into strips launches the kernel and a merge
    strips = cuda_vq.plan(args.vars, args.batch, args.dim, args.k).strips
    emit('stream_big', seconds=seconds, record=rec,
         vq_argmin_kernel_launches_per_train_call=1 if strips == 1 else 2,
         bit_equal_leaves=leaves, in_core_seconds=core_seconds,
         in_core_memory=core_memory,
         in_core_capture_ms=core_graph['capture_ms'],
         in_core_replays=core_graph['replays'],
         peak_gb_bound=half_gb, held_before_gb=held_gb,
         held_before_largest=_largest_cuda_tensors(),
         streamed_growth_gb=rec['peak_gb_streamed'] - held_gb,
         incore_subset_growth_gb=rec['peak_gb_incore_subset'] - held_gb,
         stage2=dict(seconds=stage2_seconds, cpt_seconds=cpt_seconds,
                     chunk=s2.chunk, chunks=chunks, launches=s2_launches,
                     memory=s2_memory, pll=pll, largest_cell=largest,
                     largest_cell_vs_2_24=largest / 2 ** 24,
                     halves_cut=cut, halves_equal=True,
                     rows_counted_once=True),
         nvidia_smi=nvidia_smi())
    return _sum_launches(launches, s2_launches)


# cli_big: the command line on kdd-named splits whose train split is
# stream_big's rows (4.5 GiB as float32, past the Trainer's stream_bytes):
# the reference run's flags cut to kdd's 64 variables, K=64, batch 256 and
# one epoch; valid and test CLI_BIG_EVAL_ROWS rows of uniform bits
CLI_BIG_FLAGS = ['-n', 'kdd', '-k', '64', '-d', '10', '-b', '256', '-e', '1',
                 '--adam-impl', 'pallas']
CLI_BIG_EVAL_ROWS = 4096


def phase_cli_big() -> dict:
    """The command line end to end on a train split past 4 GiB, counted:
    `run -n kdd -k 64 -d 10 -b 256 -e 1 ...` on CSVs written to a temporary
    --data-dir (train: bench_streaming's 18,874,368 x 64 uniform bits from
    numpy seed 0, about 2.4 GB of text), so the native parser reads each
    split, `Trainer.fit` streams the train split from the host and stage 2
    takes it in pinned pieces. It must: parse all three files natively;
    stream the epoch, with device peak growth below half the split's
    float32 bytes; count every train row once for all 64 variables (the
    ones of each column equal to the data's); launch one `vq_argmin` a
    step and a stage-2 chunk of each pass and one `adam` a step; give a
    finite PLL on each split and one result line with the JAX package's
    identifier. The largest count cell is reported against 2^24 (float32
    counts are exact below it) and must stay under it. The files are
    deleted at the end."""
    from pgmvae_tpu_torch import bench_streaming
    from pgmvae_tpu_torch.data import native
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer
    from pgmvae_tpu_torch.utils.logging import run_identifier
    args = bench_streaming.build_parser().parse_args([])
    rows = bench_streaming.dataset_rows(args.gib, args.vars)
    assert (rows, args.vars, REGISTRY['kdd'].n_var) == (18_874_368, 64, 64)
    counted, streamed = [], []
    counts, run_streamed = Stage2.counts, Trainer._run_epoch_streamed

    def keep_counts(self, params, codebook, y):
        counted.append((y.shape[0], self.chunk,
                        counts(self, params, codebook, y)))
        return counted[-1][2]

    def keep_streamed(self, *a):
        streamed.append(self.stream_bytes)
        return run_streamed(self, *a)
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        y = bench_streaming.make_data(rows, args.vars)
        split_bytes = y.nbytes
        ones = y.sum(0, dtype=np.float64)
        csv_bytes = _write_csv(os.path.join(tmp, 'kdd.train.data'), y)
        del y
        for split in ('valid', 'test'):
            _write_csv(os.path.join(tmp, f'kdd.{split}.data'),
                       rng.integers(0, 2, (CLI_BIG_EVAL_ROWS, args.vars)))
        write_s = time.time() - t0
        parses = native.PARSES
        mark = _memory_mark()
        with mock.patch.object(Stage2, 'counts', keep_counts), \
                mock.patch.object(Trainer, '_run_epoch_streamed',
                                  keep_streamed):
            rc, lines, launches, seconds = _cli(tmp, CLI_BIG_FLAGS)
        memory = _memory_since(mark)
        parsed = native.PARSES - parses
        assert rc == 0 and len(lines) == 1, (rc, lines)
        ident = lines[0].split(' ', 1)[0]
        with open(os.path.join(tmp, 'logs', 'tuning', ident,
                               'metrics.jsonl')) as f:
            final = [json.loads(line) for line in f][-1]
    fields = {k: float(v) for k, v in
              (kv.split(':') for kv in lines[0].split(' ', 1)[1].split())}
    expect = run_identifier('kdd', 64, 10, 256, 1, 0.01, 0.25, True, 0.99, 1,
                            adam_impl='pallas')
    largest = max(float(c.max()) for n, _, pair in counted if n == rows
                  for c in pair)
    emit('cli_big', command=CLI_FLAGS + CLI_BIG_FLAGS,
         reduced=['kdd-named 64-variable splits (the reference run: '
                  'nltcs), K=64, batch 256 (there 50, 128): stream_big\'s',
                  'one epoch (the reference run: 100)',
                  f'valid and test: {CLI_BIG_EVAL_ROWS} rows each',
                  'uniform bits, not kdd data'],
         rows=rows, split_gb=split_bytes / 1e9, csv_gb=csv_bytes / 1e9,
         write_seconds=write_s, seconds=seconds, native_parses=parsed,
         streamed_epochs=len(streamed), memory=memory,
         peak_gb_bound=split_bytes / 2 / 1e9, launches=launches,
         counts_calls=[(n, chunk) for n, chunk, _ in counted],
         result=fields, identifier=ident, train_wall=final['train_wall'],
         eval_wall=final['eval_wall'], largest_cell=largest,
         largest_cell_vs_2_24=largest / 2 ** 24, nvidia_smi=nvidia_smi())
    assert parsed == 3, ('the native parser did not take all three', parsed)
    assert streamed == [4 << 30] and split_bytes > streamed[0], streamed
    assert memory['allocated_growth_gb'] < split_bytes / 2 / 1e9, memory
    assert ident == expect, (ident, expect)
    assert all(np.isfinite(fields[k]) and fields[k] < 0
               for k in ('pll-train', 'pll-valid', 'pll-test')), fields
    # stage 2: the CPT and the PLL over train, then valid's and test's PLL
    assert [n for n, _, _ in counted] == [rows, rows, CLI_BIG_EVAL_ROWS,
                                          CLI_BIG_EVAL_ROWS], counted
    for n, _, (n1, n0) in counted[:2]:
        np.testing.assert_array_equal((n1 + n0).sum(1),
                                      np.full(args.vars, float(n)))
        np.testing.assert_array_equal(n1.sum(1), ones)
    assert largest < 2 ** 24, (
        'a count cell reached 2^24: float32 counts are no longer exact',
        largest)
    steps = -(-rows // 256)
    chunks = sum(-(-n // chunk) for n, chunk, _ in counted)
    assert launches == _sum_launches(
        _train_launches(_kdd_config(), steps, 'pallas'),
        _encodes(chunks)), launches
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    t_start = time.time()
    smi = phase_device()
    phase_build()
    phase_native_csv()
    sweep_memory_launches = phase_sweep_memory()
    rows, kernel_err = phase_kernel()
    rows_bf16, kernel_bf16_err = phase_kernel(torch.bfloat16)
    adam_row = phase_kernel_adam()
    adam_bf16_row = phase_kernel_adam(torch.bfloat16)
    ema_rows = phase_kernel_ema()
    recon_rows = phase_kernel_recon()
    first_layer_rows = phase_kernel_first_layer()
    launches, slice_err = phase_slice()
    small_err = phase_small_reference()
    train_launches, train_err, train_gap, trained = phase_train()
    cmll_launches, cmll_gap = phase_cmll(trained)
    bf16_launches = phase_train_bf16(trained)
    del trained
    kdd_launches, kdd_gap, kdd_adam_err, kdd = phase_train_kdd()
    ckpt_launches = phase_checkpoint(kdd)
    cmll_kdd_launches = phase_cmll_kdd(kdd)
    stream_launches, turns = phase_stream_kdd(kdd)
    packed_launches, packed_gap, packed_pll, packed_losses = \
        phase_packed_kdd(kdd, turns)
    sweep_kdd_launches = phase_sweep_kdd(kdd, packed_pll)
    packed_bf16 = phase_packed_kdd_bf16(kdd, packed_losses)
    epochs_launches = phase_run_epochs(kdd)
    nccl_launches = phase_mesh_nccl(kdd)
    splits = kdd['splits']
    del kdd
    full_launches = phase_train_kdd_full(splits)
    del splits
    cli_launches = phase_cli()
    dryrun_launches = phase_mesh_dryrun()
    mesh_bbc_launches = phase_mesh_bbc()
    cli_mesh_launches = phase_cli_mesh()
    bench_launches = phase_bench()
    stream_big_launches = phase_stream_big()
    cli_big_launches = phase_cli_big()
    main_row = rows[('shape',) + MAIN_SHAPE]
    bf16_row = rows_bf16[('shape',) + BF16_MAIN_SHAPE]
    emit('done', seconds=time.time() - t_start, device_ms_by=DEVICE_TIMER)
    by_path = {'serving': launches, 'train': train_launches,
               'train_bf16': bf16_launches,
               'train_kdd': kdd_launches['train'],
               'stage2_kdd': kdd_launches['stage2'], 'cmll': cmll_launches,
               'checkpoint': ckpt_launches, 'cmll_kdd': cmll_kdd_launches,
               'stream_kdd': stream_launches, 'packed_kdd': packed_launches,
               'sweep_kdd': sweep_kdd_launches,
               'packed_kdd_bf16': packed_bf16['cli'],
               'packed_kdd_bf16_fit': packed_bf16['fit'],
               'run_epochs': epochs_launches['run_epochs'],
               'run_epochs_packed': epochs_launches['run_epochs_packed'],
               'train_kdd_full': full_launches, 'cli': cli_launches,
               'mesh_nccl': nccl_launches, 'mesh_dryrun': dryrun_launches,
               'mesh_bbc': mesh_bbc_launches, 'cli_mesh': cli_mesh_launches,
               'bench': bench_launches, 'stream_big': stream_big_launches,
               'sweep_memory': sweep_memory_launches,
               'cli_big': cli_big_launches}
    # each kernel's launches by the paths that made any (the EMA kernel's
    # leave out mesh_bbc, cli_mesh and mesh_dryrun: under two 'data' ranks
    # the step is the dense one)
    paths = {name: {path: n[name] for path, n in by_path.items() if n[name]}
             for name in _launches()}
    # two launches (forward, backward) a training step on every path
    untrained = ('serving', 'stage2_kdd', 'cmll', 'cmll_kdd')
    assert all(n['recon'] for path, n in by_path.items()
               if path not in untrained), paths['recon']
    # the first layer's kernel: every float32 encode of shared rows
    # (training, stage 2, serving); never in a Gibbs step (its networks are
    # a selection) nor under bf16 compute
    assert all(by_path[path]['first_layer'] for path in (
        'serving', 'train', 'train_kdd', 'stage2_kdd', 'packed_kdd',
        'mesh_bbc', 'bench')), paths['first_layer']
    assert not any(by_path[path]['first_layer'] for path in (
        'cmll', 'cmll_kdd', 'train_bf16')), paths['first_layer']
    ema_row = ema_rows[EMA_SHAPES[0]]
    recon_row = recon_rows[tuple(RECON_CASES[1])]
    first_layer_row = first_layer_rows[FIRST_LAYER_CASES[3]]
    timed = ('ms', 'device_ms', 'plain_ms', 'plain_device_ms',
             'bound_ms', 'bound_by', 'library_ms', 'library_device_ms')
    print(json.dumps({'kernels': [{
        'name': 'vq_argmin', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/vq_argmin.cu',
        'replaces': 'pgmvae_tpu/ops/pallas_vq.py:38',
        'launches': sum(paths['vq_argmin'].values()),
        'launches_by_path': paths['vq_argmin'],
        'max_abs_err': max(kernel_err, slice_err, small_err, train_gap,
                           kdd_gap, cmll_gap, packed_gap),
        **{key: main_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': list(MAIN_SHAPE)}, {
        'name': 'vq_argmin_bf16', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/vq_argmin.cu',
        'replaces': 'pgmvae_tpu/ops/pallas_vq.py:38',
        'launches': sum(paths['vq_argmin_bf16'].values()),
        'launches_by_path': paths['vq_argmin_bf16'],
        'max_abs_err': kernel_bf16_err,
        **{key: bf16_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': list(BF16_MAIN_SHAPE)}, {
        'name': 'adam', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/adam.cu',
        'replaces': 'pgmvae_tpu/ops/fused_adam.py:79',
        'launches': sum(paths['adam'].values()),
        'launches_by_path': paths['adam'],
        'max_abs_err': max(train_err, kdd_adam_err),
        **{key: adam_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': adam_row['shapes']}, {
        'name': 'adam_bf16', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/adam.cu',
        'replaces': 'pgmvae_tpu/ops/fused_adam.py:187',
        'launches': sum(paths['adam_bf16'].values()),
        'launches_by_path': paths['adam_bf16'],
        'max_abs_err': 0.0,       # bit-equal to its plain version
        **{key: adam_bf16_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': adam_bf16_row['shapes']}, {
        'name': 'ema_update', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/ema_update.cu',
        'replaces': None,     # the JAX package leaves the step to XLA
        'launches': sum(paths['ema'].values()),
        'launches_by_path': paths['ema'],
        'max_rel': max(max(c['rel'].values()) for row in ema_rows.values()
                       for c in row['cases'].values()),
        **{key: ema_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': ema_row['shape'],
        'shapes_compared': [row['shape'] for row in ema_rows.values()]}, {
        'name': 'recon_loss', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/recon_loss.cu',
        'replaces': None,     # the JAX package leaves the loss to XLA
        'launches': sum(paths['recon'].values()),
        'launches_by_path': paths['recon'],
        'max_grad_rel': max(row['grad_rel'] for row in recon_rows.values()),
        **{key: recon_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': recon_row['shape'],
        'cases_compared': [list(spec) for spec in recon_rows]}, {
        'name': 'first_layer', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/first_layer.cu',
        'replaces': None,     # the JAX package leaves the product to XLA
        'launches': sum(paths['first_layer'].values()),
        'launches_by_path': paths['first_layer'],
        'max_gap': max(row['gaps']['kernel']
                       for row in first_layer_rows.values()),
        **{key: first_layer_row[key] for key in timed},
        'device_ms_by': DEVICE_TIMER,
        'shape': first_layer_row['shape'],
        'cases_compared': [list(spec) for spec in first_layer_rows]}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

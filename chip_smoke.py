#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pgmvae_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds the
kernel against its plain PyTorch version at the shapes of the main path,
drives the serving slice (stage-2 CPT/PLL and PgmModel) at the full width of
the bbc model, and checks what comes out. Each phase prints one JSON line;
any failed check raises, so the script exits non-zero. The last three lines
are the kernel summary, the card's name and power limit as nvidia-smi gives
them, and `{"ok": true, "device": {...}}`.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
HBM_BYTES = 3.35e12     # H100 SXM device memory rate
NEAR_TIE_REL = 1e-5
# (n, B, D, K): the four shapes of tests/test_pallas_vq.py, the slice's own
# (a stage-2 chunk and the bbc test split served at once), one large K
KERNEL_SHAPES = [(3, 9, 5, 7), (5, 32, 8, 130), (4, 17, 10, 50),
                 (2, 64, 16, 1024), (1058, 32, 20, 50), (1058, 330, 20, 50),
                 (1058, 256, 20, 4096)]
MAIN_SHAPE = (1058, 32, 20, 50)   # the stage-2 chunk: most main-path launches


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


def cuda_ms(fn, target_s: float = 0.25) -> float:
    """Mean device time of fn() in ms, by CUDA events over a run of calls
    sized to take about `target_s`, after a warm-up call."""
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


def bound(n: int, b: int, d: int, k: int):
    """Least time (ms) for the argmin's work on an H100 SXM, and its bound."""
    flops_ms = 2.0 * n * b * d * k / FP32_FLOPS * 1e3
    bytes_ms = 4.0 * n * (b * d + d * k + b) / HBM_BYTES * 1e3
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
    emit('device', nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build():
    from pgmvae_tpu_torch.ops import cuda_vq
    t0 = time.time()
    cuda_vq.build()
    seconds = time.time() - t0
    log = cuda_vq.library_path().with_suffix('.log')
    ptxas, dpad = {}, None
    if log.exists():          # absent when the library was already built
        for line in log.read_text().splitlines():
            if 'Compiling entry function' in line and 'kernelILi' in line:
                dpad = line.split('kernelILi')[1].split('E')[0]
            elif dpad and ('Used' in line or 'spill' in line):
                ptxas.setdefault(dpad, []).append(line.split(':', 1)[-1]
                                                  .strip())
    emit('build', seconds=seconds, library=str(cuda_vq.library_path().name),
         ptxas_dpad24=ptxas.get('24'), ptxas_dpad128=ptxas.get('128'))


def phase_kernel():
    from pgmvae_tpu_torch.ops import cuda_vq
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows, max_err = {}, 0.0
    cases = ([('shape', s) for s in KERNEL_SHAPES]
             + [('tie', (1, 8, 4, 12)), ('tie_tiles', (2, 40, 8, 130))])
    for kind, (n, b, d, k) in cases:
        if kind == 'shape':
            z = torch.randn((n, b, d), generator=gen, device='cuda')
            w = torch.randn((n, d, k), generator=gen, device='cuda')
        elif kind == 'tie':          # every code identical
            z = torch.zeros((n, b, d), device='cuda')
            w = torch.ones((n, d, k), device='cuda')
        else:                        # codes 64..127 repeat codes 0..63:
            #                          ties across the kernel's K tiles
            z = torch.randn((n, b, d), generator=gen, device='cuda')
            w = torch.randn((n, d, k), generator=gen, device='cuda')
            w[:, :, 64:128] = w[:, :, 0:64]
        got = cuda_vq.vq_codes_fused(z, w)
        ref = cuda_vq.vq_codes_plain(z, w)
        torch.cuda.synchronize()
        if kind == 'tie':
            assert int(got.max()) == 0 and int(ref.max()) == 0, kind
        elif kind == 'tie_tiles':    # a repeated code scores bit-equal to
            #                          its first copy: the first must win
            assert not bool(((got >= 64) & (got < 128)).any()), kind
        mism, gap = near_ties(z, w, got, ref)
        max_err = max(max_err, gap)
        row = dict(kind=kind, shape=[n, b, d, k], mismatches=mism,
                   max_gap=gap)
        if kind == 'shape':
            w2 = torch.sum(w * w, dim=1, keepdim=True)
            bms, by = bound(n, b, d, k)
            row.update(
                ms=cuda_ms(lambda: cuda_vq.vq_codes_fused(z, w)),
                plain_ms=cuda_ms(lambda: cuda_vq.vq_codes_plain(z, w)),
                library_ms=cuda_ms(
                    lambda: torch.baddbmm(w2, z, w, alpha=-2).argmin(-1)),
                bound_ms=bms, bound_by=by)
        rows[(kind, n, b, d, k)] = row
        emit('kernel', **row)
    return rows, max_err


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
    from pgmvae_tpu_torch.ops import cuda_vq
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
    cuda_vq.LAUNCHES = 0
    t0 = time.time()
    s2 = Stage2(cfg)
    dist, pll, secs = _stage2_plls(s2, params, codebook, splits)
    s2p = Stage2(cfg, parents=parents)
    _, pll_p, secs_p = _stage2_plls(s2p, params, codebook, splits)
    s2s = Stage2(cfg, parents=parents, scatter=True)
    _, pll_s, secs_s = _stage2_plls(s2s, params, codebook, splits)
    model = PgmModel(cfg, params, codebook, dist)
    y_test = splits['test']
    scores = model.score(y_test)
    codes = model.codes(y_test)
    cond = model.conditional_probability(y_test, np.arange(n_var))
    torch.cuda.synchronize()
    main_seconds = time.time() - t0
    launches = cuda_vq.LAUNCHES
    # ---- end of the counted run

    chunks = sum(-(-y.shape[0] // s2.chunk) for y in splits.values())
    assert launches == 3 * (chunks + -(-splits['train'].shape[0]
                                        // s2.chunk)) + 3, launches
    assert s2.chunk == 32 and not s2.scatter and s2p.scatter is False
    for name, vals in (('pll', pll), ('pll_parents', pll_p),
                       ('pll_scatter', pll_s)):
        assert all(np.isfinite(v) and v < 0 for v in vals.values()), (
            name, vals)
    # the scatter path counts the same integers as the one-hot bmm
    assert pll_s == pll_p, (pll_s, pll_p)
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
         pll=pll, pll_parents=pll_p, pll_scatter=pll_s,
         pll_plain_kernel_off=pll_plain, seconds_per_split=secs,
         seconds_per_split_parents=secs_p, seconds_per_split_scatter=secs_s,
         score_mean=float(scores.mean()),
         serving_samples_per_s=y_test.shape[0] / serve_s,
         serving_score_ms=serve_s * 1e3, tie_flips_vs_plain=flips,
         tie_flip_max_gap=max_gap)
    profile_run('profile_stage2_test_pll',
                lambda: s2.pseudo_log_likelihood(params, codebook, y_test,
                                                 dist))
    profile_run('profile_serving_score', lambda: model.score(y_test))
    return launches, max_gap


def profile_run(phase: str, fn, top: int = 8) -> None:
    """Device time by kernel (torch.profiler) of one warm call of fn, and
    the device's busy share of that call's unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a host op's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    emit(phase, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[[name[:80], ms, count] for name, ms, count in rows[:top]])


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


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    t_start = time.time()
    smi = phase_device()
    phase_build()
    rows, kernel_err = phase_kernel()
    launches, slice_err = phase_slice()
    small_err = phase_small_reference()
    main_row = rows[('shape',) + MAIN_SHAPE]
    emit('done', seconds=time.time() - t_start)
    print(json.dumps({'kernels': [{
        'name': 'vq_argmin', 'route': 'cuda',
        'source': 'pgmvae_tpu_torch/ops/csrc/vq_argmin.cu',
        'replaces': 'pgmvae_tpu/ops/pallas_vq.py:38',
        'launches': launches,
        'max_abs_err': max(kernel_err, slice_err, small_err),
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'], 'shape': list(MAIN_SHAPE)}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Benchmark driver of the port: stage-1 training throughput (samples/sec on
one card) on the canonical nltcs configuration (K=50 D=10 bs=128 EMA), then
the large-model cells, as the JAX package's `bench.py` measures them.

    python -m pgmvae_tpu_torch.bench                 # CUDA device 0
    python -m pgmvae_tpu_torch.bench --device -1     # the CPU
    python -m pgmvae_tpu_torch.bench --data-dir DIR  # the TRW CSVs in DIR

Prints ONE JSON line on stdout: `bench.py`'s keys (`metric`, `value`,
`unit`, `vs_baseline`, `platform`, `nltcs_dispatch_bound_sps`, then one dict
a cell with `samples_per_sec`, `gflop_per_sample` and `mfu_pct`), plus
`device` (nvidia-smi's name and power limit), `data`, `peak_tflops`,
`baseline` and `headline`; each cell also has `peak_tflops`, `data`, its
graph's capture ms and replays, its kernel launches and its peak memory.
Diagnostics go to stderr. A cell that raises is recorded as `<key>_error`,
the remaining cells still run, and the process exits 1.

Timing: a warm `run_epochs` from `init_state(1)` with seed 0 (it builds the
kernels and captures the epoch's CUDA graph), then the timed `run_epochs`
of the same state with seed 1, which replays that graph: the clock stops
after the metrics are read to the host and the device is synchronised.
Samples are epochs x rows (the padded rows of the ragged last batch do not
count). A timed window that captured a graph raises.

`mfu_pct` divides the model's FLOP rate (`train_flops_per_sample`) by this
card's peak for the cell's arithmetic: 67 TFLOP/s for float32 (TF32 is off,
and checked) and 989 TFLOP/s for `compute_dtype='bf16'` (H100 SXM). Data:
the TRW CSVs from `--data-dir` or `registry.data_dir()` where they are,
else `data.synthetic.shared_factor_splits` at the registry's split sizes,
labelled in the line; the ad cell trains on uniform random bits, as
`bench.py`'s. `vs_baseline` divides by the TF2 reference's recorded CPU
throughput (`TF2_MEASURED_FALLBACK`, BASELINE.md): TF is not measured here.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback
from typing import NamedTuple, Optional

import numpy as np
import torch

from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
from pgmvae_tpu_torch.ops import kernels
from pgmvae_tpu_torch.registry import REGISTRY, default_units

# bench.py's recorded TF2 reference throughput (scripts/bench_reference_tf.py
# -n nltcs on a CPU host, BASELINE.md); the port has no TF to measure live
TF2_MEASURED_FALLBACK = 37019.2
BASELINE = ('TF2 reference, recorded on a CPU host (BASELINE.md, '
            'TF2_MEASURED_FALLBACK); not measured live')
# H100 SXM peaks: float32 outside the tensor cores (TF32 is off) and bf16
# tensor cores (dense)
FP32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
METRIC = 'stage-1 train throughput (nltcs K=50 D=10 bs=128 EMA)'
HEADLINE_EPOCHS = 64
NLTCS_CFG = VqVaeConfig(n_var=16, units=(15, 14, 13, 12), dim=10,
                        num_codes=50, cost=0.25, decay=0.99,
                        quantizer='ema')


def train_flops_per_sample(cfg) -> float:
    """Analytic model FLOPs per trained sample (the MFU numerator).

    Matmul work per sample per network: 2*in*out per dense layer (encoder
    n->u0..->D, decoder D->..->n in the padded masked design) plus the
    2*D*K quantizer distance contraction; x n_var stacked networks;
    x3 for training (forward + both backward matmul passes)."""
    enc = [cfg.n_var, *cfg.units, cfg.dim]
    dec = [cfg.dim, *reversed(cfg.units), cfg.n_var]
    mm = sum(a * b for a, b in zip(enc[:-1], enc[1:]))
    mm += sum(a * b for a, b in zip(dec[:-1], dec[1:]))
    fwd = cfg.n_var * 2.0 * (mm + cfg.dim * cfg.effective_codes)
    return 3.0 * fwd


def peak_flops(cfg) -> float:
    """The card's peak FLOP/s for the cell's training arithmetic."""
    return BF16_PEAK_FLOPS if cfg.compute_dtype == 'bf16' else FP32_PEAK_FLOPS


class Cell(NamedTuple):
    """One large-model cell of `bench.py`: the model, the dataset whose
    train split it trains on (AD_UNIFORM: bench.py's random bits), and the
    run; `record` leads its result dict."""
    key: str
    label: str
    cfg: VqVaeConfig
    data: str
    batch: int
    lr: float
    epochs: int
    adam_impl: str = 'optax'
    record: Optional[dict] = None


AD_UNIFORM = 'ad-uniform'
AD_ROWS = 2461
BBC_CFG = VqVaeConfig(n_var=1058, units=REGISTRY['bbc'].encoder_units(20),
                      dim=20, num_codes=50, cost=0.05, decay=0.9,
                      quantizer='ema', dead_code_threshold=0.25,
                      fan_mode='per_network')
BBC_BF16 = BBC_CFG._replace(compute_dtype='bf16')
AD_CFG = VqVaeConfig(n_var=1556, units=default_units(1556, 30), dim=30,
                     num_codes=20, quantizer='ema')
# bench.py:194-327, cell for cell
CELLS = (
    Cell('bbc_quality_recipe', 'bbc quality recipe (bs=25)', BBC_CFG, 'bbc',
         25, 0.003, 8, record={
             'identifier': 'bbc_K-50_D-20_bs-25_epk-600_lr-0.003_bta-0.05'
                           '_ema-True_gma-0.9_sd-3-_fm-per_network_dcr-0.25'
                           '_sov-50',
             'pll_test_recorded': -255.648}),
    Cell('bbc_throughput_bs250', 'bbc batch-lifted (bs=250)', BBC_CFG, 'bbc',
         250, 0.003, 16),
    Cell('bbc_bs250_fused_adam', 'bbc bs=250 + fused adam', BBC_CFG, 'bbc',
         250, 0.003, 16, 'fused'),
    Cell('bbc_bs250_bf16', 'bbc bs=250 + fused_bf16 adam + bf16 compute',
         BBC_BF16, 'bbc', 250, 0.003, 16, 'fused_bf16'),
    Cell('bbc_bs500_bf16', 'bbc bs=500 + fused_bf16 adam + bf16', BBC_BF16,
         'bbc', 500, 0.003, 16, 'fused_bf16'),
    Cell('bbc_bs250_rank1_fallback', 'bbc bs=250 + rank1 first layer',
         BBC_CFG._replace(first_layer='rank1'), 'bbc', 250, 0.003, 16),
    Cell('bbc_bs1000_rank1_bf16', 'bbc bs=1000 + rank1 + bf16',
         BBC_BF16._replace(first_layer='rank1'), 'bbc', 1000, 0.003, 16,
         'fused_bf16'),
    Cell('ad_throughput_bs250', 'ad-scale synthetic (n=1556, bs=250)',
         AD_CFG, AD_UNIFORM, 250, 0.001, 16),
)


# ------------------------------------------------------------ helpers --
def resolve_index(index: int) -> Optional[torch.device]:
    """--device: -1 is the CPU, else a CUDA device that must exist; None
    (after saying why on stderr) when it does not."""
    if index == -1:
        return torch.device('cpu')
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= index < count:
        print(f'error: --device {index}: {count} CUDA devices available '
              f'(--device -1 runs on the CPU)', file=sys.stderr)
        return None
    return torch.device(f'cuda:{index}')


def check_tf32() -> None:
    """The f32 cells' peak and codes assume IEEE float32 matmuls."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError('TF32 matmuls are on; the port measures and '
                           'computes in IEEE float32')


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    if device.type != 'cuda':
        return 'cpu'
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', f'--id={device.index or 0}'],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return (f'{torch.cuda.get_device_name(device)} (power limit not '
                f'read: {type(e).__name__})')


def drain(metrics: torch.Tensor) -> torch.Tensor:
    """The metrics on the host, after all queued device work: the port's
    `jax.device_get`."""
    host = metrics.cpu()
    if metrics.device.type == 'cuda':
        torch.cuda.synchronize(metrics.device)
    return host


def graph_check(trainer, kind: str, steps: int) -> dict:
    """The trainer's released graph of `kind` after `steps` steps: one
    capture (the warm-up step of the first epoch) and a replay for every
    other step, else a capture fell inside a timed window. {} without
    graphs (the CPU)."""
    stats = trainer.graph_stats.get(kind)
    if stats is None:
        return {}
    if stats['replays'] != steps - 1:
        raise RuntimeError(f'{kind} graph: {stats["replays"]} replays for '
                           f'{steps} steps: a capture ran inside a timed '
                           f'window')
    return {'capture_ms': stats['capture_ms'], 'replays': stats['replays']}


def reset_peak(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device: torch.device) -> Optional[float]:
    if device.type != 'cuda':
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def timed_epochs(trainer, state, data: torch.Tensor, epochs: int) -> dict:
    """The warm run (seed 0) and the timed run (seed 1) of `epochs` epochs
    from `state`, in place; the timed wall, the last loss, the epoch
    graph's capture and replays (checked: one capture for both runs) and
    the launches of both runs."""
    before = kernels.counts()
    state, m = trainer.run_epochs(state, data, 0, 0, epochs)
    drain(m)
    t0 = time.perf_counter()
    state, m = trainer.run_epochs(state, data, 1, 0, epochs)
    m = drain(m)
    wall = time.perf_counter() - t0
    launches = kernels.since(before)
    trainer.release_graphs()
    return {'wall_s': wall, 'loss': float(m[-1, 0]), 'launches': launches,
            **graph_check(trainer, 'epoch',
                          2 * epochs * trainer.steps_per_epoch)}


# ------------------------------------------------------------- cells --
def bench_model(label, cfg, data_host, batch, lr, epochs, adam_impl='optax',
                device=None) -> dict:
    """Steady-state drained throughput and MFU of one model config (as
    `bench.py`'s), with the graph, launch and memory fields."""
    from pgmvae_tpu_torch.train import Trainer

    trainer = Trainer(cfg, lr, batch, len(data_host), adam_impl=adam_impl,
                      device=device)
    device = trainer.device
    try:
        reset_peak(device)
        state = trainer.init_state(1)
        data = torch.as_tensor(np.asarray(data_host, np.float32),
                               device=device)
        run = timed_epochs(trainer, state, data, epochs)
        memory = peak_gb(device)
    finally:
        # in-process cells must not accumulate device memory (the JAX
        # bench's round-5 lesson on v5e): graphs, pools and tensors go
        trainer.release_graphs()
        del trainer
        state = data = None
        free_device(device)
    sps = epochs * len(data_host) / run['wall_s']
    fps = train_flops_per_sample(cfg)
    peak = peak_flops(cfg)
    mfu = sps * fps / peak
    print(f'{label}: {epochs} epochs (bs={batch}) in {run["wall_s"]:.3f}s '
          f'drained -> {sps:,.0f} samples/sec; model {fps / 1e9:.2f} '
          f'GFLOP/sample -> {sps * fps / 1e12:.2f} TFLOP/s = '
          f'{100 * mfu:.1f}% of {peak / 1e12:.0f} TFLOP/s; capture '
          f'{run.get("capture_ms")} ms (outside the timed run); peak '
          f'allocated {memory} GB; loss={run["loss"]:.5f}', file=sys.stderr)
    return {'samples_per_sec': round(sps, 1),
            'gflop_per_sample': round(fps / 1e9, 3),
            'mfu_pct': round(100 * mfu, 2),
            'peak_tflops': peak / 1e12, 'epochs': epochs, 'batch': batch,
            'steps_per_epoch': -(-len(data_host) // batch),
            'peak_allocated_gb': memory, **run}


def cell_data(cell: Cell, data_dir=None):
    """(train rows, data label) of a cell."""
    from pgmvae_tpu_torch.data.synthetic import load_or_synthesize
    if cell.data == AD_UNIFORM:
        rng = np.random.default_rng(0)
        y = rng.integers(0, 2, size=(AD_ROWS, cell.cfg.n_var))
        return y.astype(np.float32), 'uniform random bits, numpy seed 0'
    splits, label = load_or_synthesize(cell.data, data_dir)
    return splits['train'], label


def run_cell(cell: Cell, data_dir, device) -> dict:
    """{key: result} of one cell, or {key_error: message} if it raised
    (the traceback on stderr); the device memory is freed either way."""
    try:
        y, label = cell_data(cell, data_dir)
        res = bench_model(cell.label, cell.cfg, y, cell.batch, cell.lr,
                          cell.epochs, adam_impl=cell.adam_impl,
                          device=device)
        return {cell.key: {**(cell.record or {}), **res, 'data': label}}
    except Exception as e:  # noqa: BLE001 — one cell must not stop the rest
        traceback.print_exc()
        print(f'{cell.label} failed: {type(e).__name__}: {e}',
              file=sys.stderr)
        return {f'{cell.key}_error': f'{type(e).__name__}: {e}'[:300]}
    finally:
        free_device(device)


def headline(data_dir, device) -> dict:
    """The nltcs cell: HEADLINE_EPOCHS warm epochs, HEADLINE_EPOCHS timed,
    then stage 2's CPT and test PLL (stderr and `headline`)."""
    from pgmvae_tpu_torch.data.synthetic import load_or_synthesize
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer

    splits, label = load_or_synthesize('nltcs', data_dir)
    y, y_test = splits['train'], splits['test']
    cfg = NLTCS_CFG
    trainer = Trainer(cfg, 0.01, 128, len(y), device=device)
    reset_peak(device)
    state = trainer.init_state(1)
    data = torch.as_tensor(y, device=device)
    run = timed_epochs(trainer, state, data, HEADLINE_EPOCHS)
    sps = HEADLINE_EPOCHS * len(y) / run['wall_s']

    before = kernels.counts()
    t1 = time.perf_counter()
    s2 = Stage2(cfg, device=device)
    dist = s2.cpt(state.params, trainer.codebook(state), y)
    pll_test = s2.pseudo_log_likelihood(state.params, trainer.codebook(state),
                                        y_test, dist)
    eval_wall = time.perf_counter() - t1
    stage2_launches = kernels.since(before)
    memory = peak_gb(device)
    fps = train_flops_per_sample(cfg)
    print(f'device={device} steady-state {HEADLINE_EPOCHS} epochs in '
          f'{run["wall_s"]:.3f}s (drained); stage-2 (cpt + test PLL) '
          f'{eval_wall:.3f}s; pll-test={pll_test:.5f}; baseline '
          f'{TF2_MEASURED_FALLBACK:.1f} samples/sec [{BASELINE}]',
          file=sys.stderr)
    del trainer, state, data
    free_device(device)
    return {'samples_per_sec': sps, 'data': label,
            'gflop_per_sample': fps / 1e9,
            'mfu_pct': 100 * sps * fps / peak_flops(cfg),
            'peak_tflops': peak_flops(cfg) / 1e12, 'epochs': HEADLINE_EPOCHS,
            'stage2_s': eval_wall, 'stage2_chunk': s2.chunk,
            'stage2_launches': stage2_launches, 'pll_test': pll_test,
            'peak_allocated_gb': memory, **run}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', '-u', type=int, default=0,
                   help='-1 = CPU; otherwise the index of the CUDA device')
    p.add_argument('--data-dir', default=None,
                   help='directory of the TRW CSVs (default: '
                        'registry.data_dir(), else synthetic splits)')
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_index(args.device)
    if device is None:
        return 2
    check_tf32()
    head = headline(args.data_dir, device)
    sps = head['samples_per_sec']
    extras = {}
    for cell in CELLS:
        extras.update(run_cell(cell, args.data_dir, device))
    print(json.dumps({
        'metric': METRIC,
        'value': round(sps, 1),
        'unit': 'samples/sec/chip',
        'vs_baseline': round(sps / TF2_MEASURED_FALLBACK, 2),
        'platform': 'gpu' if device.type == 'cuda' else 'cpu',
        'nltcs_dispatch_bound_sps': round(sps, 1),
        'device': device_label(device),
        'data': head['data'],
        'peak_tflops': head['peak_tflops'],
        'baseline': BASELINE,
        'headline': head,
        **extras,
    }), flush=True)
    return 1 if any(k.endswith('_error') for k in extras) else 0


if __name__ == '__main__':
    sys.exit(main())

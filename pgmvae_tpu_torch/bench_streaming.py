"""Out-of-core streaming fit of the port (the twin of the JAX package's
`scripts/bench_streaming.py`).

Builds a synthetic binary dataset larger than the Trainer's 4 GiB
`stream_bytes` threshold (4.5 GiB of float32 by default: 18,874,368 rows of
64 variables, the JAX script's bytes), trains one epoch through the
host-chunked streaming engine (`Trainer.fit` -> `_run_epoch_streamed`:
chunks of batches gathered on the host into pinned buffers and replayed as
one captured step graph), and records its rate next to the in-core rate of
the same model on a device-resident subset. Appends a JSON record to
`--out` and prints it.

    python -m pgmvae_tpu_torch.bench_streaming                # CUDA device 0
    python -m pgmvae_tpu_torch.bench_streaming --gib 0.001 --device -1

`--device -1` runs on the CPU; without a card and without it the program
exits 2 and prints nothing on stdout.

The data: `rows = int(gib * 2**30 / (vars * 4))` rows from
`np.random.default_rng(0)`, filled 1 << 20 rows at a time with
`rng.integers(0, 2, ...)` into one float32 array, as the JAX script does.
The model: `VqVaeConfig(n_var=vars, units=default_units(vars, dim),
dim=dim, num_codes=k, quantizer='ema')`, learning rate 1e-3.

In-core comparator: the first 1 << 20 rows on the device under a second
Trainer from `init_state(0)`, a warm `run_epochs` with seed 1, then the
timed one with seed 2, which updates the same state tensors in place and so
replays the warm run's graph (no capture inside the timed window: checked).
The subset is freed before the streamed fit. Streamed fit: `fit(epochs=1,
seed=1)` from `init_state(0)`; its wall includes its one graph capture, as
the JAX script's includes its compile, and `capture_ms` stands beside it.

The record holds the JAX script's keys (`rows`, `vars`, `gib`, `batch`,
`stream_epoch_wall`, `stream_sps`, `incore_sps_subset`, `stream_vs_incore`,
`loss`, `device`, here the card's name and power limit) and the port's:
`platform`, `chunk_steps`, `capture_ms`, `incore_capture_ms`,
`launches` (kernel launch counts of the whole run), `peak_gb_streamed` and
`peak_gb_incore_subset` (`torch.cuda.max_memory_allocated`, reset before
each run; null on the CPU) and `generate_s` (seconds to make the
data).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from pgmvae_tpu_torch import bench
from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
from pgmvae_tpu_torch.ops import kernels
from pgmvae_tpu_torch.registry import default_units

SUBSET_ROWS = 1 << 20     # the in-core comparator's rows
FILL_ROWS = 1 << 20       # rows generated at a time


class Run(NamedTuple):
    """One measurement: the record, the streamed fit's final state and the
    dataset it was trained on."""
    record: dict
    state: object
    data: np.ndarray


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--vars', type=int, default=64)
    ap.add_argument('--gib', type=float, default=4.5,
                    help='dataset size in GiB (f32), > the 4 GiB threshold')
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--k', type=int, default=64)
    ap.add_argument('--dim', type=int, default=10)
    ap.add_argument('--out', default='logs/bench_streaming_torch.jsonl')
    ap.add_argument('--device', '-u', type=int, default=0,
                    help='-1 = CPU; otherwise the index of the CUDA device')
    return ap


def dataset_rows(gib: float, n_vars: int) -> int:
    return int(gib * (1 << 30) / (n_vars * 4))


def make_data(rows: int, n_vars: int) -> np.ndarray:
    """The JAX script's dataset: uniform bits from numpy seed 0, filled
    FILL_ROWS rows at a time (host memory stays at the array and one
    fill's draw)."""
    rng = np.random.default_rng(0)
    data = np.empty((rows, n_vars), np.float32)
    for s in range(0, rows, FILL_ROWS):
        e = min(s + FILL_ROWS, rows)
        data[s:e] = rng.integers(0, 2, size=(e - s, n_vars))
    return data


def model_config(args) -> VqVaeConfig:
    return VqVaeConfig(n_var=args.vars, units=default_units(args.vars,
                                                            args.dim),
                       dim=args.dim, num_codes=args.k, quantizer='ema')


def measure(args, device: torch.device) -> Run:
    """The in-core comparator, then the streamed epoch (module doc)."""
    from pgmvae_tpu_torch.train import Trainer

    rows = dataset_rows(args.gib, args.vars)
    print(f'generating {rows:,} x {args.vars} f32 samples '
          f'({rows * args.vars * 4 / 2**30:.2f} GiB host)...',
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    data = make_data(rows, args.vars)
    generate_s = time.perf_counter() - t0
    cfg = model_config(args)
    tr = Trainer(cfg, 0.001, args.batch, rows, device=device)
    if data.nbytes <= tr.stream_bytes:
        raise ValueError(f'dataset must exceed stream_bytes: '
                         f'{data.nbytes} <= {tr.stream_bytes}')
    before = kernels.counts()

    # in-core comparator: the same model and batch on a device subset
    sub = data[:SUBSET_ROWS]
    tr_sub = Trainer(cfg, 0.001, args.batch, len(sub), device=device)
    st_sub = tr_sub.init_state(0)
    bench.reset_peak(device)
    dsub = torch.as_tensor(sub, device=device)
    st_sub, m = tr_sub.run_epochs(st_sub, dsub, 1, 0, 1)
    bench.drain(m)                      # warm: build, capture, drain
    t0 = time.perf_counter()
    st_sub, m = tr_sub.run_epochs(st_sub, dsub, 2, 0, 1)
    bench.drain(m)
    incore_sps = len(sub) / (time.perf_counter() - t0)
    peak_sub = bench.peak_gb(device)
    tr_sub.release_graphs()
    incore_graph = bench.graph_check(tr_sub, 'epoch',
                                     2 * tr_sub.steps_per_epoch)
    del st_sub, dsub, tr_sub, m
    bench.free_device(device)

    st = tr.init_state(0)
    bench.reset_peak(device)
    t0 = time.perf_counter()
    st, hist = tr.fit(st, data, epochs=1, seed=1)
    bench.drain(st.step)
    wall = time.perf_counter() - t0
    peak_stream = bench.peak_gb(device)
    launches = kernels.since(before)
    stream_graph = bench.graph_check(tr, 'chunk', tr.steps_per_epoch)
    stream_sps = rows / wall

    rec = {
        'rows': rows, 'vars': args.vars,
        'gib': round(data.nbytes / 2**30, 2),
        'batch': args.batch,
        'stream_epoch_wall': round(wall, 1),
        'stream_sps': round(stream_sps, 1),
        'incore_sps_subset': round(incore_sps, 1),
        'stream_vs_incore': round(stream_sps / incore_sps, 3),
        'loss': float(hist[-1].loss),
        'device': bench.device_label(device),
        'platform': 'gpu' if device.type == 'cuda' else 'cpu',
        'chunk_steps': tr._chunk_steps(data),
        'capture_ms': stream_graph.get('capture_ms'),
        'incore_capture_ms': incore_graph.get('capture_ms'),
        'launches': launches,
        'peak_gb_streamed': peak_stream,
        'peak_gb_incore_subset': peak_sub,
        'generate_s': generate_s,
    }
    return Run(rec, st, data)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = bench.resolve_index(args.device)
    if device is None:
        return 2
    bench.check_tf32()
    rec = measure(args, device).record
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(json.dumps(rec) + '\n')
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Packed-seed throughput benchmark of the port (the twin of the JAX
package's `scripts/bench_packed.py`).

A seed sweep is the same step with other seeds; packing S seeds stacks
their training states so that one step trains all of them. This measures
the steady-state drained throughput of S serial cells against one packed
run of the same config (netflix's tuned shape by default), appends a JSON
record to `--out` and prints it.

    python -m pgmvae_tpu_torch.bench_packed                  # CUDA device 0
    python -m pgmvae_tpu_torch.bench_packed -n kdd -k 4096 -d 10 -b 32 \
        -e 1 -s 4                                             # the kdd sweep
    python -m pgmvae_tpu_torch.bench_packed ... --device -1   # the CPU

Serial: a warm `run_epochs` from `init_state(1)`, then the timed loop over
seeds 1..S, each a fresh `init_state(s)` and `run_epochs` with seed s.
Packed: a warm `run_epochs_packed` of `init_states_packed(1..S)`, then the
timed one from a fresh init. Each fresh init is copied into the warm
state's tensors (`train.copy_state_into`), so that the timed runs replay
the epoch graphs the warm runs captured: the record's `graphs` holds one
capture per kind and its capture ms, apart from the timed walls, and a
capture inside a timed window raises. Data: the TRW train split from
`--data-dir` or `registry.data_dir()`, else the registry-shaped synthetic
one (`data.synthetic`), named in `data`. Per-seed numerical identity is
held by the tests; this is about wall-clock only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from pgmvae_tpu_torch import bench
from pgmvae_tpu_torch.ops import kernels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('-n', '--name', default='netflix')
    ap.add_argument('-k', '--embedding', type=int, default=500)
    ap.add_argument('-d', '--dim', type=int, default=10)
    ap.add_argument('-b', '--batch', type=int, default=128)
    ap.add_argument('-e', '--epochs', type=int, default=32)
    ap.add_argument('-s', '--seeds', type=int, default=5)
    ap.add_argument('--out', default='logs/bench_packed_torch.jsonl')
    ap.add_argument('--device', '-u', type=int, default=0,
                    help='-1 = CPU; otherwise the index of the CUDA device')
    ap.add_argument('--data-dir', default=None,
                    help='directory of the TRW CSVs (default: '
                         'registry.data_dir(), else a synthetic split)')
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = bench.resolve_index(args.device)
    if device is None:
        return 2
    bench.check_tf32()

    from pgmvae_tpu_torch.data.synthetic import load_or_synthesize
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.train import Trainer, copy_state_into

    info = REGISTRY[args.name]
    splits, label = load_or_synthesize(args.name, args.data_dir)
    y = splits['train']
    cfg = VqVaeConfig(n_var=info.n_var, units=info.encoder_units(args.dim),
                      dim=args.dim, num_codes=args.embedding, quantizer='ema')
    trainer = Trainer(cfg, 0.001, args.batch, len(y), device=device)
    data = torch.as_tensor(y, device=device)
    seeds = list(range(1, args.seeds + 1))
    steps = args.epochs * trainer.steps_per_epoch
    before = kernels.counts()

    # serial: S cells one after another, each replaying the warm run's
    # graph, steady state timed after a warm-up run
    st = trainer.init_state(1)
    st, m = trainer.run_epochs(st, data, 1, 0, args.epochs)
    bench.drain(m)                      # warm: build, capture, drain
    t0 = time.perf_counter()
    for s in seeds:
        st = copy_state_into(st, trainer.init_state(s))
        st, m = trainer.run_epochs(st, data, s, 0, args.epochs)
        bench.drain(m)
    serial_wall = time.perf_counter() - t0
    serial_sps = args.seeds * args.epochs * len(y) / serial_wall

    # packed: one step carrying all S states
    sts = trainer.init_states_packed(seeds)
    sts, m = trainer.run_epochs_packed(sts, data, seeds, 0, args.epochs)
    bench.drain(m)                      # warm
    sts = copy_state_into(sts, trainer.init_states_packed(seeds))
    t0 = time.perf_counter()
    sts, m = trainer.run_epochs_packed(sts, data, seeds, 0, args.epochs)
    bench.drain(m)
    packed_wall = time.perf_counter() - t0
    packed_sps = args.seeds * args.epochs * len(y) / packed_wall
    launches = kernels.since(before)
    trainer.release_graphs()

    rec = {
        'config': f'{args.name} K={args.embedding} D={args.dim} '
                  f'bs={args.batch} e={args.epochs} ema',
        'seeds': args.seeds,
        'serial_wall': round(serial_wall, 3),
        'packed_wall': round(packed_wall, 3),
        'serial_agg_sps': round(serial_sps, 1),
        'packed_agg_sps': round(packed_sps, 1),
        'speedup': round(packed_sps / serial_sps, 2),
        'device': bench.device_label(device),
        'platform': 'gpu' if device.type == 'cuda' else 'cpu',
        'data': label,
        'steps_per_epoch': trainer.steps_per_epoch,
        'graphs': {
            'serial': bench.graph_check(trainer, 'epoch',
                                        (1 + args.seeds) * steps),
            'packed': bench.graph_check(trainer, 'packed', 2 * steps)},
        'launches': launches,
    }
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(json.dumps(rec) + '\n')
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

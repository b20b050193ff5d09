"""CMLL Gibbs-sampler benchmark of the port (the twin of the JAX package's
`scripts/bench_cmll.py`), mirroring the reference's only executable perf
harness (reference `core/model.py:151-170`): a synthetic 150-variable /
5000-sample dataset, 2 quick training epochs, a random CPT, then two timed
conditional_marginal_log_likelihood calls with p1=n//12, num_smp=1000,
burn_in=100: the first (it builds the chain and captures its step) and the
steady one.

    python -m pgmvae_tpu_torch.bench_cmll                # CUDA device 0
    python -m pgmvae_tpu_torch.bench_cmll --device -1    # the CPU

Prints `bench_cmll.py`'s line, then one JSON line with the same numbers
and each call's capture ms (a call builds its own chain, so each captures
its step graph once; the capture is inside the call's time, as the JAX
call's compile is in its first call).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pgmvae_tpu_torch import bench
from pgmvae_tpu_torch.ops import kernels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--vars', type=int, default=150)
    ap.add_argument('--samples', type=int, default=5000)
    ap.add_argument('--k', type=int, default=15)
    ap.add_argument('--dim', type=int, default=20)
    ap.add_argument('--num-smp', type=int, default=1000)
    ap.add_argument('--burn-in', type=int, default=100)
    ap.add_argument('--device', '-u', type=int, default=0,
                    help='-1 = CPU; otherwise the index of the CUDA device')
    return ap


def model(args, device):
    """The benchmark's inputs, as `scripts/bench_cmll.py` makes them: (cfg,
    trained state, trainer, data [samples, vars], CPT [vars, K])."""
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.train import Trainer

    n, k, d = args.vars, args.k, args.dim
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2, size=(args.samples, n)).astype(np.float32)
    # the reference's units=[70,50,30] (its own model hardcodes 4 widths);
    # the 3-layer spec as the JAX package honours it
    cfg = VqVaeConfig(n_var=n, units=(70, 50, 30), dim=d, num_codes=k,
                      cost=0.25, decay=0.99, quantizer='ema')
    tr = Trainer(cfg, 0.001, 256, len(data), device=device)
    st, _ = tr.fit(tr.init_state(0), data, 2, 0)
    dist = rng.uniform(size=(n, k))
    dist = dist / dist.sum(axis=1, keepdims=True)
    return cfg, st, tr, data, dist


def timed_cmll(params, codebook, cfg, dist, x, p1: int, num_smp: int,
               burn_in: int, seed: int):
    """(CMLL, seconds, capture ms) of one call: what
    `conditional_marginal_log_likelihood` computes with a generator seeded
    `seed` on the params' device, its chain's capture read before it is
    released."""
    from pgmvae_tpu_torch.gibbs import GibbsChain
    t0 = time.perf_counter()
    chain = GibbsChain(params, codebook, cfg, dist, x, p1, burn_in)
    try:
        cmll = chain.sample_from(num_smp, torch.Generator(
            device=chain.device).manual_seed(seed))
    finally:
        chain.release()
    return cmll, time.perf_counter() - t0, chain.graph.capture_ms


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = bench.resolve_index(args.device)
    if device is None:
        return 2
    bench.check_tf32()
    before = kernels.counts()
    cfg, st, tr, data, dist = model(args, device)
    n = args.vars
    p1 = n // 12
    calls = [timed_cmll(st.params, tr.codebook(st), cfg, dist, data, p1,
                        args.num_smp, args.burn_in, seed) for seed in (1, 2)]
    (_, t_first, cap_first), (cmll, t_steady, cap_steady) = calls
    steps = args.num_smp * p1
    blocks = -(-n // p1)
    print(f'cmll={cmll:.5f}  first-call {t_first:.2f}s (incl build and '
          f'capture), steady {t_steady:.2f}s = {t_steady / steps * 1e6:.0f} '
          f'us/step ({steps} sequential Gibbs steps, batch {args.samples}, '
          f'{blocks} blocks; capture {cap_steady} ms of it)')
    print(json.dumps({
        'cmll': cmll, 'cmll_first': calls[0][0], 'first_s': t_first,
        'steady_s': t_steady, 'us_per_step': t_steady / steps * 1e6,
        'steps': steps, 'batch': args.samples, 'blocks': blocks, 'p1': p1,
        'capture_ms_first': cap_first, 'capture_ms_steady': cap_steady,
        'device': bench.device_label(device),
        'platform': 'gpu' if device.type == 'cuda' else 'cpu',
        'launches': kernels.since(before)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

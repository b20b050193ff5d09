"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It measures `pgmvae_tpu_torch` on the CUDA
card(s) of this machine and prints one JSON line last on standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and `checks`: the numbers compared with the plain reference,
each beside its limit, which also end standard error). Without CUDA, or
with fewer cards than the cell asks for, it exits 2 and prints no result;
if the JAX stack or the JAX package is loaded once the window has closed,
it exits 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    bench = harness.benchmark_file(ROOT)
    chips = harness.cell_entry(bench, args.workload)['chips']
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f'error: the cell needs {chips} CUDA device(s), this machine '
              f'has {count}', file=sys.stderr)
        return 2
    # matrix products in IEEE float32, as the configurations state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T0, root=ROOT, device='cuda:0')
    found = harness.banned_modules()
    if found:
        print(f'error: modules of the JAX stack or the JAX package are '
              f'loaded: {", ".join(found)}', file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Command line of the port: stage-1 VQ-VAE training + stage-2 PLL on the
TRW benchmark suite, with the flags, defaults, run identifier and
`result.txt` line of the JAX package's `run.py`.

    python -m pgmvae_tpu_torch.run -n nltcs -k 50 -d 10 -b 128 -e 100 \
        -r 0.01 -c 0.25 -m -s 1 --adam-impl pallas            # CUDA device 0
    python -m pgmvae_tpu_torch.run ... --device -1             # the CPU

    python -m pgmvae_tpu_torch.run ... --checkpoint m.ckpt --cmll
    python -m pgmvae_tpu_torch.run ... --resume m.ckpt -e 1
    python -m pgmvae_tpu_torch.run ... --adam-impl fused_bf16
    python -m pgmvae_tpu_torch.run ... --compute-dtype bf16

`--checkpoint` writes the JAX package's checkpoint format (and with
--cpt-parents-mix `<path>.mix`), which `serving.PgmModel.from_checkpoint`
of either package serves; `--resume` refuses a checkpoint whose model
config differs; `--cmll` adds the Gibbs CMLL of the test split to the
result line; `--adam-impl fused_bf16` keeps the Adam moments in bfloat16;
`--compute-dtype bf16` trains in bfloat16 with float32 masters (identifier
flag cd-bf16); `--profile` writes a `torch.profiler` trace of the run
(`trace.json`, Chrome's trace format) into the run's log directory
`logs/tuning/<identifier>/`. Grids of cells, packed seeds and isolated
cells are `pgmvae_tpu_torch.run_pipeline`'s.

    python -m pgmvae_tpu_torch.run ... --mesh-data 2 --mesh-model 2

runs the cell on a (data, model) device mesh: the command spawns one
process a rank (NCCL with a GPU each when there are enough, else gloo with
the ranks sharing the device), names the mesh's backend and the ranks'
devices on stderr, and writes the JAX package's identifier (no mesh
suffix). Rank 0 writes the logs and the checkpoint. Ranks that run past
`--mesh-timeout` seconds (default 24 h) are terminated and the run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # -- reference-compatible flags (reference run.py:11-23) --
    p.add_argument('--name', '-n', required=True, help='target dataset name')
    p.add_argument('--embedding', '-k', type=int, required=True,
                   help='embedding dictionary size')
    p.add_argument('--dim', '-d', type=int, required=True,
                   help='embedding dimension')
    p.add_argument('--batch', '-b', type=int, default=128,
                   help='training batch size')
    p.add_argument('--epoch', '-e', type=int, default=200,
                   help='number of epochs for training')
    p.add_argument('--rate', '-r', type=float, default=0.001,
                   help='learning rate')
    p.add_argument('--cost', '-c', type=float, default=0.25,
                   help='commitment cost')
    p.add_argument('--ema', '-m', action='store_true',
                   help='using exponential moving average')
    p.add_argument('--decay', '-g', type=float, default=0.99,
                   help='EMA decay rate')
    p.add_argument('--seed', '-s', type=int, default=0,
                   help='integer for random seed')
    p.add_argument('--device', '-u', type=int, default=0,
                   help='-1 = CPU; otherwise the index of the CUDA device')
    p.add_argument('--verbose', '-v', action='store_true',
                   help='verbose mode when do model fitting and sampling')
    p.add_argument('--note', '-t', type=str, default='',
                   help='note for other conditions')
    # -- extensions of the JAX package --
    p.add_argument('--quantizer', choices=['ema', 'vq', 'naive'], default=None,
                   help="override quantizer (default: 'ema' if --ema else 'vq')")
    p.add_argument('--units', type=str, default=None,
                   help='comma-separated encoder widths (default: registry '
                        'or heuristic)')
    p.add_argument('--mesh-data', type=int, default=1,
                   help='data-parallel mesh axis size')
    p.add_argument('--mesh-model', type=int, default=1,
                   help='variable-axis model-parallel mesh size')
    p.add_argument('--mesh-timeout', type=float, default=None,
                   help='seconds the spawned mesh ranks may run before they '
                        'are terminated and the run fails (default: '
                        'driver.MESH_TIMEOUT, 24 h)')
    p.add_argument('--dead-code-threshold', type=float, default=0.0,
                   help='>0 enables EMA dead-code restarts: codes whose '
                        'moving-average usage drops below the threshold are '
                        'reseeded from random batch latents (anti-collapse; '
                        'the reference has no equivalent)')
    p.add_argument('--fan-mode', choices=['tf_stacked', 'per_network'],
                   default='tf_stacked',
                   help='init fan semantics: tf_stacked reproduces the '
                        "reference's Keras stacked-kernel fans; per_network "
                        'initializes each of the n_var networks like an '
                        'independent MLP (larger scale, fights codebook '
                        'collapse at large n_var)')
    p.add_argument('--activation', type=str, default='selu',
                   help='hidden activation (selu/relu/gelu/elu/tanh/sigmoid/'
                        'linear; the reference hardcodes selu, its FatDense '
                        'accepts any — core/dense.py:46)')
    p.add_argument('--l2', type=float, default=0.0,
                   help='L2 penalty on dense kernels (FatDense '
                        'kernel_regularizer hook, core/dense.py:50)')
    p.add_argument('--vq-impl', choices=['xla', 'pallas', 'auto'],
                   default='auto',
                   help='nearest-codebook search: every choice runs the one '
                        'CUDA kernel (ops/cuda_vq.py), which plans its '
                        'launch for each shape and never builds the [n,B,K] '
                        'distances; the choices are the JAX package\'s')
    p.add_argument('--precision', choices=['default', 'float32', 'highest'],
                   default='default',
                   help='matmul precision: every choice runs IEEE float32 '
                        'matmuls (TF32 stays off); a choice other than '
                        'default is recorded in the identifier as prc-...')
    p.add_argument('--first-layer', choices=['masked', 'rank1', 'auto'],
                   default='masked',
                   help='first encoder layer: masked (default; each '
                        'network\'s batched matmul reads the inputs with its '
                        'own variable masked out), rank1 (same math, one '
                        'shared full-width matmul + diagonal correction, '
                        'for huge n_var*batch), auto (rank1 only when the '
                        'masked [n,B,n] float32 buffer would exceed 4 GiB)')
    p.add_argument('--adam-impl', choices=['optax', 'fused', 'pallas', 'fused_bf16'],
                   default='optax',
                   help='Adam update implementation: optax (default), fused '
                        'and pallas all run the one CUDA Adam kernel '
                        '(ops/csrc/adam.cu), bit for bit the same update; '
                        'fused and pallas are recorded in the identifier as '
                        'ad-fused and ad-pallas. fused_bf16 keeps the '
                        'moments in bfloat16 (the kernel\'s bfloat16 '
                        'variant; recorded as ad-fused_bf16)')
    p.add_argument('--compute-dtype', choices=['f32', 'bf16'], default='f32',
                   help='forward/backward compute dtype. bf16 halves the '
                        'weight/activation/cotangent HBM streams (master '
                        'params, Adam moments, EMA stats, loss reductions '
                        'and stage 2 stay f32) — a different training '
                        'trajectory, recorded in the identifier as cd-bf16')
    p.add_argument('--no-zero-debias', action='store_true',
                   help='plain moving average instead of the TF zero-debiased '
                        'default')
    p.add_argument('--select-on-valid', type=int, default=0, metavar='N',
                   help='evaluate valid PLL every N epochs and keep the '
                        'best snapshot instead of the final epoch '
                        '(anti-overfit; 0 = reference behavior)')
    p.add_argument('--cpt-parents', type=int, default=0, metavar='M',
                   help='joint-code CPTs: condition each variable\'s stage-2 '
                        'table on its code AND the observed values of its M '
                        'highest-mutual-information partner variables '
                        '(K * 2^M tied cells per variable; still a legal '
                        'PLL — the conditioning set is a function of x_-v '
                        'only). 0 = reference semantics')
    p.add_argument('--cpt-parents-eval', type=str, default='',
                   metavar='M1,M2,...',
                   help='extra joint-CPT parent counts evaluated POST-HOC '
                        'from the same trained state (stage-1 is independent '
                        'of M, so this sweeps M without retraining); each M '
                        'appends its own cpe-M result line. With '
                        '--select-on-valid the snapshot is chosen on the '
                        'primary --cpt-parents valid PLL')
    p.add_argument('--cpt-parents-mix', action='store_true',
                   help='with --cpt-parents-eval: also emit ONE mixed '
                        'stage-2 record (identifier flag cpm) where each '
                        'variable picks its own M — from {--cpt-parents} + '
                        'the eval list — by its per-variable VALIDATION '
                        'PLL contribution (PLL sums over variables, so the '
                        'mixture is a legal PLL; selection never touches '
                        'the test split)')
    p.add_argument('--cmll', action='store_true',
                   help='also evaluate CMLL via Gibbs sampling '
                        '(num_smp=3000, burn_in=150, p1=n_var//10, as in '
                        'reference run.py:74); with --cpt-parents-mix the '
                        'mix record gets its own CMLL on the composed '
                        'mixture tables')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='path to write a checkpoint (params+EMA+CPT); with '
                        '--cpt-parents-mix the composed mixture is also '
                        'saved to <path>.mix (servable by PgmModel)')
    p.add_argument('--resume', type=str, default=None,
                   help='checkpoint to resume stage-1 training from')
    p.add_argument('--profile', action='store_true',
                   help='write a torch.profiler trace of the run into its '
                        'log directory (trace.json)')
    p.add_argument('--data-dir', type=str, default=None,
                   help='override TRW data directory')
    p.add_argument('--result-file', type=str, default='result.txt')
    return p


def _profiled(exp, device: str, **kw) -> dict:
    """`run_experiment` under `torch.profiler` (the device's kernels too on
    CUDA), its trace written to `<exp.log_dir>/trace.json`: the counterpart
    of the JAX CLI's `jax.profiler` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pgmvae_tpu_torch.driver import run_experiment
    activities = [ProfilerActivity.CPU]
    if device != 'cpu':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        res = run_experiment(exp, device=device, **kw)
        if device != 'cpu':
            torch.cuda.synchronize(device)
    os.makedirs(exp.log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(exp.log_dir, 'trace.json'))
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    os.environ['PYTHONHASHSEED'] = '0'
    random.seed(args.seed)
    import numpy as np
    np.random.seed(args.seed)
    import torch

    from pgmvae_tpu_torch.driver import ExperimentConfig, run_experiment
    from pgmvae_tpu_torch.registry import REGISTRY
    from pgmvae_tpu_torch.utils.logging import append_result

    if args.device == -1:
        device = 'cpu'
    elif args.device >= torch.cuda.device_count():
        print(f'error: --device {args.device}: '
              f'{torch.cuda.device_count()} CUDA devices available '
              f'(--device -1 runs on the CPU)', file=sys.stderr)
        return 2
    else:
        device = f'cuda:{args.device}'
    if args.name not in REGISTRY:
        print(f"error: unknown dataset '{args.name}'. Available: "
              f"{', '.join(sorted(REGISTRY))}", file=sys.stderr)
        return 2

    exp = ExperimentConfig(
        name=args.name, embedding=args.embedding, dim=args.dim,
        batch=args.batch, epoch=args.epoch, rate=args.rate, cost=args.cost,
        ema=args.ema, decay=args.decay, seed=args.seed, note=args.note,
        quantizer=args.quantizer,
        units=(tuple(int(u) for u in args.units.split(','))
               if args.units else None),
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        zero_debias=not args.no_zero_debias,
        dead_code_threshold=args.dead_code_threshold, fan_mode=args.fan_mode,
        activation=args.activation, l2_reg=args.l2,
        vq_impl=args.vq_impl,
        precision=args.precision, cmll=args.cmll,
        select_on_valid=args.select_on_valid, cpt_parents=args.cpt_parents,
        cpt_parents_eval=(tuple(int(m) for m in
                                args.cpt_parents_eval.split(','))
                          if args.cpt_parents_eval else ()),
        cpt_parents_mix=args.cpt_parents_mix,
        first_layer=args.first_layer, adam_impl=args.adam_impl,
        compute_dtype=args.compute_dtype,
        checkpoint=args.checkpoint, resume=args.resume,
        data_dir=args.data_dir, verbose=args.verbose,
        log_dir=os.path.join(os.curdir, 'logs', 'tuning'))
    exp.log_dir = os.path.join(exp.log_dir, exp.identifier)

    kw = ({} if args.mesh_timeout is None
          else {'mesh_timeout': args.mesh_timeout})
    if args.profile:
        res = _profiled(exp, device, **kw)
    else:
        res = run_experiment(exp, device=device, **kw)
    if 'mesh' in res:
        print(f'mesh: {json.dumps(res["mesh"])}', file=sys.stderr)
    line = append_result(res['identifier'], res['pll_train'],
                         res['pll_valid'], res['pll_test'], res['cmll_test'],
                         path=args.result_file)
    print(line)
    for ph in res.get('posthoc', []):
        line = append_result(ph['identifier'], ph['pll_train'],
                             ph['pll_valid'], ph['pll_test'],
                             ph['cmll_test'], path=args.result_file)
        print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())

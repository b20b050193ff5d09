"""Sweep runner of the port: grids of (dataset x hyperparameter) cells with a
resumable joblog, with the flags, joblog lines, `result.txt` lines and
identifiers of the JAX package's `run_pipeline.py`.

    python -m pgmvae_tpu_torch.run_pipeline -n kdd -k 4096 -d 10 -b 32 \\
        -e 200 -r 2e-4 -c 0.35 -m -s 5,6,7,8 --pack-seeds 4   # CUDA device 0
    python -m pgmvae_tpu_torch.run_pipeline ... --isolate     # a process a cell
    python -m pgmvae_tpu_torch.run_pipeline ... --device -1   # the CPU

Grid flags take comma-separated values; the cells are their product. Every
cell's outcome is appended to a JSONL joblog: rerunning the same command
skips the cells already done, and `--retry-failed` runs the failed ones
again. `--pack-seeds S` trains up to S cells that differ only in seed as one
packed program (`driver.run_packed_experiments`), recorded under pk-S
identifiers. `--isolate` runs each cell, or packed group, in a fresh process
(`python -m pgmvae_tpu_torch._cell_runner`) under `--cell-timeout`. A mesh
(`--mesh-data`/`--mesh-model` > 1) runs each cell unpacked, its ranks
spawned by `driver.run_experiment` (from the cell's own process under
`--isolate`) and terminated past `--cell-timeout`; the joblog line records
the mesh's shape, backend, the ranks' devices and their kernel launches
under 'mesh'.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csv(cast):
    return lambda s: [cast(v) for v in s.split(',')]


def _units(s):
    """'400x200x100x50' -> (400, 200, 100, 50); 'auto'/'' -> None."""
    if s in ('', 'auto', 'default'):
        return None
    return tuple(int(u) for u in s.split('x'))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--name', '-n', type=_csv(str), required=True)
    p.add_argument('--embedding', '-k', type=_csv(int), required=True)
    p.add_argument('--dim', '-d', type=_csv(int), required=True)
    p.add_argument('--batch', '-b', type=_csv(int), default=[128])
    p.add_argument('--epoch', '-e', type=int, default=200)
    p.add_argument('--rate', '-r', type=_csv(float), default=[0.001])
    p.add_argument('--cost', '-c', type=_csv(float), default=[0.25])
    p.add_argument('--ema', '-m', action='store_true')
    p.add_argument('--decay', '-g', type=_csv(float), default=[0.99])
    p.add_argument('--seed', '-s', type=_csv(int), default=[0])
    p.add_argument('--note', '-t', type=str, default='')
    p.add_argument('--quantizer', type=_csv(str), default=[None],
                   help="grid over quantizers: ema,vq,naive (default: from "
                        "--ema)")
    p.add_argument('--units', type=_csv(_units), default=[None],
                   help="grid over encoder widths: 'x'-separated widths, "
                        "comma-separated cells, e.g. 400x200x100x50,300x150 "
                        "('auto' = registry/heuristic default)")
    p.add_argument('--fan-mode', type=_csv(str), default=['tf_stacked'],
                   help='grid over init fan semantics: tf_stacked,per_network')
    p.add_argument('--dead-code-threshold', type=_csv(float), default=[0.0],
                   help='grid over EMA dead-code restart thresholds '
                        '(0 = off)')
    p.add_argument('--no-zero-debias', action='store_true',
                   help='plain moving average instead of TF zero-debiased')
    p.add_argument('--activation', type=_csv(str), default=['selu'],
                   help='grid over hidden activations')
    p.add_argument('--l2', type=_csv(float), default=[0.0],
                   help='grid over L2 kernel penalties')
    p.add_argument('--verbose', '-v', action='store_true')
    p.add_argument('--joblog', type=str, default='logs/sweep-joblog.jsonl')
    p.add_argument('--isolate', action='store_true',
                   help='run each cell (or packed group) in a fresh process: '
                        'no device memory or state leaks between cells')
    p.add_argument('--cell-timeout', type=float, default=3600.0,
                   help='per-cell wall-clock limit with --isolate, and '
                        "of a mesh cell's spawned ranks")
    p.add_argument('--retry-failed', action='store_true',
                   help='re-run cells whose last outcome was a failure')
    p.add_argument('--pack-seeds', type=int, default=1, metavar='S',
                   help='train up to S cells differing only in --seed as '
                        'ONE packed program. Packed cells are recorded under '
                        'pk-S identifiers: each seed follows its own '
                        'trajectory, but the packed sums are taken in '
                        'another order than unpacked ones')
    p.add_argument('--cmll', action='store_true',
                   help='evaluate CMLL via blockwise Gibbs on the test '
                        'split (reference run.py:74 settings); composes '
                        'with --pack-seeds (per-seed chains)')
    p.add_argument('--result-file', type=str, default='result.txt')
    p.add_argument('--mesh-data', type=int, default=1)
    p.add_argument('--mesh-model', type=int, default=1)
    p.add_argument('--vq-impl', choices=['xla', 'pallas', 'auto'],
                   default='auto')
    p.add_argument('--select-on-valid', type=int, default=0, metavar='N',
                   help='keep the best-valid-PLL snapshot, evaluated every '
                        'N epochs (0 = final epoch, reference behavior)')
    p.add_argument('--cpt-parents', type=_csv(int), default=[0],
                   help='grid over joint-code CPT parent counts (see '
                        'run.py --cpt-parents; 0 = reference semantics)')
    p.add_argument('--cpt-parents-eval', type=_csv(int), default=[],
                   help='extra parent counts evaluated POST-HOC from the '
                        'same trained state, applied to every cell; each M '
                        'appends its own cpe-M joblog/result record')
    p.add_argument('--cpt-parents-mix', action='store_true',
                   help='with --cpt-parents-eval: also emit ONE mixed '
                        'record per cell where each variable picks its own '
                        'M by validation PLL contribution (identifier flag '
                        'cpm)')
    p.add_argument('--precision', choices=['default', 'float32', 'highest'],
                   default='default')
    p.add_argument('--first-layer', choices=['masked', 'rank1', 'auto'],
                   default='masked',
                   help='first encoder layer implementation (see run.py '
                        '--first-layer)')
    p.add_argument('--adam-impl',
                   choices=['optax', 'fused', 'pallas', 'fused_bf16'],
                   default='optax',
                   help='Adam update implementation (see run.py '
                        '--adam-impl; non-default is identifier-encoded)')
    p.add_argument('--compute-dtype', choices=['f32', 'bf16'], default='f32',
                   help='forward/backward compute dtype (see run.py '
                        '--compute-dtype; bf16 is identifier-encoded)')
    p.add_argument('--data-dir', type=str, default=None)
    p.add_argument('--device', '-u', type=int, default=0,
                   help='-1 = CPU; otherwise the index of the CUDA device')
    return p


def _run_subprocess(payload: dict, timeout: float):
    """One `_cell_runner` process on `payload`; its last stdout line."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    proc = subprocess.run(
        [sys.executable, '-m', 'pgmvae_tpu_torch._cell_runner'],
        input=json.dumps(payload), capture_output=True, text=True,
        timeout=timeout, env=env)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or '')[-1500:]
        raise RuntimeError(f'cell subprocess failed '
                           f'(rc={proc.returncode}): {tail}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_isolated(cells, device: int, timeout: float) -> list:
    """Run one cell, or a packed group, in a fresh process; its results."""
    if len(cells) == 1:
        return [_run_subprocess({**dataclasses.asdict(cells[0]),
                                 '_device': device,
                                 # a minute early: the cell's process ends
                                 # its mesh ranks before it is killed
                                 '_mesh_timeout': max(1.0, timeout - 60)},
                                timeout)]
    return _run_subprocess({'_device': device,
                            '_packed': [dataclasses.asdict(c)
                                        for c in cells]}, timeout)


def group_packed(cells, pack: int):
    """Partition the grid into run groups: cells differing only in seed are
    packed together (up to `pack` per group, grid order preserved); all
    other cells become singleton groups."""
    if pack <= 1:
        return [[c] for c in cells]
    by_key, order = {}, []
    for cell in cells:
        k = dataclasses.astuple(dataclasses.replace(cell, seed=-1))
        if k not in by_key:
            by_key[k] = []
            order.append(k)
        by_key[k].append(cell)
    groups = []
    for k in order:
        cs = by_key[k]
        groups.extend(cs[j:j + pack] for j in range(0, len(cs), pack))
    return groups


def classify_cell(cell, group_width: int, status: dict,
                  want_cmll: bool = False):
    """Resume classification for one cell of a `group_width`-wide packed
    group against the joblog `status` map: 'done', 'failed' or 'todo'.

    A done cell may be recorded under its unpacked identifier or a pk-S one
    for any S up to the group width (a partial rerun packs only the todo
    subset, so S = len(todo) of that invocation). The primary record is
    written without the cpe eval-list suffix; a cell with
    --cpt-parents-eval is done only once every cpe-M record is ok too, with
    --cpt-parents-mix once its mix record is, and with `want_cmll` once its
    record carries a real CMLL (cmll_test != 1, the CMLL-off value of
    reference run.py:77)."""
    prev, cpe_done, mix_done = None, True, True
    for s in range(group_width, 0, -1):
        c_s = dataclasses.replace(cell, packed_seeds=s,
                                  cpt_parents_eval=(),
                                  cpt_parents_mix=False)
        rec = status.get(c_s.identifier)
        if rec is None:
            continue
        if prev is None or (rec.get('ok') and not prev.get('ok')):
            prev = rec
            cpe_done = all(
                status.get(dataclasses.replace(
                    c_s, cpt_parents_eval=(m,)).identifier,
                    {}).get('ok', False)
                for m in cell.cpt_parents_eval)
            mix_done = not cell.cpt_parents_mix or status.get(
                dataclasses.replace(cell, packed_seeds=s).identifier,
                {}).get('ok', False)
        if rec.get('ok'):
            break
    if prev is None:
        return 'todo'
    cmll_done = not want_cmll or prev.get('cmll_test', 1) != 1
    if prev.get('ok') and cpe_done and cmll_done and mix_done:
        return 'done'
    if not prev.get('ok'):
        return 'failed'
    return 'todo'


def load_joblog(path: str) -> dict:
    """Last-writer-wins status per cell identifier."""
    status = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    status[rec['identifier']] = rec
                except (json.JSONDecodeError, KeyError):
                    continue
    return status


def _record(res: dict, t0: float, wall: bool) -> str:
    rec = {'identifier': res['identifier'], 'ts': int(t0), 'ok': True,
           **{k: v for k, v in res.items() if k != 'identifier'}}
    if wall:
        rec['wall'] = round(time.time() - t0, 3)
    return json.dumps(rec)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from pgmvae_tpu_torch.driver import (ExperimentConfig, run_experiment,
                                         run_packed_experiments)
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

    cells = [
        ExperimentConfig(name=name, embedding=k, dim=d, batch=b,
                         epoch=args.epoch, rate=r, cost=c, ema=args.ema,
                         decay=g, seed=s, note=args.note,
                         quantizer=qz, units=un, fan_mode=fm,
                         dead_code_threshold=dcr, activation=act, l2_reg=l2,
                         zero_debias=not args.no_zero_debias,
                         mesh_data=args.mesh_data, mesh_model=args.mesh_model,
                         vq_impl=args.vq_impl, precision=args.precision,
                         select_on_valid=args.select_on_valid,
                         cpt_parents=cpp,
                         cpt_parents_eval=tuple(args.cpt_parents_eval),
                         cpt_parents_mix=args.cpt_parents_mix,
                         first_layer=args.first_layer,
                         adam_impl=args.adam_impl,
                         compute_dtype=args.compute_dtype,
                         cmll=args.cmll,
                         data_dir=args.data_dir, verbose=args.verbose)
        for name, k, d, b, r, c, g, s, qz, un, fm, dcr, act, l2, cpp
        in itertools.product(
            args.name, args.embedding, args.dim, args.batch, args.rate,
            args.cost, args.decay, args.seed, args.quantizer, args.units,
            args.fan_mode, args.dead_code_threshold, args.activation, args.l2,
            args.cpt_parents)
    ]

    os.makedirs(os.path.dirname(os.path.abspath(args.joblog)), exist_ok=True)
    status = load_joblog(args.joblog)

    pack = max(args.pack_seeds, 1)
    if pack > 1 and args.mesh_data * args.mesh_model > 1:
        print('pack-seeds does not compose with a device mesh; running '
              'cells unpacked', file=sys.stderr)
        pack = 1
    groups = group_packed(cells, pack)
    done = sum(
        1 for g in groups for c in g
        if classify_cell(c, len(g), status, args.cmll) == 'done')
    print(f'sweep: {len(cells)} cells ({done} already done, '
          f'joblog {args.joblog})', file=sys.stderr)

    failures = 0
    n_run = 0
    with open(args.joblog, 'a', buffering=1) as log:
        for group in groups:
            todo = []
            for cell in group:
                state = classify_cell(cell, len(group), status, args.cmll)
                if state == 'done':
                    continue
                if state == 'failed' and not args.retry_failed:
                    failures += 1
                    continue
                todo.append(cell)
            if not todo:
                continue
            t0 = time.time()
            try:
                if args.isolate:
                    results = _run_isolated(todo, args.device,
                                            args.cell_timeout)
                elif len(todo) > 1:
                    results = run_packed_experiments(todo, device=device)
                else:
                    results = [run_experiment(
                        todo[0], device=device,
                        mesh_timeout=args.cell_timeout)]
                for res in results:
                    n_run += 1
                    # res['identifier'] carries pk-S when the cell ran
                    # packed; post-hoc cpe-M evaluations are lines of their
                    # own
                    posthoc = res.pop('posthoc', [])
                    log.write(_record(res, t0, wall=True) + '\n')
                    append_result(res['identifier'], res['pll_train'],
                                  res['pll_valid'], res['pll_test'],
                                  res['cmll_test'], path=args.result_file)
                    print(f"[{n_run}/{len(cells)}] {res['identifier']} "
                          f"pll-test={res['pll_test']:.5f} "
                          f"(paper {res['paper_pll']:.2f}) "
                          f"{res['train_wall']:.1f}s", file=sys.stderr)
                    for ph in posthoc:
                        log.write(_record(ph, t0, wall=False) + '\n')
                        append_result(ph['identifier'], ph['pll_train'],
                                      ph['pll_valid'], ph['pll_test'],
                                      ph['cmll_test'], path=args.result_file)
                        print(f"    posthoc {ph['identifier']} "
                              f"pll-test={ph['pll_test']:.5f}",
                              file=sys.stderr)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — joblog records the cells
                for cell in todo:
                    n_run += 1
                    failures += 1
                    rec = {'identifier': cell.identifier, 'ts': int(t0),
                           'ok': False, 'error': f'{type(e).__name__}: {e}',
                           'trace': traceback.format_exc()[-2000:],
                           'wall': round(time.time() - t0, 3)}
                    log.write(json.dumps(rec) + '\n')
                    print(f"[{n_run}/{len(cells)}] {cell.identifier} "
                          f"FAILED: {e}", file=sys.stderr)
            gc.collect()        # drop the cell's tensors before the next
    print(f'sweep finished: {failures} cells failed', file=sys.stderr)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())

"""The readings that the limits of `correct` are set from, on the chip at a
cell's own size, for each seed given:

- 'program': a short run of the cell through the harness (set-up, a window
  of `--seconds`, the check): the program against the plain reference, the
  lower reading;
- 'control': the reference in TF32, one precision below the
  configuration's float32, put in the program's place and compared as the
  program is;
- 'fault:<name>': the reference with one of the faults a cell of its
  traffic can have, put in the program's place ('frozen', 'half_batch'
  for training; 'altered' for the Gibbs chain and scoring; for scoring
  also 'small_requests', the answers of requests of at most 8 rows 0.4%
  off).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--program-seeds 4,5,...] [--seconds 2] [--out FILE]

One JSON line a reading on standard output (and appended to `--out`). The
benchmark's own runs do not run this; `benchmark/tests/test_bench_control.py`
runs it at a tiny size on the CPU, and at the cells' size on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, inputs, reference  # noqa: E402

FAULTS = {'train': ('frozen', 'half_batch'), 'cmll': ('altered',),
          'score': ('altered', 'small_requests')}


def train_readings(cfg, mix, seed, device, tf32=False, fault=None):
    drv = harness.driver('train')
    train = torch.as_tensor(inputs.shared_factor_splits(cfg, seed)['train'],
                            device=device)
    out = [0.0, 0.0, 0.0]
    bs = mix['batch']
    for s in drv.model_seeds(seed, int(mix['pack_seeds'])):
        perm, _ = reference.epoch_permutation(s, 0, train.shape[0], device)
        batches = [train[perm[t * bs:(t + 1) * bs]]
                   for t in range(mix['check_steps'])]

        def run(tf32, fault):
            gen = reference.epoch_permutation(s, 0, train.shape[0],
                                              device)[1]
            return reference.train(inputs.weights(cfg, s, device), cfg,
                                   batches, gen, steps=len(batches),
                                   tf32=tf32, fault=fault)
        ref = run(False, None)
        got = run(tf32, fault)
        prog = {k: [v] for k, v in got.items()}
        out = [max(a, b) for a, b in zip(out, drv.compare(prog, 0, ref))]
    return dict(zip(('loss_gap', 'grad1_gap', 'delta_gap'), out))


def cmll_readings(cfg, mix, seed, device, tf32=False, fault=None):
    drv = harness.driver('cmll')
    splits = inputs.shared_factor_splits(cfg, seed)
    w = inputs.weights(cfg, seed, device)
    train = torch.as_tensor(splits['train'], device=device)
    x = torch.as_tensor(splits['test'], device=device)
    p1 = max(cfg['n_var'] // mix['p1_divisor'], 1)
    blocks, _ = reference.gibbs_layout(cfg['n_var'], p1)
    table = reference.cpt(w, cfg, train)
    mine = reference.cpt(w, cfg, train, tf32=tf32)
    state = x[None].expand(blocks, -1, -1).contiguous()
    counts = torch.zeros_like(x)
    start = mix['burn_in'] * p1 + 1
    g = mix['uniform_group']
    off = total = 0
    for i in range(start, start + mix['check_steps']):
        u = drv.uniform_group(seed, i // g, g, blocks, x.shape[0],
                              device)[i % g]
        new_s, new_c = reference.gibbs_step(w, cfg, mine, state, counts, i,
                                            u, p1, mix['burn_in'], tf32,
                                            fault)
        ref_s, ref_c = reference.gibbs_step(w, cfg, table, state, counts, i,
                                            u, p1, mix['burn_in'])
        off += drv.draws_off(new_s, new_c, ref_s, ref_c)
        total += blocks * x.shape[0]
        state, counts = new_s, new_c
    return {'cpt_cells_off': reference.cpt_cells_off(mine.cpu(),
                                                     table.cpu()),
            'draws_off': off / total}


def score_readings(cfg, mix, seed, device, tf32=False, fault=None):
    drv = harness.driver('score')
    splits = inputs.shared_factor_splits(cfg, seed)
    w = inputs.weights(cfg, seed, device)
    train = torch.as_tensor(splits['train'], device=device)
    pool = drv.pool(splits)
    sizes, offsets = drv.requests(mix, seed, pool.shape[0])
    rng = np.random.default_rng(inputs.sub_seed(seed, 'check'))
    pick = rng.choice(len(sizes), mix['check_requests'], replace=False)
    pick = sorted(set(pick.tolist()) | {int(np.argmax(sizes))})
    table = reference.cpt(w, cfg, train)
    mine = reference.cpt(w, cfg, train, tf32=tf32)
    answers, refs = [], []
    for i in pick:
        rows = torch.as_tensor(pool[offsets[i]:offsets[i] + sizes[i]],
                               device=device)
        answers.append(reference.score(w, cfg, mine, rows,
                                       tf32, fault).cpu().numpy())
        refs.append(reference.score(w, cfg, table, rows).cpu().numpy())
    got = drv.compare(answers, refs)
    return {'cpt_cells_off': reference.cpt_cells_off(mine.cpu(),
                                                     table.cpu()),
            'pll_rel_gap_mean': got['pll_rel_gap_mean'],
            'requests_off': got['requests_off'],
            'pll_rel_gap_max': got['pll_rel_gap_max']}


READINGS = {'train': train_readings, 'cmll': cmll_readings,
            'score': score_readings}


def readings(workload, seeds, program_seeds, seconds, device, root=ROOT,
             overrides=None, emit=print):
    """Every reading of `workload` for the seeds; each is passed to `emit`
    as a dict and returned in a list."""
    overrides = overrides or {}
    bench = harness.benchmark_file(root)
    entry = harness.cell_entry(bench, workload)
    cfg = {**inputs.config(entry['config']), **overrides.get('config', {})}
    mix = {**inputs.traffic(entry['traffic']),
           **overrides.get('traffic', {})}
    kind = mix['driver']
    out = []

    def put(seed, what, numbers, t0):
        rec = {'workload': workload, 'seed': seed, 'kind': what,
               'numbers': numbers, 'seconds': time.perf_counter() - t0}
        out.append(rec)
        emit(rec)
    for seed in program_seeds:
        t0 = time.perf_counter()
        res = harness.run(workload, seed, seconds, False, t0, root=root,
                          device=device, overrides=overrides,
                          log=harness.Log(open('/dev/null', 'w')))
        put(seed, 'program', {k: v['value']
                              for k, v in res['checks'].items()}, t0)
    for seed in seeds:
        t0 = time.perf_counter()
        put(seed, 'control', READINGS[kind](cfg, mix, seed, device,
                                            tf32=True), t0)
        for fault in FAULTS[kind]:
            t0 = time.perf_counter()
            put(seed, f'fault:{fault}',
                READINGS[kind](cfg, mix, seed, device, fault=fault), t0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--program-seeds', default='')
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('error: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def seeds(text):
        return [int(s) for s in text.split(',') if s]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    readings(args.workload, seeds(args.seeds), seeds(args.program_seeds),
             args.seconds, 'cuda:0', emit=emit)
    return 0


if __name__ == '__main__':
    sys.exit(main())

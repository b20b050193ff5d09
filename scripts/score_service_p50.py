"""bbc-score's service time a request (from going out to the answer on the
host), in windows of the open loop alternately untraced and traced
(`benchmark.trace.traced`, as a `--trace 1` run traces), and
`serve.dispatch_pct.score` of each traced window, for the checkout at ROOT
(its `benchmark/` and its program). Prints one JSON line. On a CUDA card:

    python3 scripts/score_service_p50.py ROOT SEED REPS [--cpu]

ROOT may be another checkout with this benchmark laid over it, to compare
two commits in turns; `--cpu` runs the benchmark tests' tiny cell."""
import json
import os
import sys
import time

ROOT, SEED, REPS = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
CPU = '--cpu' in sys.argv
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, inputs, trace as tracing  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
device = 'cpu' if CPU else 'cuda:0'
bench = harness.benchmark_file(harness.ROOT.parent)
entry = harness.cell_entry(bench, 'bbc-score')
cfg, mix = inputs.config(entry['config']), inputs.traffic(entry['traffic'])
if CPU:
    from benchmark.tests.conftest import tiny
    t = tiny('score')
    cfg.update(t['config'])
    mix.update(t['traffic'])
log = harness.Log(open(os.devnull, 'w'))
cell = harness.driver(mix['driver']).Cell(cfg, mix, SEED, device, log)
cell.window(1.0 if CPU else 5.0)
served = []
serve = cell._serve


def keep(seconds):
    r = serve(seconds)
    served.append(r['service'])
    return r


cell._serve = keep
reader = harness.metric_reader('serve.dispatch_pct.score')
metric = next(m for m in bench['per_layer']
              if m['name'] == 'serve.dispatch_pct.score')
out = {'root': ROOT, 'seed': SEED, 'untraced': [], 'traced': [],
       'dispatch_pct': []}
for _ in range(REPS):
    served.clear()
    cell._serve(mix['traced_seconds'])
    out['untraced'].append(float(np.median(served[0])) * 1e3)
    served.clear()
    tr = tracing.traced(cell.traced, device)
    out['traced'].append(float(np.median(served[0])) * 1e3)
    out['dispatch_pct'].append(reader.read(harness.Reading(
        cfg, mix, {}, tr, cell.traced_work, metric)))
all_u = out['untraced']
out['untraced_p50_ms'] = float(np.median(all_u))
out['traced_p50_ms'] = float(np.median(out['traced']))
print(json.dumps(out), flush=True)

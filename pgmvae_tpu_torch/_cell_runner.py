"""One sweep cell in a process of its own: `run_pipeline --isolate` runs

    python -m pgmvae_tpu_torch._cell_runner

with the cell's ExperimentConfig fields as one JSON object on stdin, plus
`_device` (-1 is the CPU, else a CUDA device index), `_mesh_timeout` (the
seconds a mesh cell's spawned ranks may run) and, for a packed group,
`_packed`: the list of its cells' fields. It prints the result (a dict, or
for a packed group a list of dicts) as the last line of its stdout. Each
result carries `cell_process`: the device the process ran on and its kernel
launches (`ops/kernels.py`), counted over all the cells it ran,
since the caller's own counts never see them.
"""

from __future__ import annotations

import json
import sys


def _config(fields: dict):
    from pgmvae_tpu_torch.driver import ExperimentConfig
    if fields.get('units'):
        fields['units'] = tuple(fields['units'])
    fields['cpt_parents_eval'] = tuple(fields.get('cpt_parents_eval', ()))
    return ExperimentConfig(**fields)


def main() -> int:
    from pgmvae_tpu_torch.driver import (MESH_TIMEOUT, run_experiment,
                                         run_packed_experiments)
    from pgmvae_tpu_torch.ops import kernels

    kw = json.load(sys.stdin)
    index = kw.pop('_device', 0)
    device = 'cpu' if index == -1 else f'cuda:{index}'
    packed = kw.pop('_packed', None)
    mesh_timeout = kw.pop('_mesh_timeout', MESH_TIMEOUT)
    if packed is not None:
        res = run_packed_experiments([_config(c) for c in packed],
                                     device=device)
    else:
        res = run_experiment(_config(kw), device=device,
                             mesh_timeout=mesh_timeout)
    process = {'device': device, 'launches': kernels.counts()}
    for r in (res if packed is not None else [res]):
        r['cell_process'] = process
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

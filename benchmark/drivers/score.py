"""Scoring traffic: an open loop at a fixed rate (`rate_per_s`, steady
arrivals), each request `PgmModel.score` of a batch of rows, the batch
sizes log-uniform on 1 to `max_rows` (see `requests`), its rows a run of
the pool (the valid and test splits) at an offset drawn from the seed.
Requests are served one at a time, as the program serves them; a request's
latency runs from its due time until its per-row PLLs are in host memory,
so a stall delays the requests queued behind it.

Set-up: the data and weights from the seed, the train split's CPT by the
program's stage 2 (`Stage2.cpt`), the `PgmModel`, the request list (sizes
and offsets) from the seed, and one warm call at each size the list holds.

Check: a sample of the window's requests drawn from the seed, the largest
among them, scored again by the reference with its own CPT.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, program, reference
from benchmark.trace import span


def pool(splits: dict) -> np.ndarray:
    """The rows requests are cut from: the valid and test splits."""
    return np.ascontiguousarray(np.concatenate([splits['valid'],
                                                splits['test']]))


def requests(mix: dict, seed: int, pool_rows: int):
    """(sizes, offsets) of the request list. The sizes come in blocks of
    `size_block`, each block the same log-uniform quantiles on
    1..max_rows (so every seed and every window sends the same mix of
    sizes) in an order drawn from the seed; each request is a run of the
    pool at an offset drawn from the seed."""
    rng = np.random.default_rng(inputs.sub_seed(seed, 'requests'))
    top = min(mix['max_rows'], pool_rows)
    m = mix['size_block']
    q = (np.arange(m) + 0.5) / m
    block = np.clip(np.floor(np.exp(q * np.log(top + 1))), 1,
                    top).astype(np.int64)
    sizes = np.concatenate([rng.permutation(block)
                            for _ in range(mix['requests'] // m)])
    offsets = np.floor(rng.uniform(0.0, 1.0, sizes.shape[0]) * (
        pool_rows - sizes + 1)).astype(np.int64)
    return sizes, offsets


# a row is off where its PLL's relative gap to the reference's is above
# this: above the rounding of a sum of n_var logs and the CPT cells that
# near-tie codes move, below a fault's
ROW_OFF = 1e-3


def compare(answers: list, refs: list) -> dict:
    """The mean relative gap of the answers' per-row PLLs to the
    reference's; the share of the answers in which more than half of the
    rows are off (a fault in few requests, or in small ones, reads there
    undiluted by the rows of the others); and, for the record, the largest
    row gap."""
    gaps = [np.abs(a - r) / np.abs(r) for a, r in zip(answers, refs)]
    off = [np.sum(g > ROW_OFF) * 2 > g.size for g in gaps]
    rows = np.concatenate(gaps)
    return {'pll_rel_gap_mean': float(np.mean(rows)),
            'requests_off': float(np.mean(off)),
            'pll_rel_gap_max': float(np.max(rows))}


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from pgmvae_tpu_torch.serving import PgmModel
        from pgmvae_tpu_torch.stage2 import Stage2
        self.cfg, self.mix, self.device, self.log = cfg, mix, device, log
        self.seed = seed
        splits = inputs.shared_factor_splits(cfg, seed)
        self.pool = pool(splits)
        self.sizes, self.offsets = requests(mix, seed, self.pool.shape[0])
        log.part('data and requests')
        params, codebook = program.serving_params(
            inputs.weights(cfg, seed, device))
        log.part('weights', device)
        pcfg = program.model_config(cfg)
        dist = Stage2(pcfg, device=device).cpt(params, codebook,
                                               splits['train'])
        log.part('stage-2 CPT (program)', device)
        self.model = PgmModel(pcfg, params, codebook, dist, device=device)
        self.dist = dist
        for b in np.unique(self.sizes):
            self.model.score(self.pool[:b])
        log.part(f'{len(np.unique(self.sizes))} warm sizes', device)
        self.next = 0
        self.answers = {}
        self.traced_work = {}

    def _serve(self, seconds: float) -> dict:
        """The open loop: request k is due at k / rate_per_s from the start;
        each goes out at its due time, or as soon as the one before it is
        done when the server runs late, and its latency counts from its due
        time. Every request due within `seconds` is served."""
        period = 1.0 / self.mix['rate_per_s']
        n = int(seconds / period)
        lat, late, service, rows = [], [], [], 0
        t0 = time.perf_counter()
        for k in range(n):
            due = t0 + k * period
            while True:
                ahead = due - time.perf_counter()
                if ahead <= 0:
                    break
                if ahead > 2e-3:
                    time.sleep(ahead - 1e-3)
            i = self.next % len(self.sizes)
            b, off = int(self.sizes[i]), int(self.offsets[i])
            start = time.perf_counter()
            with span('bench.request'):
                out = self.model.score(self.pool[off:off + b])
            done = time.perf_counter()
            lat.append(done - due)
            late.append(start - due)
            service.append(done - start)
            self.answers[self.next] = out
            rows += b
            self.next += 1
        return {'lat': np.asarray(lat), 'late': np.asarray(late),
                'service': np.asarray(service), 'rows': rows,
                'elapsed': time.perf_counter() - t0}

    def window(self, seconds: float) -> dict:
        r = self._serve(seconds)
        self.log(f'window: {len(r["lat"])} requests at '
                 f'{self.mix["rate_per_s"]}/s, {r["rows"]} rows, '
                 f'{r["elapsed"]:.3f} s; latency p50 '
                 f'{np.percentile(r["lat"], 50) * 1e3:.3f} ms; generator '
                 f'late p95 {np.percentile(r["late"], 95) * 1e3:.3f} ms, '
                 f'max {r["late"].max() * 1e3:.3f} ms')
        return {'metrics': {
            'score_p95_ms': float(np.percentile(r['lat'], 95)) * 1e3},
            'attempted': len(r['lat']), 'failed': 0}

    def traced(self) -> None:
        first = self.next
        r = self._serve(self.mix['traced_seconds'])
        cfg = self.cfg
        sizes = [int(self.sizes[i % len(self.sizes)])
                 for i in range(first, self.next)]
        self.traced_work = {
            'requests': len(sizes), 'rows': r['rows'],
            'service_s': float(r['service'].sum()),
            'vq_calls': [(cfg['n_var'], b, cfg['dim'], cfg['num_codes'])
                         for b in sizes]}

    def release(self) -> None:
        self.model = None

    def sample(self) -> list:
        """The requests the check scores again: `check_requests` drawn
        from the seed, and the largest served."""
        served = sorted(self.answers)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 'check'))
        pick = set(rng.choice(served, min(len(served),
                                          self.mix['check_requests']),
                              replace=False).tolist())
        sizes = {i: int(self.sizes[i % len(self.sizes)]) for i in served}
        pick.add(max(served, key=lambda i: sizes[i]))
        return sorted(pick)

    def check(self) -> dict:
        cfg = self.cfg
        splits = inputs.shared_factor_splits(cfg, self.seed)
        w = inputs.weights(cfg, self.seed, self.device)
        table = reference.cpt(w, cfg, torch.as_tensor(splits['train'],
                                                      device=self.device))
        answers, refs = [], []
        for i in self.sample():
            j = i % len(self.sizes)
            b, off = int(self.sizes[j]), int(self.offsets[j])
            rows = torch.as_tensor(self.pool[off:off + b],
                                   device=self.device)
            refs.append(reference.score(w, cfg, table, rows).cpu().numpy())
            answers.append(self.answers[i])
        gaps = compare(answers, refs)
        rows = np.concatenate([np.abs(a - r) / np.abs(r)
                               for a, r in zip(answers, refs)])
        self.log(f'pll_rel_gap_max {gaps["pll_rel_gap_max"]!r} (not '
                 f'compared: near-tie codes set it); rows above 1e-5, '
                 f'1e-4, 1e-3: ' + ', '.join(
                     f'{np.mean(rows > t):.5f}' for t in (1e-5, 1e-4, 1e-3))
                 + f' of {rows.size}')
        return {'cpt_cells_off': reference.cpt_cells_off(self.dist,
                                                         table.cpu()),
                'pll_rel_gap_mean': gaps['pll_rel_gap_mean'],
                'requests_off': gaps['requests_off']}

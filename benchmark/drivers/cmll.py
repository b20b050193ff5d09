"""Gibbs CMLL traffic: a `GibbsChain` over the configuration's test split,
blocks of p1 = n_var // `p1_divisor` variables, burn-in `burn_in` sweeps,
stepped until `--seconds` have passed.

Set-up: the data and weights from the seed; the train split's CPT by the
program's stage 2 (`Stage2.cpt`); the chain; `warm_steps` steps, which
capture its step graph. The uniforms are the benchmark's own: step i reads
row i mod G of a [G, blocks, B] draw made for its group of G steps from the
seed (`uniform`), handed in through `GibbsChain.run`.

Check: once the window has closed, `check_steps` more steps run one at a
time through the same chain and call, each from the chain's own state
(past the burn-in, so that the counts move). The reference works out its
own CPT from the train split and follows each of those steps from the
program's state before it, with the same uniforms.
"""

from __future__ import annotations

import time

import torch

from benchmark import inputs, program, reference
from benchmark.trace import span


def draws_off(state, counts, ref_state, ref_counts) -> int:
    """Entries of a step's new state and counts that differ from the
    reference's step from the same state."""
    return int(torch.sum(state.float() != ref_state)
               + torch.sum(counts.float() != ref_counts))


def uniform_group(seed: int, group: int, g: int, blocks: int, rows: int,
                  device) -> torch.Tensor:
    """The uniforms [G, blocks, B] of steps group*G .. group*G + G - 1."""
    gen = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, 'gibbs', group))
    return torch.rand((g, blocks, rows), generator=gen, device=device)


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from pgmvae_tpu_torch.gibbs import GibbsChain
        from pgmvae_tpu_torch.stage2 import Stage2
        self.cfg, self.mix, self.device, self.log = cfg, mix, device, log
        self.seed = seed
        splits = inputs.shared_factor_splits(cfg, seed)
        self.rows = splits['test'].shape[0]
        log.part('data')
        params, codebook = program.serving_params(
            inputs.weights(cfg, seed, device))
        log.part('weights', device)
        pcfg = program.model_config(cfg)
        self.dist = Stage2(pcfg, device=device).cpt(params, codebook,
                                                    splits['train'])
        log.part('stage-2 CPT (program)', device)
        self.p1 = max(cfg['n_var'] // mix['p1_divisor'], 1)
        self.blocks, _ = reference.gibbs_layout(cfg['n_var'], self.p1)
        self.chain = GibbsChain(params, codebook, pcfg, self.dist,
                                splits['test'], self.p1, mix['burn_in'])
        self._group, self._u = None, None
        self.step = 0
        self._run(mix['warm_steps'])
        log.part(f'{mix["warm_steps"]} warm steps (graph capture)', device)
        self.traced_work = {}

    def uniform(self, i: int) -> torch.Tensor:
        """Step i's uniforms [blocks, B]: row i mod G of its group's draw."""
        g = self.mix['uniform_group']
        if self._group != i // g:
            self._group = i // g
            self._u = uniform_group(self.seed, self._group, g, self.blocks,
                                    self.rows, self.device)
        return self._u[i % g]

    def _run(self, steps: int) -> None:
        with span('bench.gibbs_steps'):
            self.chain.run(self.step, steps, self.uniform)
            program.sync(self.device)
        self.step += steps

    def window(self, seconds: float) -> dict:
        first, t0 = self.step, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._run(self.mix['steps_per_call'])
        elapsed = time.perf_counter() - t0
        steps = self.step - first
        self.log(f'window: {steps} steps (to step {self.step}), '
                 f'{elapsed:.3f} s')
        return {'metrics': {'cmll_steps_per_s': steps / elapsed},
                'attempted': steps, 'failed': 0}

    def traced(self) -> None:
        steps = self.mix['traced_steps']
        self._run(steps)
        cfg = self.cfg
        self.traced_work = {
            'steps': steps,
            'vq_calls': [(self.blocks, self.rows, cfg['dim'],
                          cfg['num_codes'])] * steps}

    def release(self) -> None:
        """The checked steps (from the chain's own state, one call each),
        then the chain freed."""
        chain = self.chain
        # past the burn-in, so that the checked steps count
        start = max(self.step, self.mix['burn_in'] * self.p1 + 1)
        if start > self.step:
            self._run(start - self.step)
        self.before, self.after = [], []
        # the states hold 0/1 and the counts whole numbers: kept as uint8
        # and int32 copies
        for _ in range(self.mix['check_steps']):
            self.before.append((self.step, chain.state.to(torch.uint8),
                                chain.counts.to(torch.int32)))
            self._run(1)
            self.after.append((chain.state.to(torch.uint8),
                               chain.counts.to(torch.int32)))
        chain.release()
        self.chain = None

    def check(self) -> dict:
        cfg = self.cfg
        splits = inputs.shared_factor_splits(cfg, self.seed)
        w = inputs.weights(cfg, self.seed, self.device)
        table = reference.cpt(w, cfg, torch.as_tensor(splits['train'],
                                                      device=self.device))
        off = total = 0
        for (i, state, counts), (p_state, p_counts) in zip(self.before,
                                                            self.after):
            r_state, r_counts = reference.gibbs_step(
                w, cfg, table, state.float(), counts.float(), i,
                self.uniform(i), self.p1, self.mix['burn_in'])
            off += draws_off(p_state, p_counts, r_state, r_counts)
            total += self.blocks * self.rows
        return {'cpt_cells_off': reference.cpt_cells_off(self.dist,
                                                         table.cpu()),
                'draws_off': off / total}

"""Stage-1 training traffic: whole epochs of `Trainer.run_epochs` (with
`pack_seeds` > 1, `run_epochs_packed` over that many model seeds) on the
configuration's train split, batch `batch`, replayed step graphs.

Set-up: the data and each model seed's weights from the seed; one Trainer
and one state (packed: S states stacked), and a copy of that start; epoch 0
through the window's own call (`run_epochs`), which captures the epoch's
step graph; the state set back to its start; then the first `check_steps`
steps of epoch 0 again, each one replay of that same captured graph over
the permutation epoch 0 left in it, with the restart draws of epoch 0's
generator. Their losses, the first gradient (from Adam's first moment
after step 1) and the parameters' change are kept for the check. The
window runs epochs 1, 2, ... of the same state until `--seconds` have
passed, with a device synchronisation after each.

On the CPU the program captures no graph: its epoch body runs eagerly, and
the checked steps run the trainer's step (`train_step`, or
`train_step_packed`) on the same rows.

Model seeds: the run's seed unpacked; packed, S*seed + 1 .. S*seed + S.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, program, reference
from benchmark.trace import span

# the gradient a reading leaves out: under this share of the median leaf's
# first-step gradient norm in the reference (round-off alone moves such a
# leaf under Adam)
NOUGHT = 1e-3


def model_seeds(seed: int, pack: int) -> list:
    """The run's seed unpacked; packed, S*seed + 1 .. S*seed + S."""
    return [seed] if pack == 1 else [pack * seed + s + 1 for s in range(pack)]


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from pgmvae_tpu_torch.train import Trainer, copy_state
        self.cfg, self.mix, self.device, self.log = cfg, mix, device, log
        self.pack = int(mix['pack_seeds'])
        self.seed = seed
        self.seeds = model_seeds(seed, self.pack)
        train = inputs.shared_factor_splits(cfg, seed)['train']
        self.data = torch.as_tensor(train, device=device)
        self.n = train.shape[0]
        log.part('data', device)

        self.trainer = Trainer(program.model_config(cfg),
                               cfg['learning_rate'], mix['batch'], self.n,
                               adam_eps=cfg['adam_eps'], adam_impl='optax',
                               device=device)
        gens = [torch.Generator(device=device).manual_seed(
            inputs.sub_seed(s, 'program-init')) for s in self.seeds]
        if self.pack == 1:
            self.state = self.trainer.init_state(gens[0])
        else:
            self.state = self.trainer.init_states_packed(gens)
        start = []
        for i, s in enumerate(self.seeds):
            w = inputs.weights(cfg, s, device)
            program.load_weights(self.state,
                                 w, None if self.pack == 1 else i)
            start.append(w)
        log.part('weights and state', device)

        snapshot = copy_state(self.state)
        self.check_replays = 0
        self.epoch = 0
        self._epochs(1)
        log.part('epoch 0 (graph capture)', device)

        self._first_steps(snapshot, start)
        del snapshot, start
        if torch.device(device).type == 'cuda':
            torch.cuda.empty_cache()
        log.part(f'{self.mix["check_steps"]} checked steps', device)
        self.traced_work = {}

    # ------------------------------------------------------------ set-up --
    def _epoch0(self):
        """Epoch 0's permutation [steps, S, B] of each model seed and its
        generator as the epoch leaves it to the restarts (after drawing the
        permutation), both as `run_epoch(_packed)` makes them; no
        generators where the configuration restarts no code."""
        tr = self.trainer
        gens = [tr.epoch_generator(s, 0) for s in self.seeds]
        perm = torch.stack([tr._padded_perm(g) for g in gens], 1)
        return perm, (gens if self.cfg['dead_code_threshold'] > 0 else [])

    def _first_steps(self, snapshot, start) -> None:
        """The checked steps from the start state: replays of the window's
        epoch graph over the permutation epoch 0 left in it (on the CPU,
        the trainer's eager step on the same rows). The trainer has no
        public entry that runs part of an epoch, so this takes its cached
        graph (`_graphs`) and permutation (`_padded_perm`) as `run_epoch`
        does."""
        from pgmvae_tpu_torch.train import copy_state_into
        tr = self.trainer
        copy_state_into(self.state, snapshot)
        graph = tr._graphs.get('packed' if self.pack > 1 else 'epoch')
        perm, gens = self._epoch0()
        b1 = float(np.float32(1.0) - np.float32(reference.B1))
        losses, grad1 = [], None
        if graph is not None:
            ep = graph.buffers
            ep.i.zero_()
        for t in range(self.mix['check_steps']):
            if graph is not None:
                ep.total.zero_()
                ep.wtot.zero_()
                graph.run(1, gens)
                self.check_replays += 1
                m = (ep.total / ep.wtot).view(self.pack, -1)
            else:
                m = self._eager_step(perm[t], gens)
            losses.append(m[:, 0].clone())
            if grad1 is None:
                grad1 = self._leaf_norms(
                    lambda t: t / b1, self.state.opt_state.mu)
        self.prog = {'loss': torch.stack(losses, 1).tolist(),
                     'grad1': grad1,
                     'delta': self._deltas(start)}

    def _eager_step(self, rows, gens):
        """The trainer's own step on the rows [S, B] of the data."""
        tr, bs = self.trainer, self.mix['batch']
        w = torch.ones(bs, device=self.device)
        y = self.data[rows.reshape(-1)].view(self.pack, bs, -1)
        if self.pack == 1:
            self.state, m = tr.train_step(self.state, y[0], w,
                                          gens[0] if gens else None)
            return m[None]
        self.state, m = tr.train_step_packed(self.state, y, w, gens or None)
        return m

    def _seed_leaves(self, params):
        """[seed][leaf] tensors of a params dict, enc then dec, (w, b)."""
        out = []
        for i in range(self.pack):
            out.append([(t if self.pack == 1 else t[i])
                        for stack in ('enc', 'dec') for layer in params[stack]
                        for t in layer])
        return out

    def _leaf_norms(self, fn, params):
        return [[reference.norms(fn(t)) for t in leaves]
                for leaves in self._seed_leaves(params)]

    def _deltas(self, start):
        now = self._seed_leaves(self.state.params)
        cb = self.state.ema.codebook
        out = []
        for i, w in enumerate(start):
            ref = [t for stack in ('enc', 'dec') for layer in w[stack]
                   for t in layer]
            d = [reference.norms(a - b) for a, b in zip(now[i], ref)]
            d.append(reference.norms((cb if self.pack == 1 else cb[i])
                                     - w['codebook']))
            out.append(d)
        return out

    def _epochs(self, count: int) -> None:
        tr = self.trainer
        for _ in range(count):
            with span('bench.epoch'):
                if self.pack == 1:
                    self.state, _ = tr.run_epochs(self.state, self.data,
                                                  self.seed, self.epoch, 1)
                else:
                    self.state, _ = tr.run_epochs_packed(
                        self.state, self.data, self.seeds, self.epoch, 1)
                program.sync(self.device)
            self.epoch += 1

    # ------------------------------------------------------------ window --
    def window(self, seconds: float) -> dict:
        first, t0 = self.epoch, time.perf_counter()
        ends = []
        while True:
            self._epochs(1)
            ends.append(time.perf_counter() - t0)
            elapsed = ends[-1]
            if elapsed >= seconds:
                break
        epochs = self.epoch - first
        samples = epochs * self.n * self.pack
        each = np.diff([0.0] + ends)
        self.log(f'window: {epochs} epochs, {samples} samples, '
                 f'{elapsed:.3f} s; epoch seconds '
                 + ' '.join(f'{t:.4f}' for t in each))
        return {'metrics': {'train_samples_per_s': samples / elapsed},
                'attempted': epochs * self.trainer.steps_per_epoch,
                'failed': 0}

    def traced(self) -> None:
        """One epoch, for the trace."""
        self._epochs(1)
        cfg = self.cfg
        self.traced_work = {
            'steps': self.trainer.steps_per_epoch,
            'samples': self.n * self.pack,
            'vq_calls': [(cfg['n_var'] * self.pack, self.mix['batch'],
                          cfg['dim'], cfg['num_codes'])]
            * self.trainer.steps_per_epoch,
            'adam_updates': self.trainer.steps_per_epoch,
        }

    def release(self) -> None:
        tr = self.trainer
        tr.release_graphs()
        stats = tr.graph_stats.get('packed' if self.pack > 1 else 'epoch')
        want = self.epoch * tr.steps_per_epoch - 1 + self.check_replays
        if stats is not None and stats['replays'] != want:
            self.log(f'warning: {stats["replays"]} replays of the epoch '
                     f'graph, {want} expected: a capture fell inside the '
                     f'measured epochs')
        self.trainer = self.state = self.data = None

    # ------------------------------------------------------------- check --
    def check(self) -> dict:
        """The first steps again in the plain reference, from the same
        weights, on the rows of epoch 0's permutation and with its restart
        draws, both worked out again from the seed; the gaps by the worst
        seed and step, and by the median network's worst leaf (see
        `compare`)."""
        cfg, bs = self.cfg, self.mix['batch']
        train = torch.as_tensor(
            inputs.shared_factor_splits(cfg, self.seed)['train'],
            device=self.device)
        loss_gap = grad_gap = delta_gap = 0.0
        for i, s in enumerate(self.seeds):
            perm, gen = reference.epoch_permutation(s, 0, self.n,
                                                    self.device)
            batches = [train[perm[t * bs:(t + 1) * bs]]
                       for t in range(self.mix['check_steps'])]
            ref = reference.train(inputs.weights(cfg, s, self.device), cfg,
                                  batches, gen, steps=len(batches))
            loss_gap, grad_gap, delta_gap = (
                max(a, b) for a, b in zip(
                    (loss_gap, grad_gap, delta_gap),
                    compare(self.prog, i, ref)))
        return {'loss_gap': loss_gap, 'grad1_gap': grad_gap,
                'delta_gap': delta_gap}


def compare(prog: dict, i: int, ref: dict):
    """(loss, first-gradient and change gaps) of model seed i's readings
    against the reference's: the loss by its relative gap; the norms, each
    leaf network by network (`reference.gap_by_leaf`), over the leaves whose
    first gradient is not nought to rounding in the reference (the EMA
    codebook's change always counts), by each network's worst leaf, and of
    those the median network. One network's code search can part from the
    reference's at a near-tie that float32 rounding decides, and its leaves
    from there on; every fault of a stacked step moves every network."""
    lp, lr = np.asarray(prog['loss'][i]), np.asarray(ref['loss'])
    loss = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    g_ref = np.asarray(ref['grad1'])                       # [leaf, network]
    leaf = np.sqrt(np.sum(g_ref ** 2, 1))
    keep = leaf >= NOUGHT * np.median(leaf)
    g = reference.gap_by_leaf(prog['grad1'][i], g_ref, g_ref)[keep]
    keep_d = np.append(keep, True)
    d_ref = np.asarray(ref['delta'])
    d = reference.gap_by_leaf(prog['delta'][i], d_ref, d_ref)[keep_d]
    return (loss, float(np.median(np.max(g, 0))),
            float(np.median(np.max(d, 0))))

"""Experiment driver: one (dataset x hyperparameters) cell, end to end (the
port of `pgmvae_tpu/driver.py`).

`run_packed_experiments` runs cells that differ only in seed as one packed
program (`Trainer.fit_packed`), then stage 2 per seed.
`run_experiment` trains stage 1 (from a checkpoint with `resume`),
optionally keeping the snapshot with the best valid PLL, then computes the
stage-2 CPT and the PLL of the three splits, the Gibbs CMLL of the test
split with `cmll`, writes a checkpoint with `checkpoint`, and the post-hoc
joint-CPT records (with a mixture's own CMLL and `<checkpoint>.mix`). It
returns a plain dict, as the JAX package's does. `ExperimentConfig` is the
port's own copy of the JAX package's, with the same fields, defaults,
checks and identifier.

A device mesh (`mesh_data` x `mesh_model` > 1): the variable axis is padded
up to a multiple of `mesh_model` with inert networks (`n_active` threads the
true count through), the default units widen with `mesh_model`, and every
rank runs `run_experiment` under one `MeshContext`. Called outside a world,
`run_experiment` spawns the ranks itself (`parallel.mesh.spawn`) and returns
rank 0's result, with the mesh's shape, backend, the ranks' devices and
their summed kernel launches under 'mesh'. Only rank 0 writes logs and
checkpoints; the CMLL runs on rank 0 with the gathered model while the
other ranks wait.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

@dataclasses.dataclass
class ExperimentConfig:
    name: str
    embedding: int                      # K
    dim: int                            # D
    batch: int = 128
    epoch: int = 200
    rate: float = 0.001
    cost: float = 0.25
    ema: bool = False
    decay: float = 0.99
    seed: int = 0
    note: str = ''
    quantizer: Optional[str] = None     # override; default from `ema`
    units: Optional[Tuple[int, ...]] = None
    mesh_data: int = 1
    mesh_model: int = 1
    zero_debias: bool = True
    dead_code_threshold: float = 0.0   # >0: EMA dead-code restarts
    fan_mode: str = 'tf_stacked'    # init fan semantics (see initializers)
    activation: str = 'selu'
    l2_reg: float = 0.0
    vq_impl: str = 'auto'
    precision: str = 'default'
    cmll: bool = False
    select_on_valid: int = 0   # >0: evaluate valid PLL every N epochs and
    #                            keep the best snapshot (anti-overfit; the
    #                            reference always uses the final epoch)
    cpt_parents: int = 0   # >0: joint-code CPTs — condition each variable's
    #                        stage-2 table on the values of its m highest-MI
    #                        partner variables as well as its code
    #                        (stage2.select_parents); 0 = reference semantics
    cpt_parents_eval: Tuple[int, ...] = ()  # extra parent counts evaluated
    #                        POST-HOC on the trained (and, with
    #                        select_on_valid, M=cpt_parents-selected) state:
    #                        stage-1 training is independent of M, so one
    #                        training yields one stage-2 record per listed M
    #                        (identifier suffix cpe-M) — an S-way cheaper
    #                        sweep than a --cpt-parents grid. With
    #                        select_on_valid == 0 a cpe-M number is
    #                        bit-identical to a from-scratch cptp-M cell
    #                        (tests/test_cpt_parents.py); with selection the
    #                        snapshot is picked on the PRIMARY M's valid PLL
    cpt_parents_mix: bool = False  # with cpt_parents_eval: also emit ONE
    #                        mixed stage-2 record where EACH VARIABLE picks
    #                        its own M — from the candidate set
    #                        {cpt_parents} + cpt_parents_eval — by its
    #                        per-variable VALIDATION PLL contribution (PLL
    #                        is a sum of per-variable terms, so the mixture
    #                        is a legal PLL; the global winner-M is the
    #                        special case where every variable agrees).
    #                        Identifier flag cpm; selection ties break to
    #                        the smaller M
    first_layer: str = 'masked'  # first-encoder-layer implementation
    #                        ('masked' | 'rank1' | 'auto'; models/vqvae.py)
    packed_seeds: int = 1  # >1: this cell was trained as one lane of an
    #                        S-seed vmapped device program (run_pipeline
    #                        --pack-seeds). Encoded in the identifier (pk-S)
    #                        because the packed program's different XLA
    #                        tiling changes f32 accumulation order: measured
    #                        sub-0.1-nat PLL shifts on most datasets, but a
    #                        basin flip on bistable ones (students: packed
    #                        -88.3 vs unpacked -150.4, logs/cmll-r3-rerun.out)
    adam_impl: str = 'optax'  # 'fused'/'pallas': single-pass Adam update in
    #                        the JAX package, ~1 ULP/step from optax there,
    #                        so identifier-encoded; the port takes its one
    #                        Adam kernel for all three ('fused_bf16': its
    #                        bfloat16-moment variant)
    compute_dtype: str = 'f32'  # 'bf16': bfloat16 forward/backward with f32
    #                        master params/moments/EMA/stage-2 (see
    #                        VqVaeConfig.compute_dtype) — a different
    #                        trajectory, identifier-encoded as cd-bf16
    checkpoint: Optional[str] = None
    resume: Optional[str] = None
    data_dir: Optional[str] = None
    verbose: bool = False
    log_dir: Optional[str] = None       # JSONL metrics directory

    def __post_init__(self):
        # Fail BEFORE training, not after: Stage2 only sees M when stage 2
        # starts, so an out-of-range --cpt-parents-eval used to waste a full
        # training run (M too big) or silently evaluate M=0 under a
        # mislabeled, non-round-trippable cpe--1 identifier (M<0). Bounds
        # match Stage2.__init__ (2^M joint-state columns; M<=12 with the
        # byte guard there — counts never build a one-hot, so wide tables
        # are feasible).
        if not 0 <= self.cpt_parents <= 12:
            raise ValueError(f'cpt_parents must be in [0, 12], '
                             f'got {self.cpt_parents}')
        bad = [m for m in self.cpt_parents_eval if not 0 <= m <= 12]
        if bad:
            raise ValueError(f'cpt_parents_eval values must be in [0, 12], '
                             f'got {bad}')
        if self.cpt_parents_mix and not self.cpt_parents_eval:
            raise ValueError('cpt_parents_mix selects per-variable among '
                             'the cpt_parents_eval candidates; pass '
                             '--cpt-parents-eval too')

    @property
    def identifier(self) -> str:
        from pgmvae_tpu_torch.utils.logging import run_identifier
        return run_identifier(self.name, self.embedding, self.dim, self.batch,
                              self.epoch, self.rate, self.cost, self.ema,
                              self.decay, self.seed, self.note,
                              quantizer=self.quantizer, units=self.units,
                              fan_mode=self.fan_mode,
                              dead_code_threshold=self.dead_code_threshold,
                              zero_debias=self.zero_debias,
                              precision=self.precision,
                              activation=self.activation, l2_reg=self.l2_reg,
                              select_on_valid=self.select_on_valid,
                              cpt_parents=self.cpt_parents,
                              first_layer=self.first_layer,
                              packed_seeds=self.packed_seeds,
                              adam_impl=self.adam_impl,
                              compute_dtype=self.compute_dtype,
                              cpt_parents_eval=self.cpt_parents_eval,
                              cpt_parents_mix=self.cpt_parents_mix)


def _check_naive_dim(quantizer: str, dim: int) -> None:
    """Refuse naive-quantizer dims whose stage-2 tables (2^dim columns)
    could never be tabulated — BEFORE training burns a full run (the same
    bound Stage2.__init__ enforces; reference bug context
    core/quantizer.py:179-201)."""
    from pgmvae_tpu_torch.stage2 import NAIVE_STAGE2_MAX_DIM
    if quantizer == 'naive' and dim > NAIVE_STAGE2_MAX_DIM:
        raise ValueError(
            f"quantizer='naive' with dim={dim}: stage 2 counts over 2^dim "
            f"= 2**{dim} code columns per variable; use dim <= "
            f"{NAIVE_STAGE2_MAX_DIM} or a finite-codebook quantizer")


def unported(exp: ExperimentConfig) -> list:
    """What `exp` asks for that the port does not do yet, one message per
    feature, each naming its ROADMAP.md item; empty when it can run, as
    every cell now can."""
    return []


def _cmll(exp, cfg, params, codebook, dist, y_test, parents, device,
          verbose=False, mesh=None):
    """A Gibbs CMLL of the test split with the reference's settings
    (p1 = n_var // 10, 3000 sweeps, burn-in 150; reference run.py:74),
    uniforms from a generator seeded with exp.seed. Under a mesh, params
    and codebook are the gathered model and the chain runs on rank 0."""
    from pgmvae_tpu_torch import gibbs
    from pgmvae_tpu_torch.parallel.mesh import MeshContext

    def chain():
        return gibbs.conditional_marginal_log_likelihood(
            params, codebook, cfg, dist, y_test,
            p1=max(y_test.shape[1] // 10, 1), num_smp=3000, burn_in=150,
            generator=torch.Generator(device=device).manual_seed(exp.seed),
            verbose=verbose, parents=parents)
    return (mesh or MeshContext(None)).on_rank0(chain)


def _posthoc_cpt_records(exp, cfg, params, codebook, y_train, y_valid,
                         y_test, primary_id, platform, device,
                         state=None, mesh=None, full=None) -> list:
    """One stage-2 record per M in exp.cpt_parents_eval, computed from the
    trained `params` (see ExperimentConfig.cpt_parents_eval), and with
    exp.cpt_parents_mix one more record in which each variable keeps the M
    whose validation PLL contribution is highest (ties to the smaller M).
    With exp.cmll the mix record gets its own CMLL over the winners'
    tables composed into one joint CPT (stage2.compose_mixed_cpt, exact);
    with exp.checkpoint (and `state` given) those tables are saved to
    `<checkpoint>.mix`, which PgmModel.from_checkpoint serves. Under a
    `mesh`, `full()` gives the gathered state for the CMLL and the file,
    which rank 0 alone computes and writes."""
    from pgmvae_tpu_torch.stage2 import Stage2, select_parents

    splits = (('train', y_train), ('valid', y_valid), ('test', y_test))
    eval_ms = tuple(dict.fromkeys(exp.cpt_parents_eval))
    loop_ms = eval_ms
    if exp.cpt_parents_mix and exp.cpt_parents not in eval_ms:
        loop_ms = eval_ms + (exp.cpt_parents,)   # primary M is a candidate
    records, per_var = [], {}
    keep_tables = exp.cpt_parents_mix and (       # mix-CMLL / mix-checkpoint
        exp.cmll or (exp.checkpoint and state is not None))
    dists_by_m, parents_by_m = {}, {}
    for m in loop_ms:
        te = time.time()
        par = select_parents(y_train, m) if m > 0 else None
        s2m = Stage2(cfg, mesh_ctx=mesh, parents=par, device=device)
        dist_m = s2m.cpt(params, codebook, y_train)
        if keep_tables:
            dists_by_m[m] = dist_m
            parents_by_m[m] = par
        pll_m = {}
        for split, y in splits:
            pll_m[split], pv = s2m.pll_detail(params, codebook, y, dist_m)
            per_var.setdefault(m, {})[split] = pv
        if m not in eval_ms:
            continue       # primary M: its record is the cell's own
        records.append({
            'identifier': dataclasses.replace(
                exp, cpt_parents_eval=(m,),
                cpt_parents_mix=False).identifier,
            'pll_train': pll_m['train'], 'pll_valid': pll_m['valid'],
            'pll_test': pll_m['test'], 'cmll_test': 1,
            'eval_wall': round(time.time() - te, 3),
            'posthoc_of': primary_id,
            'platform': platform,
        })
    if exp.cpt_parents_mix:
        cands = sorted(per_var)                       # ascending: argmax's
        idx = np.arange(cfg.active_vars)              # first-hit tie rule
        stacked = {split: np.stack([per_var[m][split] for m in cands])
                   for split, _ in splits}            # [C, active_vars]
        sel = np.argmax(stacked['valid'], axis=0)
        mixed = {split: float(stacked[split][sel, idx].sum())
                 for split, _ in splits}
        records.append({
            'identifier': exp.identifier,     # full cpe list + cpm flag
            'pll_train': mixed['train'], 'pll_valid': mixed['valid'],
            'pll_test': mixed['test'], 'cmll_test': 1,
            'eval_wall': 0.0,                 # composed from the cpe passes
            'posthoc_of': primary_id,
            'platform': platform,
            'mix_candidates': cands,
            'mix_m_histogram': {str(cands[i]): int(c) for i, c in
                                enumerate(np.bincount(
                                    sel, minlength=len(cands)))
                                if c},
        })
        if keep_tables:
            from pgmvae_tpu_torch.stage2 import compose_mixed_cpt
            sel_ms = np.asarray(cands, np.int32)[sel]
            mdist, mpar = compose_mixed_cpt(dists_by_m, parents_by_m, sel_ms)
            whole = full() if mesh is not None else None
            if exp.cmll:
                tcm = time.time()
                # the same Gibbs settings as the cell's own CMLL
                records[-1]['cmll_test'] = _cmll(
                    exp, cfg, *_model_of(whole, params, codebook), mdist,
                    y_test, mpar, device, mesh=mesh)
                records[-1]['cmll_wall'] = round(time.time() - tcm, 3)
                records[-1]['cmll_m_max'] = int(sel_ms.max(initial=0))
            if exp.checkpoint and state is not None:
                from pgmvae_tpu_torch import checkpoint as ckpt
                extra = {'identifier': exp.identifier, 'pll': mixed,
                         'mix_m_histogram': records[-1]['mix_m_histogram']}
                if mpar is not None:
                    extra['cpt_parents'] = mpar.tolist()
                if mesh is None or mesh.rank == 0:
                    ckpt.save(exp.checkpoint + '.mix', cfg,
                              state if whole is None else whole, mdist,
                              extra=extra)
                records[-1]['checkpoint'] = exp.checkpoint + '.mix'
    return records


def _model_of(whole, params, codebook) -> tuple:
    """(params, codebook) of the gathered state `whole`, else the given
    ones."""
    if whole is None:
        return params, codebook
    cb = whole.ema.codebook if whole.ema is not None else (
        whole.params.get('codebook'))
    return whole.params, cb


def _model_config(exp: ExperimentConfig):
    """The VqVaeConfig of a cell and its dataset's registry entry. With
    mesh_model > 1 the default units widen with it, and the variable axis
    is padded up to a multiple of it with inert networks."""
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.registry import REGISTRY
    if exp.name not in REGISTRY:
        raise KeyError(f"unknown dataset '{exp.name}'; available: "
                       f"{', '.join(sorted(REGISTRY))}")
    info = REGISTRY[exp.name]
    quantizer = exp.quantizer or ('ema' if exp.ema else 'vq')
    _check_naive_dim(quantizer, exp.dim)
    units = tuple(exp.units) if exp.units else info.encoder_units(
        exp.dim, mesh_model=exp.mesh_model)
    n_var, n_active = info.n_var, None
    if exp.mesh_model > 1 and n_var % exp.mesh_model:
        n_active = n_var
        n_var = -(-n_var // exp.mesh_model) * exp.mesh_model
    cfg = VqVaeConfig(n_var=n_var, n_active=n_active, units=units,
                      dim=exp.dim,
                      num_codes=exp.embedding, cost=exp.cost, decay=exp.decay,
                      quantizer=quantizer, zero_debias=exp.zero_debias,
                      dead_code_threshold=exp.dead_code_threshold,
                      fan_mode=exp.fan_mode, vq_impl=exp.vq_impl,
                      matmul_precision=exp.precision,
                      activation=exp.activation, l2_reg=exp.l2_reg,
                      first_layer=exp.first_layer,
                      compute_dtype=exp.compute_dtype)
    return cfg, info


def _valid_pll(trainer, s2, state, y_train, y_valid) -> float:
    """One select-on-valid check: the valid PLL of `state` under the CPT
    counted on y_train."""
    cb = trainer.codebook(state)
    dist = s2.cpt(state.params, cb, y_train)
    return s2.pseudo_log_likelihood(state.params, cb, y_valid, dist)


def _evaluate(exp, cfg, info, trainer, s2, state, splits, parents, device,
              train_wall, best_epoch=None) -> dict:
    """The result of one trained cell: the stage-2 CPT and the PLL of the
    three `splits` (train, valid, test), the CMLL with exp.cmll, the
    checkpoint with exp.checkpoint and the post-hoc records with
    exp.cpt_parents_eval, as the plain dict the JAX package returns. Under
    a mesh every rank takes part in stage 2 and the gathers; rank 0 alone
    writes the checkpoint."""
    y_train, y_valid, y_test = splits
    mesh = trainer.mesh if trainer.mesh.mesh is not None else None
    codebook = trainer.codebook(state)
    t1 = time.time()
    dist = s2.cpt(state.params, codebook, y_train)
    pll = {split: s2.pseudo_log_likelihood(state.params, codebook, y, dist)
           for split, y in zip(('train', 'valid', 'test'), splits)}
    eval_wall = time.time() - t1

    gathered = []

    def full():
        """The state gathered over 'model' once (a collective: every rank
        calls it at the same point)."""
        if not gathered:
            gathered.append(trainer.unshard_state(state))
        return gathered[0]

    cmll_test = 1  # the reference hardcodes 1 when CMLL is off (run.py:77)
    cmll_wall = None
    if exp.cmll:
        t2 = time.time()
        cmll_test = _cmll(
            exp, cfg, *_model_of(full() if mesh else None, state.params,
                                 codebook),
            dist, y_test, parents, device, verbose=exp.verbose, mesh=mesh)
        cmll_wall = round(time.time() - t2, 3)

    if exp.checkpoint:
        from pgmvae_tpu_torch import checkpoint as ckpt
        extra = {'identifier': exp.identifier, 'pll': pll}
        if parents is not None:
            extra['cpt_parents'] = parents.tolist()
        whole = full() if mesh else state
        if mesh is None or mesh.rank == 0:
            ckpt.save(exp.checkpoint, cfg, whole, dist, extra=extra)

    # the primary record's identity is independent of the post-hoc eval
    # list (training and the primary stage 2 never see it)
    primary_id = dataclasses.replace(exp, cpt_parents_eval=(),
                                     cpt_parents_mix=False).identifier
    platform = 'gpu' if device.type == 'cuda' else 'cpu'
    result = {
        'identifier': primary_id,
        'pll_train': pll['train'], 'pll_valid': pll['valid'],
        'pll_test': pll['test'], 'cmll_test': cmll_test,
        'train_wall': round(train_wall, 3), 'eval_wall': round(eval_wall, 3),
        'samples_per_sec': round(exp.epoch * len(y_train)
                                 / max(train_wall, 1e-9), 1),
        'paper_pll': -info.paper_pll,
        'platform': platform,
    }
    if best_epoch is not None:
        result['best_epoch'] = best_epoch
    if cmll_wall is not None:
        result['cmll_wall'] = cmll_wall
    if mesh is not None:
        result['mesh'] = mesh.describe()
    if exp.cpt_parents_eval:
        result['posthoc'] = _posthoc_cpt_records(
            exp, cfg, state.params, codebook, y_train, y_valid, y_test,
            primary_id, platform, device, state=state, mesh=mesh, full=full)
    return result


def run_packed_experiments(exps, device=None) -> list:
    """Run S cells that differ only in seed as one packed program on
    `device` (None means CUDA; run_pipeline --pack-seeds): the seeds train
    together (`Trainer.fit_packed`, each seed its own trajectory), then stage
    2, the CMLL and the post-hoc records run per seed. Returns one result
    dict per cell, in input order, with identifiers pk-S."""
    from pgmvae_tpu_torch import resolve_device
    from pgmvae_tpu_torch.data.loader import load_split
    from pgmvae_tpu_torch.stage2 import Stage2, select_parents
    from pgmvae_tpu_torch.train import Trainer

    exps = list(exps)
    if not exps:
        return []
    # the packed width is part of the cell's identity
    # (ExperimentConfig.packed_seeds): normalize it to the actual width
    exps = [dataclasses.replace(e, packed_seeds=len(exps)) for e in exps]
    base = exps[0]
    for e in exps[1:]:
        diff = [f.name for f in dataclasses.fields(base)
                if f.name != 'seed'
                and getattr(e, f.name) != getattr(base, f.name)]
        if diff:
            raise ValueError(f'packed cells must differ only in seed; '
                             f'{e.identifier} differs in {diff}')
    if base.mesh_data * base.mesh_model > 1:
        raise ValueError('--pack-seeds does not compose with a device mesh')
    if base.resume or base.checkpoint:
        raise ValueError('--pack-seeds does not support resume/checkpoint '
                         'cells; run those unpacked')
    if len(exps) == 1:
        return [run_experiment(base, device=device)]

    device = resolve_device(device)
    cfg, info = _model_config(base)
    seeds = [e.seed for e in exps]
    y_train = load_split(base.name, 'train', base.data_dir)
    y_valid = load_split(base.name, 'valid', base.data_dir)
    y_test = load_split(base.name, 'test', base.data_dir)
    trainer = Trainer(cfg, base.rate, base.batch, len(y_train),
                      adam_impl=base.adam_impl, device=device)
    parents = (select_parents(y_train, base.cpt_parents)
               if base.cpt_parents > 0 else None)
    s2 = Stage2(cfg, parents=parents, device=device)
    states = trainer.init_states_packed(seeds)

    n_seeds = len(exps)
    best = [(-float('inf'), None, base.epoch)] * n_seeds  # (pll, state, ep)
    t0 = time.time()
    if base.select_on_valid > 0:
        done = 0
        while done < base.epoch:
            blk = min(base.select_on_valid, base.epoch - done)
            states, _ = trainer.fit_packed(states, y_train, blk, seeds,
                                           start_epoch=done)
            done += blk
            for s in range(n_seeds):
                snap = trainer.unpack_seed(states, s)
                pv = _valid_pll(trainer, s2, snap, y_train, y_valid)
                if base.verbose:
                    print(f'select-on-valid[{seeds[s]}]: epoch {done} '
                          f'pll-valid {pv:.5f}')
                if pv > best[s][0]:
                    best[s] = (pv, snap, done)
        seed_states = [b[1] if b[1] is not None
                       else trainer.unpack_seed(states, s)
                       for s, b in enumerate(best)]
    else:
        states, _ = trainer.fit_packed(states, y_train, base.epoch, seeds)
        seed_states = [trainer.unpack_seed(states, s)
                       for s in range(n_seeds)]
    del states
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    train_wall = time.time() - t0

    results = []
    for s, exp in enumerate(exps):
        # samples_per_sec keeps its unpacked meaning (this cell's samples
        # over the shared train wall); the S-seed aggregate has its own key
        best_epoch = best[s][2] if base.select_on_valid > 0 else None
        res = _evaluate(exp, cfg, info, trainer, s2, seed_states[s],
                        (y_train, y_valid, y_test), parents, device,
                        train_wall, best_epoch)
        res['samples_per_sec_packed'] = round(
            n_seeds * exp.epoch * len(y_train) / max(train_wall, 1e-9), 1)
        res['packed_seeds'] = n_seeds
        results.append(res)
    return results


# seconds a spawned mesh world may run before it is terminated: a rank
# stuck outside a collective would otherwise keep the caller waiting
MESH_TIMEOUT = 24 * 3600.0


def _experiment_rank(device, exp: ExperimentConfig) -> dict:
    """One rank of a spawned mesh run (`parallel.mesh.spawn`)."""
    return run_experiment(exp, device=device)


def _run_spawned(exp: ExperimentConfig, device, timeout: float) -> dict:
    """A mesh cell from outside a world: one process per rank, rank 0's
    result, with the ranks' devices and summed kernel launches. A world
    that runs past `timeout` seconds is terminated and raises
    TimeoutError."""
    from pgmvae_tpu_torch.parallel import mesh as pmesh
    ranks = exp.mesh_data * exp.mesh_model
    backend, devices = pmesh.placement(ranks, device)
    print(f'mesh ({exp.mesh_data}, {exp.mesh_model}): {ranks} ranks over '
          f'{backend} on {", ".join(devices)}', file=sys.stderr, flush=True)
    results = pmesh.spawn(_experiment_rank, (exp,), world_size=ranks,
                          device=device, timeout=timeout)
    res = results[0].value
    res['mesh'].update(devices=[r.device for r in results],
                       launches=pmesh.summed_launches(results))
    return res


def run_experiment(exp: ExperimentConfig, device=None,
                   mesh_timeout: float = MESH_TIMEOUT) -> dict:
    """Stage-1 train + stage-2 CPT/PLL on `device` (None means CUDA). A
    mesh cell outside a torch.distributed world spawns its ranks (see the
    module doc) and fails if they run past `mesh_timeout` seconds."""
    from pgmvae_tpu_torch import checkpoint as ckpt
    from pgmvae_tpu_torch import resolve_device
    from pgmvae_tpu_torch.data.loader import load_split
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    from pgmvae_tpu_torch.parallel.mesh import (MeshContext, in_world,
                                                make_mesh)
    from pgmvae_tpu_torch.stage2 import Stage2, select_parents
    from pgmvae_tpu_torch.train import Trainer, copy_state
    from pgmvae_tpu_torch.utils.logging import MetricLogger

    if exp.packed_seeds > 1:
        raise ValueError(
            f'{exp.identifier}: pk-{exp.packed_seeds} identifiers record a '
            f'packed-program trajectory; regenerate with '
            f'run_packed_experiments / run_pipeline --pack-seeds '
            f'{exp.packed_seeds} (unpacked training follows a numerically '
            f'different trajectory)')
    cfg, info = _model_config(exp)
    device = resolve_device(device)
    mesh_ctx = MeshContext(None)
    if exp.mesh_data * exp.mesh_model > 1:
        if not in_world():
            return _run_spawned(exp, device, mesh_timeout)
        mesh_ctx = MeshContext(make_mesh(exp.mesh_data, exp.mesh_model,
                                         device))
    # rank 0 alone writes the logs
    logger = (MetricLogger(exp.log_dir)
              if exp.log_dir and mesh_ctx.rank == 0 else None)

    y_train = load_split(exp.name, 'train', exp.data_dir)
    trainer = Trainer(cfg, exp.rate, exp.batch, len(y_train),
                      mesh_ctx=mesh_ctx, adam_impl=exp.adam_impl,
                      device=device)
    state = trainer.init_state(exp.seed)
    if exp.resume:
        saved_cfg, state, _, _ = ckpt.load(exp.resume, state_template=state)
        # the loader does not check shapes, and semantic fields (decay,
        # cost, zero_debias, quantizer ...) would silently change training
        # dynamics: refuse any mismatch up front. The run then trains
        # exp.epoch more epochs, epoch generators from 0, as the JAX
        # package's does.
        mismatches = [
            f'{f}: checkpoint={getattr(saved_cfg, f)!r} '
            f'cli={getattr(cfg, f)!r}'
            for f in VqVaeConfig._fields
            if f not in ('vq_impl', 'matmul_precision')  # execution-only knobs
            and getattr(saved_cfg, f) != getattr(cfg, f)]
        if mismatches:
            raise ValueError(
                f'--resume {exp.resume}: checkpoint config does not match the '
                f'requested run: ' + '; '.join(mismatches))
        state = trainer.shard_state(state)
    parents = (select_parents(y_train, exp.cpt_parents)
               if exp.cpt_parents > 0 else None)
    s2 = Stage2(cfg, mesh_ctx=mesh_ctx, parents=parents, device=device)
    log_fn = logger.log_epoch if logger else None
    y_valid = load_split(exp.name, 'valid', exp.data_dir)
    y_test = load_split(exp.name, 'test', exp.data_dir)
    best_epoch = None
    t0 = time.time()
    if exp.select_on_valid > 0:
        # block training with a valid-PLL check after each block: epoch
        # generators depend on (seed, epoch) alone, so the trajectory is the
        # one plain `fit` takes; only which point of it is kept differs
        best_pll, best_state, done = -float('inf'), None, 0
        while done < exp.epoch:
            blk = min(exp.select_on_valid, exp.epoch - done)
            state, _ = trainer.fit(state, y_train, blk, exp.seed,
                                   verbose=exp.verbose, log_fn=log_fn,
                                   start_epoch=done)
            done += blk
            pv = _valid_pll(trainer, s2, state, y_train, y_valid)
            if exp.verbose:
                print(f'select-on-valid: epoch {done} pll-valid {pv:.5f}')
            if pv > best_pll:
                # train steps update the state in place: keep a copy
                best_pll, best_state, best_epoch = pv, copy_state(state), done
        if best_state is None:
            # every valid PLL was NaN (a diverged cell) or epoch == 0
            print('select-on-valid: no finite valid PLL seen; '
                  'keeping the final state', flush=True)
            best_epoch = exp.epoch
        else:
            state = best_state
    else:
        state, _ = trainer.fit(state, y_train, exp.epoch, exp.seed,
                               verbose=exp.verbose, log_fn=log_fn)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    train_wall = time.time() - t0

    result = _evaluate(exp, cfg, info, trainer, s2, state,
                       (y_train, y_valid, y_test), parents, device,
                       train_wall, best_epoch)
    if logger:
        logger.log_final(**result)
        logger.close()
    return result

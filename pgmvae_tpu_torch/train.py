"""Stage-1 training engine (the port of `pgmvae_tpu/train.py`).

The dataset is placed on the device once. An epoch draws a permutation,
pads it with sentinel rows (-1) to whole batches, and runs one train step
per batch: the ragged last batch carries 0/1 sample weights through every
mean and statistic, so its padded rows are exact no-ops. Each step is one
forward and backward pass, then the Adam update in place through the CUDA
kernel of `ops/fused_adam.py`, then the EMA codebook update in place
(`ema_step`: on CUDA the kernel of `ops/cuda_ema.py`). Metrics stay on
the device and are read once per epoch when the caller logs them, else once
per `fit`. adam_impl 'fused_bf16' keeps the Adam moments in bfloat16.

Loss: mse over each network's leave-one-out reconstruction, plus
cost*e_loss (plus q_loss for the 'vq' quantizer), plus l2_reg*l2_penalty.
The mse and the mae metric come from the decoder's logits through
`ops/cuda_recon.py`: on CUDA one forward and one backward kernel a step.
Adam uses eps=1e-7 (the Keras default).

compute_dtype 'bf16': the forward and backward passes run in bfloat16. The
float32 params are cast inside the autograd graph, so their gradients come
back float32 through the cast; the samples and the EMA codebook are cast
too. Master params, Adam moments, EMA statistics, loss sums and metrics stay
float32. Stage 2, serving and the Gibbs chain never read compute_dtype.

Streaming epochs: a dataset past `stream_bytes` stays on the host. Its
epochs draw the in-core permutation (on the device, copied to the host once
an epoch) and gather each chunk of batches on the host into one of two
pinned buffers, whose copy to the device overlaps the previous chunk's
steps. The steps, weights and restart draws are the in-core ones, so a
streamed `fit` is bit-equal to an in-core one on the same device.

Packed seeds: `init_states_packed(seeds)` stacks S states leaf by leaf
(every tensor [S, ...], the JAX package's vmapped layout) and `fit_packed`
trains them together. A packed step views each [S, n, ...] leaf as
[S * n, ...]: one `baddbmm` per layer, one nearest-code launch and one Adam
launch per leaf cover all S seeds. Each seed keeps its own epoch generators,
hence its own permutations and restart draws, and its own losses: the
means divide by the per-seed n, so every seed's gradient is its unpacked
gradient.

Randomness: epoch e draws its permutation and its dead-code restart rows
from a generator seeded from (seed, e) alone, so fit(a) followed by
fit(b, start_epoch=a) is bit-identical to fit(a + b).

Train steps update the state's params and moments in place, and its EMA
counts, dw and codebook where one 'data' rank holds them (not its step
counters); `copy_state` takes a snapshot that later steps leave alone.

Epochs as CUDA graphs (the counterpart of the JAX package's epoch `scan`
and its blocks of epochs): an epoch runs one step body over static buffers
(`graphs.StepGraph`). The body takes row i of a static permutation buffer
through a device step counter, gathers its batch (from the device data, or
from a static chunk buffer that the streamed epoch refills every chunk),
derives w from that row, runs the train step, copies the tensors the step
made anew (the step counters; under restarts or a 'data' axis the EMA
state) into the state's own, and adds the step's metrics into static sums.
The permutation is drawn eagerly, once an epoch. On CUDA the epoch's first
step runs eagerly as the warm-up, the body is captured, and every other
step is a replay; the graph stays on the Trainer, keyed on the addresses
and shapes of the state and data, and is captured anew for another state or
data tensor (`fit` and `fit_packed` release it before they return). Every
batch is [bs, n_var] with 0/1 weights, so the ragged last batch needs no
graph of its own. The restart draws come from the graph's own generators,
which take the epoch generators' state before the replays: the replayed
epoch is bit-equal to the eager loop (`Trainer(graphs=False)`, and the
CPU's). The epoch updates the state in place: it returns the state it was
given.

A device mesh (`mesh_ctx`, `parallel/mesh.py`): `init_state` draws the
global model on the host from the int seed and `shard_state` keeps the
rank's networks of every stacked leaf, so a mesh run starts from the
numbers of a single-device run. A step takes the global batch and keeps the
rank's rows; the losses are the rank's partial sums of the global means
(the global mask columns, n_active and sum of weights); gradients and EMA
statistics are all-reduced over 'data' before the Adam kernel and the EMA
update (with more than one 'data' rank the EMA step takes the dense
`code_stats` and `ema_update`, not the kernel); dead-code restarts draw
the global [n_var, K] rows from the shared generator and take them from
the batch's latents gathered over 'data'; the metrics are all-reduced
over the world. Under NCCL the step with its collectives is captured into
the epoch's graph; under gloo, whose collectives cannot be captured,
epochs run the eager loop. Packed seeds refuse a mesh.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from pgmvae_tpu_torch import graphs, resolve_device
from pgmvae_tpu_torch.data.pinned import pinned_pieces
from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.ops import cuda_ema, cuda_recon, fused_adam
from pgmvae_tpu_torch.ops import quantizer as q
from pgmvae_tpu_torch.parallel.mesh import MeshContext, shard_leading_axis
from pgmvae_tpu_torch.trace import span

# Largest code space for which the per-step usage histogram is computed;
# beyond it (naive quantizer, dim > 16) perplexity is reported as 0.
PERPLEXITY_MAX_CODES = 1 << 16

# adam_impl values: the JAX package's 'optax', 'fused' and 'pallas' compute
# one function (tests/test_fused_adam.py), so all three take the kernel; the
# identifier still records the choice. 'fused_bf16' keeps the moments in
# bfloat16 and takes the kernel's bfloat16 variant.
ADAM_IMPLS = ('optax', 'fused', 'pallas', 'fused_bf16')
COMPUTE_DTYPES = {'f32': None, 'bf16': torch.bfloat16}


class TrainState(NamedTuple):
    params: dict                       # {'enc','dec'[, 'codebook' if 'vq']}
    ema: Optional[q.EmaState]          # EMA quantizer state ('ema' only)
    opt_state: fused_adam.AdamState
    step: torch.Tensor                 # int32 scalar: steps taken


class EpochMetrics(NamedTuple):
    loss: float        # total (mse + quantizer aux), sample-weighted
    mse: float         # reconstruction mse
    mae: float         # mean absolute reconstruction error
    perplexity: float  # codebook usage: exp(entropy of code histogram)


def _map_state(fn, *states):
    """`fn` over the tensors of one or more states of one structure (named
    tuples, params dicts, lists of layers); any other leaf (None, the Adam
    eps) is taken from the first."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    if isinstance(first, dict):
        return {k: _map_state(fn, *(s[k] for s in states)) for k in first}
    if isinstance(first, tuple) and hasattr(first, '_fields'):
        return type(first)(*(_map_state(fn, *f) for f in zip(*states)))
    if isinstance(first, (list, tuple)):
        return type(first)(_map_state(fn, *f) for f in zip(*states))
    return first


def copy_state(state: TrainState) -> TrainState:
    """A deep copy of every tensor of `state`."""
    return _map_state(torch.clone, state)


def _assign(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Copy a tensor a step made anew into the state tensor it replaces;
    nothing where the step wrote into the state tensor itself (`src` is
    `dst`, or a view of it with its shape: the EMA kernel's packed state)."""
    if dst is not src and not (dst.data_ptr() == src.data_ptr()
                               and dst.shape == src.shape
                               and dst.stride() == src.stride()):
        dst.copy_(src)
    return dst


def ema_step(ema: q.EmaState, z: torch.Tensor, indices: torch.Tensor,
             w: torch.Tensor, cfg: vqvae.VqVaeConfig, mesh: MeshContext):
    """The EMA codebook step of a train step: (new EmaState, the batch
    counts [n, K]). Where the 'data' axis has more than one rank, each
    rank's statistics are summed over it before the update: `code_stats`,
    the all-reduce, `ema_update`. Otherwise `cuda_ema.ema_update_fused`,
    which updates the state's tensors in place: the kernel on CUDA, its
    plain version (the same two functions) on the CPU."""
    if mesh.shape[0] > 1:
        counts, dw = mesh.all_reduce_many(
            q.code_stats(z, indices, cfg.num_codes, weights=w), 'data')
        return q.ema_update(ema, counts, dw, cfg.decay, cfg.epsilon,
                            cfg.zero_debias), counts
    return cuda_ema.ema_update_fused(ema, z, indices, w, cfg.decay,
                                     cfg.epsilon, cfg.zero_debias)


def copy_state_into(dst: TrainState, src: TrainState) -> TrainState:
    """Every tensor of `src` copied into the matching tensor of `dst` (one
    structure and shapes); returns `dst`, which keeps its addresses, so an
    epoch graph captured over it replays from `src`'s values."""
    return _map_state(_assign, dst, src)


def _state_key(state: TrainState) -> tuple:
    """The addresses, shapes and types of a state's tensors: what a graph
    captured over the state holds."""
    tensors = []
    _map_state(tensors.append, state)
    return graphs.tensor_key(*tensors)


class _EpochBuffers(NamedTuple):
    """The static buffers an epoch body reads besides the state and data."""
    perm: torch.Tensor       # [steps, bs] (packed [steps, S, bs]) row ids
    i: torch.Tensor          # int64 [1]: the step that runs next
    total: torch.Tensor      # [4] (packed [S, 4]) weighted metric sums
    wtot: torch.Tensor       # float32 scalar: the weights' sum
    # a streamed epoch's device chunk [chunk, bs, n_var] and its row j
    chunk: Optional[torch.Tensor] = None
    j: Optional[torch.Tensor] = None


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s generator: a function of (seed, epoch)
    alone."""
    mixed = np.random.SeedSequence([seed & (2 ** 64 - 1), epoch])
    return int(mixed.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """Trains one model configuration on `device` (None means CUDA)."""

    def __init__(self, cfg: vqvae.VqVaeConfig, learning_rate: float,
                 batch_size: int, n_train: int,
                 mesh_ctx: Optional[MeshContext] = None,
                 adam_eps: float = 1e-7,
                 stream_bytes: int = 4 << 30,
                 stream_chunk_bytes: int = 64 << 20,
                 adam_impl: Optional[str] = None, device=None,
                 graphs: bool = True):
        self.mesh = mesh_ctx or MeshContext(None)
        if device is None and self.mesh.mesh is not None:
            device = self.mesh.mesh.device
        self.device = resolve_device(device)
        self._shard_rule = shard_leading_axis(cfg.n_var)
        self.var_range = self.mesh.var_range(cfg.n_var)
        # on CUDA the epochs replay captured step graphs; graphs=False runs
        # the eager step loop, the reference the graphs are held against
        self.graphs = bool(graphs)
        self._graphs = {}
        # by epoch kind, of the last graph released: its capture time (ms)
        # and replays
        self.graph_stats = {}
        self.cfg = cfg
        self.learning_rate = float(learning_rate)
        self.adam_eps = float(adam_eps)
        self.batch_size = int(batch_size)
        self.n_train = int(n_train)
        self.steps_per_epoch = math.ceil(self.n_train / self.batch_size)
        # datasets larger than `stream_bytes` stay on the host and are fed
        # ~stream_chunk_bytes of batches at a time (`fit`)
        self.stream_bytes = int(stream_bytes)
        self.stream_chunk_bytes = int(stream_chunk_bytes)
        self.adam_impl = adam_impl or os.environ.get('PGMVAE_ADAM_IMPL',
                                                     'optax')
        if self.adam_impl not in ADAM_IMPLS:
            raise ValueError(f'unknown adam_impl {self.adam_impl!r}; '
                             f'choose from {ADAM_IMPLS}')
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f'unknown compute_dtype {cfg.compute_dtype!r}; '
                             f'choose from {tuple(COMPUTE_DTYPES)}')

    # ------------------------------------------------------------ state --
    def init_state(self, generator: Union[int, torch.Generator]
                   ) -> TrainState:
        """Random weights from `generator` (or an int seed, drawn on the
        CPU, so a seed gives the same weights on every device). Under a
        mesh the global model is drawn on the host and each leaf keeps the
        rank's shard; the moments and EMA state start from the shards."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        sharded = self.mesh.mesh is not None
        params, codebook = vqvae.init_model(
            generator, self.cfg, 'cpu' if sharded else self.device)
        if sharded:
            params = vqvae.map_params(self._shard, params)
            codebook = None if codebook is None else self._shard(codebook)
        ema = None
        if self.cfg.quantizer == 'ema':
            ema = q.ema_init(codebook, self.cfg.zero_debias)
        elif self.cfg.quantizer == 'vq':
            params['codebook'] = codebook
        opt_state = fused_adam.adam_init(
            params, self.learning_rate, self.adam_eps,
            moment_dtype=(torch.bfloat16 if self.adam_impl == 'fused_bf16'
                          else torch.float32))
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(params, ema, opt_state, step)

    def _shard(self, leaf: torch.Tensor) -> torch.Tensor:
        """The rank's shard of a leaf by the sharding rule, on the device."""
        if self.mesh.mesh is not None and self._shard_rule(leaf):
            lo, hi = self.var_range
            leaf = leaf[lo:hi]
        return leaf.to(self.device).contiguous()

    def shard_state(self, state: TrainState) -> TrainState:
        """Every leaf whose leading dimension is n_var cut to the rank's
        networks (the JAX package's placement by `shard_leading_axis`),
        the rest kept whole, on the device; the state itself without a
        mesh."""
        if self.mesh.mesh is None:
            return state
        return _map_state(self._shard, state)

    def unshard_state(self, state: TrainState) -> TrainState:
        """The global state of a sharded one, on every rank: each stacked
        leaf gathered over 'model' (every rank must call it)."""
        if self.mesh.mesh is None:
            return state
        m, n = self.mesh.shape[1], self.cfg.n_var

        def gather(leaf):
            if leaf.dim() >= 1 and leaf.shape[0] * m == n:
                return self.mesh.all_gather(leaf, 'model')
            return leaf
        return _map_state(gather, state)

    def codebook(self, state: TrainState):
        if self.cfg.quantizer == 'vq':
            return state.params['codebook']
        if self.cfg.quantizer == 'ema':
            return state.ema.codebook
        return None

    # ------------------------------------------------------------- step --
    def _loss(self, params, state: TrainState, y, w, seeds=None,
              shard: Optional[q.Shard] = None):
        """(total loss, the forward's outputs, mse, mae): the mse and mae
        of the decoder's logits against the float32 y from one
        `cuda_recon.recon_loss` (the kernel pair on CUDA)."""
        cfg = self.cfg
        cdt = COMPUTE_DTYPES[cfg.compute_dtype]
        p, yc = params, y
        codebook = (params['codebook'] if cfg.quantizer == 'vq'
                    else self.codebook(state))
        if cdt is not None:
            # inside the graph: the cast's backward returns float32 grads
            p = vqvae.map_params(lambda leaf: leaf.to(cdt), params)
            yc = y.to(cdt)
            if cfg.quantizer == 'vq':
                codebook = p['codebook']
            elif codebook is not None:
                codebook = codebook.to(cdt)
        out = vqvae.apply_model_logits(p, codebook, yc, cfg, weights=w,
                                       seeds=seeds, shard=shard)
        mse, mae = cuda_recon.recon_loss(
            out.logits, y, w, seeds, 0 if shard is None else shard.lo,
            cfg.active_vars, None if shard is None else shard.wsum)
        if cfg.quantizer == 'vq':
            aux = out.q_loss + cfg.cost * out.e_loss
        else:  # 'ema' and 'naive': commitment term only
            aux = cfg.cost * out.e_loss
        total = mse + aux
        # under a mesh the penalty of a rank's networks counts once, on
        # data rank 0, so that the 'data' all-reduce of the gradients
        # gives its gradient once
        if cfg.l2_reg > 0 and self.mesh.data_rank == 0:
            total = total + cfg.l2_reg * vqvae.l2_penalty(params, seeds)
        return total, out, mse, mae

    def _step(self, state: TrainState, y: torch.Tensor, w: torch.Tensor,
              generators=None, seeds: Optional[int] = None):
        """One step of an unpacked state, or with `seeds` of a packed state
        in its step layout (`_step_layout`); returns (state, metrics [4] or
        [S, 4]). `generators` (one a seed) draw the dead-code restarts.
        Under a mesh y and w are the global batch (see the module doc)."""
        cfg, mesh = self.cfg, self.mesh
        shard, w_all = None, w
        if mesh.mesh is not None:
            shard = q.Shard(self.var_range[0], cfg.n_var, torch.sum(w))
            w_all = mesh.padded_rows(w)
            y, w = mesh.local_rows(y), mesh.local_rows(w)
        leaves = vqvae.param_leaves(state.params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, out, mse, mae = self._loss(
                vqvae.params_from_leaves(state.params, live), state, y, w,
                seeds, shard)
            # packed: the sum of the seeds' losses, each seed's gradient
            grads = torch.autograd.grad(
                loss if seeds is None else torch.sum(loss), live)
        grads = [g.contiguous() for g in grads]
        if shard is not None:   # each network's gradient over the batch
            grads = [g.contiguous()
                     for g in mesh.all_reduce_many(grads, 'data')]
        grads = vqvae.params_from_leaves(state.params, grads)
        opt_state = fused_adam.adam_update(state.params, grads,
                                           state.opt_state)

        with torch.no_grad():
            # EMA statistics in float32 whatever the compute dtype
            z = out.z.detach().float()
            rows = z.shape[0]
            ema, counts = state.ema, None
            if cfg.quantizer == 'ema':
                ema, counts = ema_step(ema, z, out.indices, w, cfg, mesh)
                if cfg.dead_code_threshold > 0 and generators is not None:
                    # the global draw, rows of the global batch
                    z_all = mesh.all_gather(z, 'data', dim=1)
                    lo, hi = self.var_range
                    ridx = torch.cat([
                        q.restart_rows(cfg.n_var, z_all.shape[1],
                                       cfg.num_codes, g, w_all,
                                       z.device)[lo:hi] for g in generators])
                    ema = q._apply_restart(ema, z_all, ridx,
                                           cfg.dead_code_threshold,
                                           cfg.decay, cfg.zero_debias)
            elif cfg.effective_codes <= PERPLEXITY_MAX_CODES:
                counts = torch.zeros((rows, cfg.effective_codes),
                                     dtype=y.dtype, device=y.device)
                counts.scatter_add_(1, out.indices.long(),
                                    w[None, :].expand(rows, -1))
                counts = mesh.all_reduce(counts, 'data')
            if counts is None:
                perplexity = torch.zeros(() if seeds is None else (seeds,),
                                         dtype=y.dtype, device=y.device)
            else:
                if seeds is not None:               # per seed
                    counts = counts.view(seeds, -1, counts.shape[-1])
                lo = 0 if shard is None else shard.lo   # padding out
                counts = counts[..., :max(cfg.active_vars - lo, 0), :]
                p = counts / torch.clamp(
                    torch.sum(counts, dim=-1, keepdim=True), min=1.0)
                ppl = torch.exp(-torch.sum(
                    p * torch.log(torch.clamp(p, min=1e-12)), dim=-1))
                if shard is not None:   # this rank's share of the mean
                    perplexity = torch.sum(ppl) / (
                        cfg.active_vars * mesh.shape[0])
                else:
                    perplexity = (torch.mean(ppl) if seeds is None
                                  else torch.mean(ppl, -1))
            metrics = torch.stack([loss.detach(), mse.detach(), mae,
                                   perplexity], dim=-1)
            metrics = mesh.all_reduce(metrics)
        return TrainState(state.params, ema, opt_state,
                          state.step + 1), metrics

    def train_step(self, state: TrainState, y: torch.Tensor,
                   w: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """One step on batch y [B, n_var] with sample weights w [B]; returns
        (state, metrics as device scalars [loss, mse, mae, perplexity]).
        Params and moments are updated in place. Dead-code restarts draw
        from `generator` when the config asks for them and it is given."""
        return self._step(state, y, w,
                          None if generator is None else [generator])

    @staticmethod
    def _step_layout(states: TrainState, seeds: int) -> TrainState:
        """A packed state as `_step` takes it: each [S, n, ...] leaf viewed
        as [S * n, ...], and the step counters (equal across seeds) and the
        learning rate as their first entry."""
        def flat(leaf):
            return leaf.flatten(0, 1)
        opt, ema = states.opt_state, states.ema
        if ema is not None:
            ema = q.EmaState(flat(ema.codebook), flat(ema.counts),
                             flat(ema.dw), ema.step[0])
        return TrainState(
            vqvae.map_params(flat, states.params), ema,
            opt._replace(count=opt.count[0], mu=vqvae.map_params(flat, opt.mu),
                         nu=vqvae.map_params(flat, opt.nu),
                         learning_rate=opt.learning_rate[0]),
            states.step[0])

    def train_step_packed(self, states: TrainState, y: torch.Tensor,
                          w: torch.Tensor,
                          generators: Optional[Sequence[torch.Generator]]
                          = None):
        """One step of S packed seeds on batches y [S, B, n_var] with the
        sample weights w [B] they share; returns (states, metrics [S, 4]).
        Params and moments are updated in place, through views."""
        seeds = y.shape[0]
        new, metrics = self._step(self._step_layout(states, seeds), y, w,
                                  generators, seeds)
        ema = states.ema
        if ema is not None:
            def unflat(t):
                return t.view(seeds, -1, *t.shape[1:])
            ema = q.EmaState(unflat(new.ema.codebook),
                             unflat(new.ema.counts), unflat(new.ema.dw),
                             ema.step + 1)
        opt = states.opt_state._replace(count=states.opt_state.count + 1)
        return TrainState(states.params, ema, opt, states.step + 1), metrics

    # ------------------------------------------------------------ epoch --
    def epoch_generator(self, seed: int, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            epoch_seed(seed, epoch))

    def _padded_perm(self, generator: torch.Generator) -> torch.Tensor:
        """The epoch's permutation with sentinels (-1) to whole batches,
        [steps, bs], on the device."""
        n, bs, steps = self.n_train, self.batch_size, self.steps_per_epoch
        perm = torch.randperm(n, generator=generator, device=self.device)
        pad = torch.full((steps * bs - n,), -1, dtype=perm.dtype,
                         device=self.device)
        return torch.cat([perm, pad]).view(steps, bs)

    def _use_graphs(self) -> bool:
        return (self.graphs and self.device.type == 'cuda'
                and self.mesh.captures)

    def release_graphs(self) -> None:
        """Release the captured step graphs and their memory pools (`fit`
        and `fit_packed` do so before they return)."""
        for kind in list(self._graphs):
            self._release_graph(kind)

    def _release_graph(self, kind: str) -> None:
        g = self._graphs.pop(kind)
        self.graph_stats[kind] = {'capture_ms': g.capture_ms,
                                  'replays': g.replays}
        g.release()

    def _epoch_graph(self, kind: str, key, perm: torch.Tensor, make_body,
                     n_generators: int,
                     chunk_shape: Optional[tuple] = None
                     ) -> graphs.StepGraph:
        """The step graph of `kind` whose body reads what `key` names (the
        addresses and shapes of the state, data and S), its epoch buffers
        reset for `perm`: the cached one, or a new one (after releasing the
        old) when the caller passes another state or data. Without graphs
        a new eager one each call. `chunk_shape` adds a streamed epoch's
        chunk buffer and its counter."""
        capture = self._use_graphs()
        cached = self._graphs.get(kind)
        if cached is None or cached.key != key or not capture:
            if cached is not None:
                self._release_graph(kind)

            def counter():
                return torch.zeros(1, dtype=torch.int64, device=self.device)
            ep = _EpochBuffers(
                perm=torch.empty_like(perm), i=counter(),
                total=torch.zeros(perm.shape[1:-1] + (4,),
                                  dtype=torch.float32, device=self.device),
                wtot=torch.zeros((), dtype=torch.float32,
                                 device=self.device))
            if chunk_shape is not None:
                ep = ep._replace(
                    chunk=torch.empty(chunk_shape, device=self.device,
                                      dtype=getattr(torch, self.cfg.dtype)),
                    j=counter())
            cached = graphs.StepGraph(make_body(ep), self.device,
                                      n_generators, capture, key, ep)
            if capture:
                self._graphs[kind] = cached
        ep = cached.buffers
        ep.perm.copy_(perm)
        ep.i.zero_()
        ep.total.zero_()
        ep.wtot.zero_()
        return cached

    def _advance(self, state: TrainState, yb: torch.Tensor, w: torch.Tensor,
                 generators, seeds: Optional[int], ep: _EpochBuffers):
        """The end of every epoch body: one train step of `state` (packed
        with `seeds`) on batch yb with weights w, the tensors it made anew
        copied into `state`'s, the step's metrics added into the epoch's
        sample-weighted sums, the step index advanced."""
        restart = list(generators) or None
        if seeds is None:
            new, m = self._step(state, yb, w, restart)
        else:
            new, m = self.train_step_packed(state, yb, w, restart)
        _map_state(_assign, state, new)
        wsum = torch.sum(w)
        ep.total.add_(m * wsum)
        ep.wtot.add_(wsum)
        ep.i.add_(1)

    def _run_epoch_core(self, kind: str, state: TrainState,
                        data: torch.Tensor, perm: torch.Tensor,
                        generators: Sequence[torch.Generator],
                        seeds: Optional[int]):
        """An in-core epoch (packed with `seeds`). Its body takes row i of
        the static permutation ([bs], or [S, bs] packed), gathers its batch
        from the device data and derives the weights from it (the
        sentinels end every permutation, so one w serves all seeds)."""
        restart = (list(generators) if self.cfg.dead_code_threshold > 0
                   else [])

        def make(ep):
            def body(gens):
                idx = ep.perm.index_select(0, ep.i)[0]
                w = ((idx if seeds is None else idx[0]) >= 0).to(data.dtype)
                yb = data.index_select(0, torch.clamp(idx.reshape(-1),
                                                      min=0))
                if seeds is not None:
                    yb = yb.view(seeds, self.batch_size, -1)
                self._advance(state, yb, w, gens, seeds, ep)
            return body
        key = (kind, _state_key(state), graphs.tensor_key(data), seeds)
        g = self._epoch_graph(kind, key, perm, make, len(restart))
        g.run(self.steps_per_epoch, restart)
        return state, g.buffers.total / g.buffers.wtot

    def run_epoch(self, state: TrainState, data: torch.Tensor,
                  generator: torch.Generator):
        """One epoch over the device-resident data [N, n_var]; returns
        (state, sample-weighted epoch metrics [4] on the device). The state
        is updated in place: the returned one holds the same tensors. On
        CUDA the step is a captured graph, replayed once a step. Host
        span: `train.epoch`, as for every epoch."""
        with span('train.epoch'):
            return self._run_epoch_core('epoch', state, data,
                                        self._padded_perm(generator),
                                        [generator], None)

    def run_epoch_packed(self, states: TrainState, data: torch.Tensor,
                         generators: Sequence[torch.Generator]):
        """One epoch of S packed seeds over the device-resident data, seed s
        drawing from generators[s]; returns (states, metrics [S, 4])."""
        with span('train.epoch'):
            perms = torch.stack([self._padded_perm(g) for g in generators],
                                1)
            return self._run_epoch_core('packed', states, data, perms,
                                        generators, len(generators))

    def run_epochs(self, state: TrainState, data: torch.Tensor, seed: int,
                   start_epoch: int, num_epochs: int):
        """Epochs start_epoch .. start_epoch + num_epochs - 1 over the
        device-resident data, epoch e with `epoch_generator(seed, e)` (as
        `fit`); returns (state, metrics [num_epochs, 4] on the device)."""
        ms = []
        for epoch in range(start_epoch, start_epoch + num_epochs):
            state, m = self.run_epoch(state, data,
                                      self.epoch_generator(seed, epoch))
            ms.append(m)
        return state, torch.stack(ms)

    def run_epochs_packed(self, states: TrainState, data: torch.Tensor,
                          seeds: Sequence[int], start_epoch: int,
                          num_epochs: int):
        """`run_epochs` for S packed seeds, seed s with the epoch generators
        of seeds[s]; returns (states, metrics [S, num_epochs, 4] on the
        device)."""
        ms = []
        for epoch in range(start_epoch, start_epoch + num_epochs):
            states, m = self.run_epoch_packed(
                states, data, [self.epoch_generator(s, epoch) for s in seeds])
            ms.append(m)
        return states, torch.stack(ms, 1)

    def _chunk_steps(self, data: np.ndarray) -> int:
        """Steps a streamed chunk holds: ~stream_chunk_bytes of batches."""
        return max(1, min(self.steps_per_epoch, self.stream_chunk_bytes
                          // (self.batch_size * data.shape[1]
                              * data.itemsize)))

    def _host_chunks(self, data: np.ndarray, perm: np.ndarray):
        """The batches of `perm` [steps, bs] (sentinels take row 0, as
        in-core) gathered on the host from `data`, `_chunk_steps` steps at
        a time, yielded on the device as [chunk, bs, n_var]. Each chunk is
        gathered into one of two pinned buffers and copied on a side
        stream (`data.pinned`): the next chunk's gather and copy go ahead
        of this chunk's steps, the steps wait for their copy by an event,
        and a buffer is refilled only once its last copy is done."""
        steps, bs = perm.shape
        chunk = self._chunk_steps(data)

        def gather(c, buf):
            idx = perm[c * chunk:(c + 1) * chunk]
            host = buf[:idx.shape[0]]
            np.take(data, idx, axis=0, out=host.numpy(), mode='clip')
            return host
        return pinned_pieces(-(-steps // chunk), (chunk, bs, data.shape[1]),
                             getattr(torch, self.cfg.dtype), self.device,
                             gather)

    def _run_epoch_streamed(self, state: TrainState, data: np.ndarray,
                            generator: torch.Generator):
        """`run_epoch` over host data: the same permutation, weights, steps
        and restart draws; each chunk of `_host_chunks` is copied into a
        static device chunk buffer, and the body takes row j of it (a
        second counter, reset every chunk), so that one graph serves every
        chunk, the ragged last one included."""
        with span('train.epoch'):
            perm = self._padded_perm(generator)
            restart = ([generator] if self.cfg.dead_code_threshold > 0
                       else [])
            shape = (self._chunk_steps(data), self.batch_size,
                     data.shape[1])
            key = ('chunk', _state_key(state), shape)

            def make(ep):
                def body(gens):
                    idx = ep.perm.index_select(0, ep.i)[0]
                    w = (idx >= 0).to(ep.chunk.dtype)
                    yb = ep.chunk.index_select(0, ep.j)[0]
                    ep.j.add_(1)
                    self._advance(state, yb, w, gens, None, ep)
                return body
            g = self._epoch_graph('chunk', key, perm, make, len(restart),
                                  shape)
            ep = g.buffers
            for dev in self._host_chunks(data, perm.cpu().numpy()):
                ep.chunk[:dev.shape[0]].copy_(dev)
                ep.j.zero_()
                g.run(dev.shape[0], restart)
            return state, ep.total / ep.wtot

    # -------------------------------------------------------------- fit --
    def _padded_data(self, data_host) -> np.ndarray:
        data_host = np.asarray(data_host)
        if data_host.shape[1] < self.cfg.n_var:    # padded variable axis:
            data_host = np.pad(                    # append zero columns
                data_host,
                ((0, 0), (0, self.cfg.n_var - data_host.shape[1])))
        return data_host

    def fit(self, state: TrainState, data_host: np.ndarray, epochs: int,
            seed: int, verbose: bool = False, log_fn=None,
            start_epoch: int = 0):
        """Train for `epochs` epochs (indices start_epoch ..); returns
        (state, list of EpochMetrics of floats). Epoch e uses the generator
        `epoch_generator(seed, e)`. The data is read from the device once
        per epoch when `verbose` or `log_fn` asks for it, else once (as
        `run_epochs` reads it). Data past `stream_bytes` is streamed from
        the host. The step graphs are released before it returns."""
        if epochs <= 0:
            return state, []
        data_host = self._padded_data(data_host)
        streamed = data_host.nbytes > self.stream_bytes
        if streamed:
            data = np.ascontiguousarray(data_host, dtype=self.cfg.dtype)
            run = self._run_epoch_streamed
        else:
            data = torch.as_tensor(data_host,
                                   dtype=getattr(torch, self.cfg.dtype),
                                   device=self.device)
            run = self.run_epoch
        logged = verbose or log_fn is not None
        try:
            history, pending = [], []
            for epoch in range(start_epoch, start_epoch + epochs):
                state, m = run(state, data, self.epoch_generator(seed, epoch))
                if not logged:
                    pending.append(m)
                    continue
                m_host = EpochMetrics(*m.tolist())
                history.append(m_host)
                if verbose:
                    print(f'epoch {epoch + 1}/{start_epoch + epochs}'
                          f'{" (streamed)" if streamed else ""} '
                          f'loss={m_host.loss:.6f} mse={m_host.mse:.6f} '
                          f'mae={m_host.mae:.6f} ppl={m_host.perplexity:.1f}')
                if log_fn is not None:
                    log_fn(epoch, m_host)
            if pending:
                history = [EpochMetrics(*row)
                           for row in torch.stack(pending).tolist()]
            return state, history
        finally:
            self.release_graphs()

    # --------------------------------------------------- packed seeds --
    def init_states_packed(self, seeds: Sequence[Union[int,
                                                       torch.Generator]]
                           ) -> TrainState:
        """S states, one per int seed or generator of `seeds` (as
        `init_state`), stacked leaf by leaf: every tensor gains a leading
        seed axis. Packed runs are single-device: a mesh is refused."""
        if self.mesh.mesh is not None:
            raise ValueError('packed-seed training does not compose with a '
                             'device mesh; run packed cells single-device')
        return _map_state(lambda *leaves: torch.stack(leaves),
                          *(self.init_state(s) for s in seeds))

    def fit_packed(self, states: TrainState, data_host: np.ndarray,
                   epochs: int, seeds: Sequence[int], start_epoch: int = 0):
        """Train S packed seeds for `epochs` epochs, seed s with the epoch
        generators of seeds[s] (as `fit`, so start_epoch composes); returns
        (states, EpochMetrics of [S, epochs] numpy arrays), read once
        (`run_epochs_packed`). The data is placed on the device: packed
        runs do not stream. The step graphs are released before it
        returns."""
        if epochs <= 0:
            return states, None
        data = torch.as_tensor(self._padded_data(data_host),
                               dtype=getattr(torch, self.cfg.dtype),
                               device=self.device)
        try:
            states, ms = self.run_epochs_packed(states, data, seeds,
                                                start_epoch, epochs)
        finally:
            self.release_graphs()
        ms = ms.cpu().numpy()                            # [S, epochs, 4]
        return states, EpochMetrics(*np.moveaxis(ms, -1, 0))

    @staticmethod
    def unpack_seed(states: TrainState, s: int) -> TrainState:
        """Seed s's state out of a packed one, in new tensors (later packed
        steps leave it alone)."""
        return _map_state(lambda leaf: leaf[s].clone(), states)

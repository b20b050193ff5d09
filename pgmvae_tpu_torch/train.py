"""Stage-1 training engine (the port of `pgmvae_tpu/train.py`).

The dataset is placed on the device once. An epoch draws a permutation,
pads it with sentinel rows (-1) to whole batches, and runs one train step
per batch: the ragged last batch carries 0/1 sample weights through every
mean and statistic, so its padded rows are exact no-ops. Each step is one
forward and backward pass, then the Adam update in place through the CUDA
kernel of `ops/fused_adam.py`, then the EMA codebook update. Metrics stay on
the device and are read once per epoch when the caller logs them, else once
per `fit`. adam_impl 'fused_bf16' keeps the Adam moments in bfloat16.

Loss: mse over each network's leave-one-out reconstruction, plus
cost*e_loss (plus q_loss for the 'vq' quantizer), plus l2_reg*l2_penalty.
Adam uses eps=1e-7 (the Keras default).

Randomness: epoch e draws its permutation and its dead-code restart rows
from a generator seeded from (seed, e) alone, so fit(a) followed by
fit(b, start_epoch=a) is bit-identical to fit(a + b).

Train steps update the state's params and moments in place; `copy_state`
takes a snapshot that later steps leave alone.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.ops import fused_adam
from pgmvae_tpu_torch.ops import quantizer as q

# Largest code space for which the per-step usage histogram is computed;
# beyond it (naive quantizer, dim > 16) perplexity is reported as 0.
PERPLEXITY_MAX_CODES = 1 << 16

# adam_impl values: the JAX package's 'optax', 'fused' and 'pallas' compute
# one function (tests/test_fused_adam.py), so all three take the kernel; the
# identifier still records the choice. 'fused_bf16' keeps the moments in
# bfloat16 and takes the kernel's bfloat16 variant.
ADAM_IMPLS = ('optax', 'fused', 'pallas', 'fused_bf16')


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


def _masked_recon_mean(x, w, mask, n_active=None):
    """Mean over a [n, B, n] tensor with per-sample weights w [B] and the
    leave-one-out mask [n, 1, n]: denominator n*(n-1)*sum(w), the mean over
    the reference's gathered [n, B, n-1] views."""
    n = n_active if n_active is not None else x.shape[0]
    return torch.sum(x * mask * w[None, :, None]) / (
        n * (n - 1) * torch.clamp(torch.sum(w), min=1.0))


def copy_state(state: TrainState) -> TrainState:
    """A deep copy of every tensor of `state`."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return vqvae.map_params(torch.clone, x)
        if isinstance(x, tuple) and hasattr(x, '_fields'):
            return type(x)(*(copy(f) for f in x))
        return x
    return copy(state)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s generator: a function of (seed, epoch)
    alone."""
    mixed = np.random.SeedSequence([seed & (2 ** 64 - 1), epoch])
    return int(mixed.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """Trains one model configuration on `device` (None means CUDA)."""

    # datasets larger than this are streamed from the host in the JAX
    # package; the port places every dataset on the device
    stream_bytes = 4 << 30

    def __init__(self, cfg: vqvae.VqVaeConfig, learning_rate: float,
                 batch_size: int, n_train: int, adam_eps: float = 1e-7,
                 adam_impl: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.learning_rate = float(learning_rate)
        self.adam_eps = float(adam_eps)
        self.batch_size = int(batch_size)
        self.n_train = int(n_train)
        self.steps_per_epoch = math.ceil(self.n_train / self.batch_size)
        self.adam_impl = adam_impl or os.environ.get('PGMVAE_ADAM_IMPL',
                                                     'optax')
        if self.adam_impl not in ADAM_IMPLS:
            raise ValueError(f'unknown adam_impl {self.adam_impl!r}; '
                             f'choose from {ADAM_IMPLS}')
        if cfg.compute_dtype != 'f32':
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r} is not ported yet: "
                f"ROADMAP.md A4, bf16 compute")

    # ------------------------------------------------------------ state --
    def init_state(self, generator: Union[int, torch.Generator]
                   ) -> TrainState:
        """Random weights from `generator` (or an int seed, drawn on the
        CPU, so a seed gives the same weights on every device)."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        params, codebook = vqvae.init_model(generator, self.cfg, self.device)
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

    def codebook(self, state: TrainState):
        if self.cfg.quantizer == 'vq':
            return state.params['codebook']
        if self.cfg.quantizer == 'ema':
            return state.ema.codebook
        return None

    # ------------------------------------------------------------- step --
    def _loss(self, params, state: TrainState, y, w, mask):
        cfg = self.cfg
        codebook = (params['codebook'] if cfg.quantizer == 'vq'
                    else self.codebook(state))
        out = vqvae.apply_model(params, codebook, y, cfg, weights=w)
        mse = _masked_recon_mean((out.recon - y[None]) ** 2, w, mask,
                                 cfg.active_vars)
        if cfg.quantizer == 'vq':
            aux = out.q_loss + cfg.cost * out.e_loss
        else:  # 'ema' and 'naive': commitment term only
            aux = cfg.cost * out.e_loss
        total = mse + aux
        if cfg.l2_reg > 0:
            total = total + cfg.l2_reg * vqvae.l2_penalty(params)
        return total, out, mse

    def train_step(self, state: TrainState, y: torch.Tensor,
                   w: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """One step on batch y [B, n_var] with sample weights w [B]; returns
        (state, metrics as device scalars [loss, mse, mae, perplexity]).
        Params and moments are updated in place. Dead-code restarts draw
        from `generator` when the config asks for them and it is given."""
        cfg = self.cfg
        mask = vqvae.loo_mask(cfg.n_var, None, y.dtype,
                              n_active=cfg.active_vars, device=y.device)
        leaves = vqvae.param_leaves(state.params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, out, mse = self._loss(
                vqvae.params_from_leaves(state.params, live), state, y, w,
                mask)
            grads = torch.autograd.grad(loss, live)
        grads = vqvae.params_from_leaves(
            state.params, [g.contiguous() for g in grads])
        opt_state = fused_adam.adam_update(state.params, grads,
                                           state.opt_state)

        with torch.no_grad():
            z = out.z.detach()
            ema, counts = state.ema, None
            if cfg.quantizer == 'ema':
                counts, dw = q.code_stats(z, out.indices, cfg.num_codes,
                                          weights=w)
                ema = q.ema_update(ema, counts, dw, cfg.decay, cfg.epsilon,
                                   cfg.zero_debias)
                if cfg.dead_code_threshold > 0 and generator is not None:
                    ema = q.restart_dead_codes(
                        ema, z, generator, cfg.dead_code_threshold,
                        cfg.decay, cfg.zero_debias, weights=w)
            elif cfg.effective_codes <= PERPLEXITY_MAX_CODES:
                counts = torch.zeros((cfg.n_var, cfg.effective_codes),
                                     dtype=y.dtype, device=y.device)
                counts.scatter_add_(1, out.indices.long(),
                                    w[None, :].expand(cfg.n_var, -1))
            recon = out.recon.detach()
            mae = _masked_recon_mean(torch.abs(recon - y[None]), w, mask,
                                     cfg.active_vars)
            if counts is None:
                perplexity = torch.zeros((), dtype=y.dtype, device=y.device)
            else:
                counts = counts[:cfg.active_vars]  # padding networks out
                p = counts / torch.clamp(
                    torch.sum(counts, dim=1, keepdim=True), min=1.0)
                perplexity = torch.mean(torch.exp(-torch.sum(
                    p * torch.log(torch.clamp(p, min=1e-12)), dim=1)))
            metrics = torch.stack([loss.detach(), mse.detach(), mae,
                                   perplexity])
        return TrainState(state.params, ema, opt_state,
                          state.step + 1), metrics

    # ------------------------------------------------------------ epoch --
    def epoch_generator(self, seed: int, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            epoch_seed(seed, epoch))

    def run_epoch(self, state: TrainState, data: torch.Tensor,
                  generator: torch.Generator):
        """One epoch over the device-resident data [N, n_var]; returns
        (state, sample-weighted epoch metrics [4] on the device)."""
        n, bs, steps = self.n_train, self.batch_size, self.steps_per_epoch
        perm = torch.randperm(n, generator=generator, device=self.device)
        pad = torch.full((steps * bs - n,), -1, dtype=perm.dtype,
                         device=self.device)
        perm = torch.cat([perm, pad]).view(steps, bs)
        restart = generator if self.cfg.dead_code_threshold > 0 else None
        total = torch.zeros(4, dtype=data.dtype, device=self.device)
        wtot = torch.zeros((), dtype=data.dtype, device=self.device)
        for idx in perm:
            w = (idx >= 0).to(data.dtype)
            yb = data.index_select(0, torch.clamp(idx, min=0))
            state, m = self.train_step(state, yb, w, restart)
            wsum = torch.sum(w)
            total += m * wsum
            wtot += wsum
        return state, total / wtot

    # -------------------------------------------------------------- fit --
    def fit(self, state: TrainState, data_host: np.ndarray, epochs: int,
            seed: int, verbose: bool = False, log_fn=None,
            start_epoch: int = 0):
        """Train for `epochs` epochs (indices start_epoch ..); returns
        (state, list of EpochMetrics of floats). Epoch e uses the generator
        `epoch_generator(seed, e)`. The data is read from the device once
        per epoch when `verbose` or `log_fn` asks for it, else once."""
        if epochs <= 0:
            return state, []
        data_host = np.asarray(data_host)
        if data_host.shape[1] < self.cfg.n_var:    # padded variable axis:
            data_host = np.pad(                    # append zero columns
                data_host,
                ((0, 0), (0, self.cfg.n_var - data_host.shape[1])))
        if data_host.nbytes > self.stream_bytes:
            raise NotImplementedError(
                f'a dataset of {data_host.nbytes} bytes needs streaming '
                f'epochs (past stream_bytes={self.stream_bytes}), which '
                f'are not ported yet: ROADMAP.md A5, streaming epochs')
        data = torch.as_tensor(data_host, dtype=getattr(torch,
                                                        self.cfg.dtype),
                               device=self.device)
        logged = verbose or log_fn is not None
        history, pending = [], []
        for epoch in range(start_epoch, start_epoch + epochs):
            state, m = self.run_epoch(state, data,
                                      self.epoch_generator(seed, epoch))
            if not logged:
                pending.append(m)
                continue
            m_host = EpochMetrics(*m.tolist())
            history.append(m_host)
            if verbose:
                print(f'epoch {epoch + 1}/{start_epoch + epochs} '
                      f'loss={m_host.loss:.6f} mse={m_host.mse:.6f} '
                      f'mae={m_host.mae:.6f} ppl={m_host.perplexity:.1f}')
            if log_fn is not None:
                log_fn(epoch, m_host)
        if pending:
            history = [EpochMetrics(*row)
                       for row in torch.stack(pending).tolist()]
        return state, history

    # ------------------------------------------------ not ported yet --
    def fit_packed(self, *args, **kwargs):
        raise NotImplementedError(
            "packed-seed training is not ported yet: ROADMAP.md A6, "
            "packed seeds")

    def init_states_packed(self, *args, **kwargs):
        raise NotImplementedError(
            "packed-seed training is not ported yet: ROADMAP.md A6, "
            "packed seeds")

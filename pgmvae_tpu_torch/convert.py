"""Weights and train states carried between the JAX package and the port.

Both sides keep one layout — `{'enc': [(w [n,i,o], b [n,1,o]), ...],
'dec': [...]}` (plus `'codebook'` when the 'vq' quantizer trains it) and a
codebook `[n, D, K]` (None for the naive quantizer) — so conversion is a
copy per leaf. The JAX side is handed over as numpy arrays (`np.asarray` of
each leaf, e.g. `jax.tree.map(np.asarray, state)`), which keeps this module
free of jax: its train state is read by attribute, as the named tuples
`TrainState(params, ema, opt_state, step)`, `EmaState` and optax's
`InjectHyperparamsState(count, hyperparams, inner_state=(ScaleByAdamState(
count, mu, nu), EmptyState()))`. bfloat16 leaves (the moments of adam_impl
'fused_bf16') cross as their 16-bit words: numpy has no bfloat16 of its own.
Packed states (`jax.vmap` of the JAX init, `Trainer.init_states_packed`)
convert leaf for leaf: every leaf carries the leading seed axis on both
sides, the Adam eps too on the JAX side (the port keeps one float).
"""

from __future__ import annotations

import numpy as np
import torch

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.models.vqvae import (VqVaeConfig, map_params,
                                            param_leaves, params_from_leaves)
from pgmvae_tpu_torch.ops.fused_adam import AdamState
from pgmvae_tpu_torch.ops.quantizer import EmaState
from pgmvae_tpu_torch.train import TrainState


def _tensor(x, device) -> torch.Tensor:
    """A numpy leaf of the JAX side as a tensor on `device` (a copy); a
    bfloat16 array through its 16-bit words."""
    x = np.asarray(x)
    if x.dtype.name == 'bfloat16':
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def _numpy(x: torch.Tensor, like=None) -> np.ndarray:
    """A tensor as numpy; a bfloat16 tensor as its 16-bit words viewed as
    the dtype of `like`, the JAX side's bfloat16 leaf."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.asarray(like).dtype)
    return x.numpy()


def params_from_jax(params, codebook, device=None):
    """(params, codebook) of numpy arrays in the JAX pytree layout ->
    the port's tensors on `device` (copies; float32 stays float32)."""
    device = resolve_device(device)

    def leaf(x):
        return _tensor(x, device)

    return (map_params(leaf, params),
            None if codebook is None else leaf(codebook))


def params_to_numpy(params, codebook):
    """Inverse of `params_from_jax`: the port's tensors -> numpy arrays in
    the JAX pytree layout."""
    def leaf(x):
        return x.detach().cpu().numpy()

    return (map_params(leaf, params),
            None if codebook is None else leaf(codebook))


def train_state_from_jax(state_np, cfg: VqVaeConfig, device=None
                         ) -> TrainState:
    """A JAX `TrainState` of numpy leaves (optax Adam state included) ->
    the port's `TrainState` on `device` (copies)."""
    device = resolve_device(device)
    if (state_np.ema is None) != (cfg.quantizer != 'ema') or (
            ('codebook' in state_np.params) != (cfg.quantizer == 'vq')):
        raise ValueError(f'train state does not fit quantizer '
                         f'{cfg.quantizer!r}')

    def leaf(x):
        return _tensor(x, device)

    ema = None
    if state_np.ema is not None:
        ema = EmaState(*(leaf(x) for x in state_np.ema))
    opt = state_np.opt_state
    adam = opt.inner_state[0]
    hp = opt.hyperparams
    opt_state = AdamState(
        count=leaf(np.asarray(adam.count, np.int32)),
        mu=map_params(leaf, adam.mu), nu=map_params(leaf, adam.nu),
        learning_rate=leaf(np.asarray(hp['learning_rate'], np.float32)),
        eps=float(np.asarray(hp['eps'], np.float32).reshape(-1)[0]))
    return TrainState(map_params(leaf, state_np.params), ema, opt_state,
                      leaf(np.asarray(state_np.step, np.int32)))


def train_state_to_numpy(state: TrainState, like):
    """Inverse of `train_state_from_jax`: the port's state as numpy leaves
    in the structure of `like`, a JAX train state of numpy leaves (its
    named tuples are filled with `_replace`)."""
    leaf = _numpy

    def moments(tree, like_tree):
        return params_from_leaves(tree, [
            _numpy(x, ref) for x, ref in zip(param_leaves(tree),
                                             param_leaves(like_tree))])

    ema = like.ema
    if state.ema is not None:
        ema = like.ema._replace(**{f: leaf(getattr(state.ema, f))
                                   for f in state.ema._fields})
    opt = state.opt_state
    adam, rest = like.opt_state.inner_state
    hp = dict(like.opt_state.hyperparams)
    hp['learning_rate'] = leaf(opt.learning_rate)
    eps = np.float32(opt.eps)
    hp['eps'] = eps if np.ndim(hp['eps']) == 0 else np.full(
        np.shape(hp['eps']), eps)
    count = leaf(opt.count)
    opt_np = like.opt_state._replace(
        count=count, hyperparams=hp,
        inner_state=(adam._replace(count=count, mu=moments(opt.mu, adam.mu),
                                   nu=moments(opt.nu, adam.nu)), rest))
    return like._replace(params=map_params(leaf, state.params), ema=ema,
                         opt_state=opt_np, step=leaf(state.step))

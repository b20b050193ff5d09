"""Weights and train states carried between the JAX package and the port.

Both sides keep one layout — `{'enc': [(w [n,i,o], b [n,1,o]), ...],
'dec': [...]}` (plus `'codebook'` when the 'vq' quantizer trains it) and a
codebook `[n, D, K]` (None for the naive quantizer) — so conversion is a
copy per leaf. The JAX side is handed over as numpy arrays (`np.asarray` of
each leaf, e.g. `jax.tree.map(np.asarray, state)`), which keeps this module
free of jax: its train state is read by attribute, as the named tuples
`TrainState(params, ema, opt_state, step)`, `EmaState` and optax's
`InjectHyperparamsState(count, hyperparams, inner_state=(ScaleByAdamState(
count, mu, nu), EmptyState()))`.
"""

from __future__ import annotations

import numpy as np
import torch

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.models.vqvae import VqVaeConfig, map_params
from pgmvae_tpu_torch.ops.fused_adam import AdamState
from pgmvae_tpu_torch.ops.quantizer import EmaState
from pgmvae_tpu_torch.train import TrainState


def params_from_jax(params, codebook, device=None):
    """(params, codebook) of numpy arrays in the JAX pytree layout ->
    the port's tensors on `device` (copies; float32 stays float32)."""
    device = resolve_device(device)

    def leaf(x):
        return torch.tensor(np.asarray(x), device=device)

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
        return torch.tensor(np.asarray(x), device=device)

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
        eps=float(np.float32(hp['eps'])))
    return TrainState(map_params(leaf, state_np.params), ema, opt_state,
                      leaf(np.asarray(state_np.step, np.int32)))


def train_state_to_numpy(state: TrainState, like):
    """Inverse of `train_state_from_jax`: the port's state as numpy leaves
    in the structure of `like`, a JAX train state of numpy leaves (its
    named tuples are filled with `_replace`)."""
    def leaf(x):
        return x.detach().cpu().numpy()

    ema = like.ema
    if state.ema is not None:
        ema = like.ema._replace(**{f: leaf(getattr(state.ema, f))
                                   for f in state.ema._fields})
    opt = state.opt_state
    adam, rest = like.opt_state.inner_state
    hp = dict(like.opt_state.hyperparams)
    hp['learning_rate'] = leaf(opt.learning_rate)
    hp['eps'] = np.float32(opt.eps)
    count = leaf(opt.count)
    opt_np = like.opt_state._replace(
        count=count, hyperparams=hp,
        inner_state=(adam._replace(count=count, mu=map_params(leaf, opt.mu),
                                   nu=map_params(leaf, opt.nu)), rest))
    return like._replace(params=map_params(leaf, state.params), ema=ema,
                         opt_state=opt_np, step=leaf(state.step))

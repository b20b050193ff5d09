"""What the benchmark takes from the program (`pgmvae_tpu_torch`, never the
JAX package): its model configuration type, and the copy of the
benchmark's weights into the program's state. The drivers import the
program's entry points themselves."""

from __future__ import annotations

import torch


def model_config(cfg: dict):
    """The program's VqVaeConfig for a configuration file."""
    from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
    return VqVaeConfig(
        n_var=cfg['n_var'], units=tuple(cfg['units']), dim=cfg['dim'],
        num_codes=cfg['num_codes'], cost=cfg['cost'], decay=cfg['decay'],
        quantizer=cfg['quantizer'], zero_debias=cfg['zero_debias'],
        epsilon=cfg['epsilon'],
        dead_code_threshold=cfg['dead_code_threshold'],
        fan_mode=cfg['fan_mode'], dtype=cfg['dtype'],
        activation=cfg['activation'], l2_reg=cfg['l2_reg'],
        first_layer=cfg['first_layer'], compute_dtype='f32')


def serving_params(weights: dict):
    """(params, codebook) in the program's layout, for stage 2, Gibbs and
    serving: the benchmark's own tensors."""
    return {'enc': weights['enc'], 'dec': weights['dec']}, weights['codebook']


@torch.no_grad()
def load_weights(state, weights: dict, seed_index=None) -> None:
    """Copy the benchmark's weights into a program TrainState's params and
    EMA codebook (seed `seed_index` of a packed state)."""
    def dst(t):
        return t if seed_index is None else t[seed_index]
    for stack in ('enc', 'dec'):
        for (pw, pb), (w, b) in zip(state.params[stack], weights[stack]):
            dst(pw).copy_(w)
            dst(pb).copy_(b)
    dst(state.ema.codebook).copy_(weights['codebook'])


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)

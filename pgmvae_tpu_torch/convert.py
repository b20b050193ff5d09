"""Weights carried between the JAX package and the port.

Both sides keep one layout — `{'enc': [(w [n,i,o], b [n,1,o]), ...],
'dec': [...]}` and a codebook `[n, D, K]` (None for the naive quantizer) —
so conversion is a copy per leaf. The JAX side is handed over as numpy
arrays (`np.asarray` of each leaf), which keeps this module free of jax.
"""

from __future__ import annotations

import numpy as np
import torch

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.models.vqvae import map_params


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

"""pgmvae_tpu_torch — the PyTorch/CUDA port of `pgmvae_tpu`.

The JAX package `pgmvae_tpu` stays the reference; this package computes the
same functions with the same public signatures and the same parameter layout
(plain dicts of stacked tensors, `{'enc': [(w [n,i,o], b [n,1,o]), ...],
'dec': [...]}` and a codebook `[n, D, K]`), so tests hold one against the
other on the same inputs.

This package imports torch and numpy only — never jax, flax, optax or the
JAX package. It keeps its own copies of the framework-free modules it needs.

Device rule: every entry point takes `device=None`, which means CUDA. Without
a card that raises; only an explicit `device='cpu'` runs on the CPU, where the
kernels' plain PyTorch versions stand in for the CUDA kernels.
"""

from __future__ import annotations

import torch

from pgmvae_tpu_torch.registry import (  # noqa: F401
    REGISTRY,
    DatasetInfo,
    default_units,
)

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA and raises without it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'pgmvae_tpu_torch runs on CUDA by default and no CUDA device '
                "is available; pass device='cpu' to run on the CPU")
        return torch.device('cuda')
    return torch.device(device)

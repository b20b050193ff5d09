"""Synthetic binary data at a registry dataset's shape, for machines without
the TRW CSVs: sparse columns driven by 16 shared latent Bernoulli factors
with 2% noise (the port's copy of `scripts/synth_kdd.py:30-39`).

`synth_rows` is the script's generator, which draws a loading of its own on
every call. `shared_factor_splits` draws one loading for the train, valid
and test splits together, so that what training learns, stage 2 sees on
the other splits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pgmvae_tpu_torch import registry

N_FACTORS = 16
LABEL = 'synthetic shared-factor, seed {seed}'


def _loading(n_var: int, rng) -> np.ndarray:
    return rng.random((N_FACTORS, n_var)) < 0.12          # factor -> vars


def _factor_rows(n_rows: int, loading: np.ndarray, rng) -> np.ndarray:
    z = rng.random((n_rows, N_FACTORS)) < 0.2             # active factors
    y = (z.astype(np.uint8) @ loading.astype(np.uint8)) > 0
    noise = rng.random((n_rows, loading.shape[1])) < 0.02
    return (y ^ noise).astype(np.uint8)


def synth_rows(n_rows: int, n_var: int, rng) -> np.ndarray:
    """Sparse correlated binary samples uint8 [n_rows, n_var] (kdd-like: low
    marginals with block structure): a handful of latent Bernoulli factors,
    each turning on a random subset of variables with noise."""
    return _factor_rows(n_rows, _loading(n_var, rng), rng)


def shared_factor_splits(name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """float32 train/valid/test splits at dataset `name`'s registry shape,
    from numpy seed `seed`, one loading for all three."""
    info = registry.REGISTRY[name]
    rng = np.random.default_rng(seed)
    loading = _loading(info.n_var, rng)
    return {split: _factor_rows(n, loading, rng).astype(np.float32)
            for split, n in (('train', info.n_train),
                             ('valid', info.n_valid),
                             ('test', info.n_test))}


def load_or_synthesize(name: str, root=None, seed: int = 0):
    """({'train', 'valid', 'test'} float32 splits, label) of dataset `name`:
    the TRW CSVs under `root` (else `registry.data_dir()`), labelled
    'trw:<dir>', when all three are there; else `shared_factor_splits`,
    labelled `LABEL`."""
    from pgmvae_tpu_torch.data.loader import load_split
    try:
        root = root or registry.data_dir()
        return ({split: load_split(name, split, root)
                 for split in ('train', 'valid', 'test')}, f'trw:{root}')
    except FileNotFoundError:
        return shared_factor_splits(name, seed), LABEL.format(seed=seed)

"""Dataset registry: the 24 TRW benchmark datasets with split sizes, the
published PLL baselines (Chou et al., "Automatic Parameter Tying: A New
Approach for Regularized Parameter Learning in Markov Networks", AAAI 2018),
and hand-tuned encoder widths where the reference recorded them.

The port's own copy of `pgmvae_tpu/registry.py` (the port never imports the
JAX package); the contents are identical, so both packages name the same
datasets and derive the same default widths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    n_var: int
    n_train: int
    n_valid: int
    n_test: int
    paper_pll: float  # magnitude of the published (negative) PLL
    units: Optional[Tuple[int, int, int, int]] = None  # tuned encoder widths

    def encoder_units(self, dim: int,
                      mesh_model: int = 1) -> Tuple[int, int, int, int]:
        """Tuned widths if recorded, else the default heuristic."""
        if self.units is not None:
            return self.units
        return default_units(self.n_var, dim, mesh_model=mesh_model)


def default_units(n_var: int, dim: int,
                  hbm_budget_bytes: float = 10e9,
                  mesh_model: int = 1) -> Tuple[int, int, int, int]:
    """Encoder width heuristic for datasets without hand-tuned widths: each
    layer a decreasing fraction of n_var, capped at 200, floored at the
    latent dim, with the JAX package's memory guard on the first/last
    stacked kernels (~80*n_var^2*u0 bytes of f32 training state)."""
    budget = hbm_budget_bytes * max(int(mesh_model), 1)
    mem_cap = max(int(budget / (80.0 * n_var * n_var)), 8)
    u0 = max(min(n_var // 2, 200, mem_cap), dim)
    u1 = max(min(n_var // 3, u0), dim)
    u2 = max(min(n_var // 5, u1), dim)
    u3 = max(min(n_var // 8, u2), dim)
    return (u0, u1, u2, u3)


def _d(name, n_var, n_train, n_valid, n_test, pll, units=None):
    return DatasetInfo(name, n_var, n_train, n_valid, n_test, pll,
                       tuple(units) if units else None)


REGISTRY = {
    info.name: info
    for info in [
        _d('nltcs', 16, 16181, 2157, 3236, 4.98, [15, 14, 13, 12]),
        _d('msnbc', 17, 291326, 38843, 58265, 6.08),
        _d('kdd', 64, 180092, 19907, 34955, 2.07, [50, 40, 30, 20]),
        _d('plants', 69, 17412, 2321, 3482, 10.21),
        _d('audio', 100, 15000, 2000, 3000, 37.03, [80, 60, 40, 30]),
        _d('jester', 100, 9000, 1000, 4116, 49.75, [70, 50, 40, 30]),
        _d('netflix', 100, 15000, 2000, 3000, 52.67, [80, 60, 40, 30]),
        _d('accidents', 111, 12758, 1700, 2551, 12.69, [90, 70, 50, 30]),
        _d('retail', 135, 22041, 2938, 4408, 10.39, [100, 70, 40, 20]),
        _d('pumsb_star', 163, 12262, 1635, 2452, 9.79, [120, 90, 60, 40]),
        _d('dna', 180, 1600, 400, 1186, 58.46),
        _d('kosarek', 190, 33375, 4450, 6675, 10.17, [140, 100, 50, 25]),
        _d('msweb', 294, 29441, 3270, 5000, 13.71),
        _d('book', 500, 8700, 1159, 1739, 35.20),
        _d('tmovie', 500, 4524, 1002, 591, 58.50),
        _d('webkb', 839, 2803, 558, 838, 155.51, [400, 200, 100, 50]),
        _d('reuters', 889, 6532, 1028, 1540, 88.55),
        _d('20ng', 910, 11293, 3764, 3764, 160.82),
        _d('bbc', 1058, 1670, 225, 330, 256.60),
        _d('ad', 1556, 2461, 327, 491, 6.01),
        _d('50-17-8', 289, 5000, 2000, 2000, 49.8696),
        _d('bn2o-30-20-200-2a', 50, 5000, 2000, 2000, 17.369),
        _d('fs-07', 1225, 5000, 2000, 2000, 60.0505),
        _d('students_03_02-0000', 376, 5000, 2000, 2000, 1.4775),
    ]
}


# the benchmark's read-only data mount, the JAX package's last candidate
REFERENCE_DATA_DIR = os.path.join(os.sep, 'root', 'reference', 'data', 'trw')


def data_dir() -> str:
    """Directory holding the TRW benchmark CSVs: $PGMVAE_DATA_DIR, else
    ./data/trw, else the read-only benchmark mount `REFERENCE_DATA_DIR`,
    in the JAX package's order."""
    for cand in (os.environ.get('PGMVAE_DATA_DIR'),
                 os.path.join(os.curdir, 'data', 'trw'),
                 REFERENCE_DATA_DIR):
        if cand and os.path.isdir(cand):
            return cand
    raise FileNotFoundError('no TRW data directory found; set PGMVAE_DATA_DIR')


def split_path(name: str, split: str, root: Optional[str] = None) -> str:
    if split not in ('train', 'valid', 'test'):
        raise ValueError(f'unknown split {split!r}')
    return os.path.join(root or data_dir(), f'{name}.{split}.data')

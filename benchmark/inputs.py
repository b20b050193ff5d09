"""The benchmark's inputs, made from the run's seed: the configuration and
traffic files, the data splits and the model weights. Both the program and
the plain reference are handed what this module makes.

The data generator is a frozen copy of `pgmvae_tpu_torch/data/synthetic.py`
(`shared_factor_splits`, itself `scripts/synth_kdd.py:30-39` with one
loading for the three splits): sparse binary columns driven by 16 shared
latent Bernoulli factors with 2% noise. The initial weights follow the
reference's Keras initializers as `pgmvae_tpu_torch/ops/initializers.py`
states them (he_uniform for the selu layers, glorot_uniform for the sigmoid
output, a VarianceScaling fan-in codebook, zero biases, fans by the
configuration's `fan_mode`), drawn on the device in one call.

This module imports nothing of the program.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_FACTORS = 16


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return read_json(ROOT / 'configs' / f'{name}.json')


def traffic(name: str) -> dict:
    return read_json(ROOT / 'traffic' / f'{name}.json')


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and `tags` (ints or
    strings): independent streams for the data, the weights and the draws."""
    words = [int(seed) & (2 ** 64 - 1)]
    for tag in tags:
        words.append(tag if isinstance(tag, int)
                     else int.from_bytes(str(tag).encode()[:8], 'little'))
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def shared_factor_splits(cfg: dict, seed: int) -> dict:
    """float32 train/valid/test splits [rows, n_var] at the configuration's
    split sizes, from numpy seed `sub_seed(seed, 'data')`, one loading for
    the three."""
    rng = np.random.default_rng(sub_seed(seed, 'data'))
    loading = rng.random((N_FACTORS, cfg['n_var'])) < 0.12
    out = {}
    for split in ('train', 'valid', 'test'):
        rows = cfg[f'n_{split}']
        z = rng.random((rows, N_FACTORS)) < 0.2
        y = (z.astype(np.uint8) @ loading.astype(np.uint8)) > 0
        noise = rng.random((rows, cfg['n_var'])) < 0.02
        out[split] = (y ^ noise).astype(np.float32)
    return out


def layer_dims(cfg: dict):
    """((in, out) of each encoder layer), ((in, out) of each decoder layer)
    in the padded masked design: the first input and the last output are
    n_var wide."""
    units = list(cfg['units'])
    enc = [cfg['n_var']] + units + [cfg['dim']]
    dec = [cfg['dim']] + units[::-1] + [cfg['n_var']]
    return (tuple(zip(enc[:-1], enc[1:])), tuple(zip(dec[:-1], dec[1:])))


def _limit(shape, scale: float, mode: str, fan_mode: str) -> float:
    """Half-width of Keras' VarianceScaling uniform for a stacked kernel:
    tf_stacked multiplies the leading axes into the fans, per_network does
    not."""
    receptive = (float(np.prod(shape[:-2])) if fan_mode == 'tf_stacked'
                 else 1.0)
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    fan = {'fan_in': fan_in, 'fan_avg': (fan_in + fan_out) / 2.0}[mode]
    return math.sqrt(3.0 * scale / max(1.0, fan))


def weights(cfg: dict, seed: int, device) -> dict:
    """{'enc': [(w [n,i,o], b [n,1,o]), ...], 'dec': [...], 'codebook'
    [n, D, K]} in float32 on `device`, from one uniform draw of a generator
    there seeded by `sub_seed(seed, 'weights')`."""
    n = cfg['n_var']
    enc_dims, dec_dims = layer_dims(cfg)
    specs = [((n, i, o), 2.0, 'fan_in') for i, o in enc_dims]
    specs += [((n, i, o), 2.0, 'fan_in') for i, o in dec_dims[:-1]]
    specs += [((n,) + tuple(dec_dims[-1]), 1.0, 'fan_avg')]
    specs += [((n, cfg['dim'], cfg['num_codes']), 1.0, 'fan_in')]
    total = sum(math.prod(s) for s, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              'weights'))
    u = torch.rand(total, generator=gen, device=device)
    leaves, at = [], 0
    for shape, scale, mode in specs:
        lim = _limit(shape, scale, mode, cfg['fan_mode'])
        size = math.prod(shape)
        leaves.append(u[at:at + size].view(shape).mul_(2.0 * lim).sub_(lim))
        at += size

    def layers(ws):
        return [(w, torch.zeros((n, 1, w.shape[-1]), device=device))
                for w in ws]
    n_enc = len(enc_dims)
    return {'enc': layers(leaves[:n_enc]),
            'dec': layers(leaves[n_enc:-1]),
            'codebook': leaves[-1]}

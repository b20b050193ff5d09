"""Weight initializers with the reference's *stacked* fan semantics (the
port of `pgmvae_tpu/ops/initializers.py`).

The reference stacks all `n_var` networks' kernels into one rank-3 weight
`[n_var, fan_in, fan_out]` and hands that shape to Keras `VarianceScaling`,
whose fans for rank>2 shapes multiply in `prod(shape[:-2])`: the stacked
kernel's effective fan_in is `n_var * fan_in`. `fan_mode='tf_stacked'`
reproduces that; `fan_mode='per_network'` uses the per-network fans.

Draws come from an explicit `torch.Generator`, on the generator's device,
and are then moved to `device`. The numbers differ from `jax.random`'s for
the same seed; only the distributions agree.
"""

from __future__ import annotations

import numpy as np
import torch


def _fans(shape, fan_mode: str):
    shape = tuple(int(s) for s in shape)
    if fan_mode == 'tf_stacked':
        # Keras VarianceScaling fan computation on the full stacked shape.
        if len(shape) < 1:
            return 1.0, 1.0
        if len(shape) == 1:
            return float(shape[0]), float(shape[0])
        if len(shape) == 2:
            return float(shape[0]), float(shape[1])
        receptive = float(np.prod(shape[:-2]))
        return shape[-2] * receptive, shape[-1] * receptive
    elif fan_mode == 'per_network':
        # Leading axes are stacking axes, not receptive field.
        return float(shape[-2]), float(shape[-1])
    raise ValueError(f'unknown fan_mode: {fan_mode}')


def variance_scaling_limit(shape, scale=1.0, mode='fan_in',
                           fan_mode='tf_stacked') -> float:
    """Half-width of the VarianceScaling uniform: sqrt(3*scale/fan)."""
    fan_in, fan_out = _fans(shape, fan_mode)
    if mode == 'fan_in':
        denom = max(1.0, fan_in)
    elif mode == 'fan_out':
        denom = max(1.0, fan_out)
    elif mode == 'fan_avg':
        denom = max(1.0, (fan_in + fan_out) / 2.0)
    else:
        raise ValueError(f'unknown mode: {mode}')
    return float(np.sqrt(3.0 * scale / denom))


def variance_scaling_uniform(generator: torch.Generator, shape, scale=1.0,
                             mode='fan_in', fan_mode='tf_stacked',
                             dtype=torch.float32, device=None):
    """Uniform on [-limit, limit), drawn on the generator's device and
    returned on `device` (the generator's device when None)."""
    limit = variance_scaling_limit(shape, scale, mode, fan_mode)
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    w = u * (2.0 * limit) - limit
    return w if device is None else w.to(device)


def he_uniform(generator, shape, fan_mode='tf_stacked', dtype=torch.float32,
               device=None):
    """Keras 'he_uniform': VarianceScaling(scale=2, fan_in, uniform)."""
    return variance_scaling_uniform(generator, shape, scale=2.0,
                                    mode='fan_in', fan_mode=fan_mode,
                                    dtype=dtype, device=device)


def glorot_uniform(generator, shape, fan_mode='tf_stacked',
                   dtype=torch.float32, device=None):
    """Keras 'glorot_uniform': VarianceScaling(scale=1, fan_avg, uniform)."""
    return variance_scaling_uniform(generator, shape, scale=1.0,
                                    mode='fan_avg', fan_mode=fan_mode,
                                    dtype=dtype, device=device)

"""The yardstick: the card's peaks, and the operations and bytes that each
measured operation needs, counted from its shapes. A later change that
replaces a kernel changes its time, not this work.

Copied from `pgmvae_tpu_torch/bench.py` (`train_flops_per_sample`, the peak
constants) and from the bound formulas under the kernel table of `PERF.md`
(`vq_argmin`, `adam`), with one correction: `bench.py` counts the
nearest-code contraction 2*D*K three times, as if it had a backward pass.
It has none (argmin carries no gradient, and the EMA codebook update is a
scatter), so it is counted once here.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense: float32 outside the tensor cores (TF32 is off),
# and HBM3 bandwidth
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# Adam in one pass over float32 state: read p, m, v, g; write p, m, v
ADAM_BYTES_PER_PARAM = 28


def dense_macs(cfg: dict) -> int:
    """Multiply-adds of one network's dense layers for one sample: encoder
    n_var -> units -> D and decoder D -> units -> n_var (the padded masked
    design: the first input and the last output are n_var wide)."""
    enc = [cfg['n_var'], *cfg['units'], cfg['dim']]
    dec = [cfg['dim'], *cfg['units'][::-1], cfg['n_var']]
    return (sum(a * b for a, b in zip(enc[:-1], enc[1:]))
            + sum(a * b for a, b in zip(dec[:-1], dec[1:])))


def encoder_macs(cfg: dict) -> int:
    enc = [cfg['n_var'], *cfg['units'], cfg['dim']]
    return sum(a * b for a, b in zip(enc[:-1], enc[1:]))


def distance_flops(cfg: dict) -> int:
    """The nearest-code contraction z . W for one (network, sample)."""
    return 2 * cfg['dim'] * cfg['num_codes']


def train_flops_per_sample(cfg: dict) -> float:
    """Model FLOPs of one trained sample: every network's dense layers
    forward and twice backward (input and weight gradients), plus the
    distance contraction once."""
    n = cfg['n_var']
    return n * (3.0 * 2 * dense_macs(cfg) + distance_flops(cfg))


def encode_flops_per_row(cfg: dict) -> float:
    """Model FLOPs of encoding one row through every network and finding
    its codes (serving, stage 2)."""
    n = cfg['n_var']
    return n * (2.0 * encoder_macs(cfg) + distance_flops(cfg))


def cmll_flops_per_step(cfg: dict, blocks: int, rows: int) -> float:
    """Model FLOPs of one Gibbs step: `blocks` selected networks encode and
    quantize `rows` chain states each."""
    return blocks * rows * (2.0 * encoder_macs(cfg) + distance_flops(cfg))


def vq_bound_s(n: int, b: int, d: int, k: int) -> float:
    """Least time of one nearest-code search over n networks, b rows, D and
    K: the operations of the contraction at the float32 peak, or reading z
    and W and writing the codes once at HBM bandwidth, whichever is
    longer."""
    flops = 2.0 * n * b * d * k
    nbytes = 4.0 * n * (b * d + d * k + b)
    return max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def adam_bound_s(params: int) -> float:
    """Least time of one Adam update over `params` float32 parameters."""
    return ADAM_BYTES_PER_PARAM * params / HBM_BYTES_PER_S


def n_params(cfg: dict) -> int:
    """Trainable parameters of one model (dense kernels and biases; the EMA
    codebook is not trained by Adam)."""
    enc = [cfg['n_var'], *cfg['units'], cfg['dim']]
    dec = [cfg['dim'], *cfg['units'][::-1], cfg['n_var']]
    per = sum(a * b + b for a, b in zip(enc[:-1], enc[1:]))
    per += sum(a * b + b for a, b in zip(dec[:-1], dec[1:]))
    return cfg['n_var'] * per

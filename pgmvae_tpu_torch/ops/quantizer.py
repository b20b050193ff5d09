"""Vector-quantization ops (the port of `pgmvae_tpu/ops/quantizer.py`):
the nearest-code search, the straight-through forward with its losses, the
EMA codebook statistics and update, dead-code restarts and the naive binary
quantizer.

Array conventions: z [n_var, B, D], codebook [n_var, D, K], indices
[n_var, B] int32, counts [n_var, K], dw [n_var, D, K]. Every function
returns new tensors; none writes into its inputs. Packed seeds stack S
models' networks on axis 0 (n = S * n_var); the losses then take `seeds=S`
and return one mean per seed, [S].

Under bf16 compute z and the codebook are bfloat16: the losses' squares
stay bfloat16 and the float32 sample weights promote their sums to float32,
and the EMA statistics are taken from z widened to float32.

Under a device mesh (`Shard`) a rank holds networks [lo, lo + n) of n_var
and some rows of the batch: the losses are its partial sums of the global
means (global row ids against n_active, the global n and sum of weights),
which the caller all-reduces.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pgmvae_tpu_torch.ops import cuda_vq


def vq_distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [n, B, K] = |z|^2 - 2 z.W + |W|^2."""
    z2 = torch.sum(z * z, dim=2, keepdim=True)                       # [n,B,1]
    w2 = torch.sum(codebook * codebook, dim=1, keepdim=True)         # [n,1,K]
    return z2 - 2.0 * torch.bmm(z, codebook) + w2


# The JAX package's switch point between its XLA path and its Pallas kernel:
# the f32 [n, B, K] distance tensor past which XLA runs out of TPU memory.
AUTO_PALLAS_BYTES = 4 << 30

IMPLS = ('auto', 'xla', 'pallas', 'pallas_interpret')


def auto_impl(n_var: int, batch: int, num_codes: int) -> str:
    """The JAX package's 'auto' rule: 'xla' while the f32 [n, B, K]
    distance tensor stays under AUTO_PALLAS_BYTES, 'pallas' beyond. The port
    reads `vq_impl` only for its validity: its one CUDA kernel never builds
    that tensor and plans its launch for each shape (`cuda_vq.plan`: many
    variables with few codes, or few with many), so it serves every shape
    and there is no library path to switch to."""
    nbytes = 4.0 * n_var * batch * num_codes
    return 'pallas' if nbytes > AUTO_PALLAS_BYTES else 'xla'


def vq_codes(z: torch.Tensor, codebook: torch.Tensor,
             impl: str = 'xla') -> torch.Tensor:
    """Nearest-codebook indices [n, B] int32 (ties -> lowest index, as
    `jnp.argmin`). Every `impl` goes to `cuda_vq.vq_codes_fused`: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors. The codes
    carry no gradient, so both operands are detached."""
    if impl not in IMPLS:
        raise ValueError(f'unknown vq impl {impl!r}; choose from {IMPLS}')
    return cuda_vq.vq_codes_fused(z.detach(), codebook.detach())


def vq_quantize(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather quantized latents [n, B, D] from per-variable codebooks."""
    d = codebook.shape[1]
    idx = indices.long()[:, :, None].expand(-1, -1, d)               # [n,B,D]
    return torch.gather(codebook.transpose(1, 2), 1, idx)


def naive_codes(z: torch.Tensor) -> torch.Tensor:
    """Code index = binary integer of the rounded latent bits, clipped to
    the D-cube corners {0,1} (the JAX package's fix of the reference's
    out-of-range codes)."""
    dim = z.shape[-1]
    power = 2 ** torch.arange(dim, dtype=torch.int32, device=z.device)
    bits = torch.clamp(torch.round(z), 0.0, 1.0).to(torch.int32)
    return torch.sum(bits * power, dim=-1, dtype=torch.int32)


class Shard(NamedTuple):
    """A mesh rank's part of a batched mean: its networks start at `lo` of
    `n_var`, and `wsum` is the sum of the GLOBAL batch's weights."""
    lo: int
    n_var: int
    wsum: torch.Tensor


def _masked_mean(x: torch.Tensor, weights: Optional[torch.Tensor],
                 n_active: Optional[int] = None,
                 seeds: Optional[int] = None,
                 shard: Optional[Shard] = None) -> torch.Tensor:
    """Mean over all elements of x [n, B, D], with optional per-sample
    weights on axis 1 (0 on the padded rows of a ragged batch). With a
    padded variable axis, `n_active` excludes networks >= n_active from both
    the sum and the denominator. With `seeds`, x holds S stacks of n/S
    networks and the result is each stack's mean, [S]. With `shard` (and
    weights), x holds networks shard.lo .. of shard.n_var and the result is
    this part's share of the global mean."""
    if seeds is not None:
        x = x.view(seeds, -1, *x.shape[1:])
    n = x.shape[-3] if shard is None else shard.n_var
    if n_active is not None and n_active < n:
        lo = 0 if shard is None else shard.lo
        row = torch.arange(lo, lo + x.shape[-3],
                           device=x.device).view(-1, 1, 1)
        x = x * (row < n_active).to(x.dtype)
        n = n_active

    def total(t):
        return torch.sum(t) if seeds is None else torch.sum(t, (1, 2, 3))
    if weights is None:
        return total(x) / (n * x.shape[-2] * x.shape[-1])
    wsum = torch.sum(weights) if shard is None else shard.wsum
    return total(x * weights[None, :, None]) / (n * x.shape[-1] * wsum)


class VqOut(NamedTuple):
    output: torch.Tensor    # [n, B, D] straight-through quantized latents
    indices: torch.Tensor   # [n, B] code assignments
    e_loss: torch.Tensor    # commitment loss (scalar)
    q_loss: torch.Tensor    # codebook loss (scalar; unused in EMA mode)


def vq_forward(z: torch.Tensor, codebook: torch.Tensor,
               weights: Optional[torch.Tensor] = None, impl: str = 'xla',
               n_active: Optional[int] = None,
               seeds: Optional[int] = None,
               shard: Optional[Shard] = None) -> VqOut:
    """Quantize with straight-through gradients and both latent losses:

    e_loss = mean((sg(q) - z)^2)   commitment
    q_loss = mean((q - sg(z))^2)   codebook
    output = z + sg(q - z)         straight-through estimator

    The codes come from `vq_codes` (the CUDA kernel on the card); the
    codebook's gradient flows through the gather of `vq_quantize`. With
    `seeds` the losses are per seed, [S]."""
    indices = vq_codes(z, codebook, impl=impl)
    quantized = vq_quantize(codebook, indices)
    e_loss = _masked_mean((quantized.detach() - z) ** 2, weights, n_active,
                          seeds, shard)
    q_loss = _masked_mean((quantized - z.detach()) ** 2, weights, n_active,
                          seeds, shard)
    output = z + (quantized - z).detach()
    return VqOut(output, indices, e_loss, q_loss)


def code_stats(z: torch.Tensor, indices: torch.Tensor, num_codes: int,
               weights: Optional[torch.Tensor] = None):
    """Per-variable assignment statistics for the EMA update:

    counts[v,k] = sum_b w_b * 1[indices[v,b]=k]
    dw[v,:,k]   = sum_b w_b * z[v,b,:] * 1[indices[v,b]=k]

    through a one-hot [n, B, K] and one `torch.bmm`."""
    onehot = torch.zeros(indices.shape + (num_codes,), dtype=z.dtype,
                         device=z.device)
    onehot.scatter_(2, indices.long()[:, :, None], 1.0)              # [n,B,K]
    if weights is not None:
        onehot = onehot * weights[None, :, None]
    counts = torch.sum(onehot, dim=1)                                # [n,K]
    dw = torch.bmm(z.transpose(1, 2), onehot)                        # [n,D,K]
    return counts, dw


class EmaState(NamedTuple):
    """EMA-codebook state. With `zero_debias=True` (TF's
    `assign_moving_average` default) `counts` and `dw` hold the biased
    shadow accumulators, zero at the start, and `step` drives the
    correction `1 - decay**step`; with `zero_debias=False` they hold the
    moving averages and `dw` starts from the codebook."""
    codebook: torch.Tensor   # [n, D, K]
    counts: torch.Tensor     # [n, K]
    dw: torch.Tensor         # [n, D, K]
    step: torch.Tensor       # int32 scalar


def ema_init(codebook: torch.Tensor, zero_debias: bool = True) -> EmaState:
    dw0 = torch.zeros_like(codebook) if zero_debias else codebook.clone()
    return EmaState(
        codebook=codebook,
        counts=torch.zeros((codebook.shape[0], codebook.shape[2]),
                           dtype=codebook.dtype, device=codebook.device),
        dw=dw0,
        step=torch.zeros((), dtype=torch.int32, device=codebook.device))


def _debias(decay: float, step: torch.Tensor, dtype) -> torch.Tensor:
    return 1.0 - torch.pow(decay, step.to(dtype))


def ema_update(state: EmaState, batch_counts: torch.Tensor,
               batch_dw: torch.Tensor, decay: float, epsilon: float = 1e-5,
               zero_debias: bool = True) -> EmaState:
    """One EMA codebook update from batch statistics: moving averages of
    counts and dw, Laplace smoothing of the cluster sizes, and
    codebook = dw / smoothed counts."""
    counts = state.counts * decay + batch_counts * (1.0 - decay)
    dw = state.dw * decay + batch_dw * (1.0 - decay)
    step = state.step + 1
    if zero_debias:
        bias = _debias(decay, step, state.codebook.dtype)
        ema_c, ema_w = counts / bias, dw / bias
    else:
        ema_c, ema_w = counts, dw
    k = state.codebook.shape[2]
    n = torch.sum(ema_c, dim=1, keepdim=True)                        # [n,1]
    smoothed = (ema_c + epsilon) / (n + k * epsilon) * n             # [n,K]
    codebook = ema_w / smoothed[:, None, :]
    return EmaState(codebook=codebook, counts=counts, dw=dw, step=step)


def restart_dead_codes(state: EmaState, z: torch.Tensor,
                       generator: torch.Generator, threshold: float,
                       decay: float, zero_debias: bool = True,
                       weights: Optional[torch.Tensor] = None) -> EmaState:
    """Reseed dead codebook entries from random batch latents: a code whose
    (debiased) EMA usage is below `threshold` moves to a latent of the
    batch, drawn for each (variable, code) uniformly over the rows with
    weight > 0, and its statistics restart at (count=1, dw=latent).

    The draw (`restart_rows`) uses `generator` (on z's device) and no host
    round trip; the update itself is `_apply_restart`, so tests can feed it
    the indices the JAX package drew."""
    n, b, _ = z.shape
    ridx = restart_rows(n, b, state.codebook.shape[2], generator, weights,
                        z.device)
    return _apply_restart(state, z, ridx, threshold, decay, zero_debias)


def restart_rows(n: int, b: int, k: int, generator: torch.Generator,
                 weights: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """The batch row [n, K] drawn for each (variable, code) of a restart:
    uniform over the b rows, or over the rows with weight > 0."""
    u = torch.rand((n, k), generator=generator, device=device)
    if weights is None:
        return torch.clamp((u * b).long(), max=b - 1)
    # the j-th valid row, j uniform on [0, #valid): searchsorted over the
    # running count of valid rows
    valid = torch.cumsum((weights > 0).to(torch.int64), 0)          # [B]
    j = torch.minimum((u * valid[-1]).long(), valid[-1] - 1)
    return torch.searchsorted(valid, j.reshape(-1), right=True).reshape(n, k)


def _apply_restart(state: EmaState, z: torch.Tensor, ridx: torch.Tensor,
                   threshold: float, decay: float,
                   zero_debias: bool = True) -> EmaState:
    """The deterministic half of `restart_dead_codes`: ridx [n, K] holds the
    batch row drawn for each (variable, code)."""
    if zero_debias:
        bias = _debias(decay, torch.clamp(state.step, min=1),
                       state.codebook.dtype)
    else:
        bias = torch.ones((), dtype=state.codebook.dtype, device=z.device)
    dead = state.counts / bias < threshold                           # [n,K]
    d = z.shape[2]
    idx = ridx.long()[:, :, None].expand(-1, -1, d)                  # [n,K,D]
    # [n,D,K], contiguous, so that the codebook taken from it stays
    # contiguous for the nearest-code kernel
    candidates = torch.gather(z, 1, idx).transpose(1, 2).contiguous()
    dead_dk = dead[:, None, :]
    codebook = torch.where(dead_dk, candidates, state.codebook)
    counts = torch.where(dead, bias * 1.0, state.counts)
    dw = torch.where(dead_dk, bias * candidates, state.dw)
    return EmaState(codebook=codebook, counts=counts, dw=dw, step=state.step)


class NaiveOut(NamedTuple):
    output: torch.Tensor
    e_loss: torch.Tensor


def naive_forward(z: torch.Tensor, weights: Optional[torch.Tensor] = None,
                  n_active: Optional[int] = None,
                  seeds: Optional[int] = None,
                  shard: Optional[Shard] = None) -> NaiveOut:
    """loss = mean(-(z-0.5)^2), which pushes latents to 0/1; the output is a
    hard 0/1 step through the reference's clamp trick."""
    e_loss = _masked_mean(-((z - 0.5) ** 2), weights, n_active, seeds, shard)
    output = torch.clamp(torch.clamp(z - 0.499999, min=0.0) * 1e7, max=1.0)
    return NaiveOut(output, e_loss)

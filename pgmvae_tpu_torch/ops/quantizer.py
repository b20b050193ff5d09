"""Vector-quantization ops, forward only (the port of the inference subset of
`pgmvae_tpu/ops/quantizer.py`).

Array conventions: z [n_var, B, D], codebook [n_var, D, K], indices
[n_var, B] int32.
"""

from __future__ import annotations

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
    that tensor, so it serves every shape."""
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

from pgmvae_tpu_torch.ops.quantizer import (  # noqa: F401
    vq_distances,
    vq_codes,
    vq_quantize,
    vq_forward,
    code_stats,
    EmaState,
    ema_init,
    ema_update,
    naive_forward,
    naive_codes,
)
from pgmvae_tpu_torch.ops.initializers import (  # noqa: F401
    he_uniform,
    glorot_uniform,
    variance_scaling_uniform,
)
# the kernel wrappers register with ops/kernels.py in this order
from pgmvae_tpu_torch.ops import (  # noqa: F401,E402
    cuda_vq, fused_adam, cuda_ema, cuda_recon, cuda_first_layer)

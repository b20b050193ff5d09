from pgmvae_tpu_torch.models.vqvae import (  # noqa: F401
    VqVaeConfig,
    init_model,
    apply_model,
    encode,
    encode_codes,
    gather_variables,
    ForwardOut,
)

from pgmvae_tpu_torch.models.vqvae import VqVaeConfig  # noqa: F401

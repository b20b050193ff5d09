from pgmvae_tpu_torch.data.loader import load_binary_csv, load_split  # noqa: F401

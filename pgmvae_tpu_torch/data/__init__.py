from pgmvae_tpu_torch.data.loader import (  # noqa: F401
    load_split,
    load_binary_csv,
    leave_one_out_index,
    leave_one_out,
)

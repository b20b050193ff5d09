"""Host-side utilities of the port."""

from pgmvae_tpu_torch.utils.logging import (  # noqa: F401
    MetricLogger,
    append_result,
)

from pgmvae_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    MeshContext,
    shard_leading_axis,
)

"""Multi-device helpers (PyTorch port of cova_tpu.parallel)."""

from cova_tpu_torch.parallel.mesh import (
    STREAM_AXIS,
    Mesh,
    make_mesh,
    replicate,
    run_ranks,
    shard_batch,
)

__all__ = ["STREAM_AXIS", "Mesh", "make_mesh", "replicate", "run_ranks", "shard_batch"]

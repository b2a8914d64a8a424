from visiondk_tpu_torch.parallel.mesh import (
    MeshContext,
    build_mesh,
    initialize_distributed,
    pad_to_multiple,
    shard_ranges,
)

__all__ = ["MeshContext", "build_mesh", "initialize_distributed", "pad_to_multiple", "shard_ranges"]

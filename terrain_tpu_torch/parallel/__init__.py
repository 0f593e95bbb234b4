"""Parallelism layer: the ('data', 'model') grid of ranks, its shardings,
process-group init (terrain_tpu/parallel)."""

from terrain_tpu_torch.parallel.distributed import (
    HostShardIterator,
    host_batch_slice,
    initialize,
)
from terrain_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    place,
    replicated,
    spatial_batch_sharding,
    tp_shardings,
)

__all__ = ["make_mesh", "batch_sharding", "spatial_batch_sharding",
           "replicated", "tp_shardings", "place",
           "initialize", "host_batch_slice", "HostShardIterator"]

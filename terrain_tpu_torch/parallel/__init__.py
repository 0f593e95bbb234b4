"""Parallelism layer: the ('data', 'model') grid of ranks, its shardings,
process-group init (terrain_tpu/parallel); parallel/tp.py holds the
collectives of tensor parallelism on 'model', parallel/spatial.py those
of spatial parallelism (image rows over 'model').  `__all__` holds
terrain_tpu.parallel's nine names and the four of the spatial layer."""

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
from terrain_tpu_torch.parallel.spatial import (
    gather_rows,
    halo_exchange,
    scatter_rows,
    shard_rows,
)

__all__ = ["make_mesh", "batch_sharding", "spatial_batch_sharding",
           "replicated", "tp_shardings", "place",
           "initialize", "host_batch_slice", "HostShardIterator",
           "shard_rows", "halo_exchange", "gather_rows", "scatter_rows"]

"""Online sampler service for two-stage terrain models, on the card.

`python -m terrain_tpu_torch.serve <experiment> [checkpoint]` starts a TCP
service with terrain_tpu's wire format; TerrainClient is the Python client.
"""

from terrain_tpu_torch.serve.batcher import MicroBatcher, bucket_size
from terrain_tpu_torch.serve.client import TerrainClient
from terrain_tpu_torch.serve.server import TerrainServer

__all__ = ["MicroBatcher", "TerrainClient", "TerrainServer", "bucket_size"]

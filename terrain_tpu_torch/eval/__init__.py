"""Evaluation layer: weight-free sample-quality metrics (SWD pyramid and
terrain-domain elevation/slope W1), terrain_tpu/eval's exports."""

from terrain_tpu_torch.eval.swd import (
    laplacian_pyramid, sliced_wasserstein, swd_pyramid)
from terrain_tpu_torch.eval.terrain import terrain_stats

__all__ = ["swd_pyramid", "sliced_wasserstein", "laplacian_pyramid",
           "terrain_stats"]

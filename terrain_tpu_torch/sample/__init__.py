"""Samplers: z -> heightmap, heightmap -> texture, and the two-stage
pipeline (terrain_tpu/sample)."""

from terrain_tpu_torch.sample.samplers import (
    TwoStagePipeline, make_atob_sampler, make_two_stage_sampler,
    make_z_sampler)

__all__ = ["TwoStagePipeline", "make_atob_sampler", "make_two_stage_sampler",
           "make_z_sampler"]

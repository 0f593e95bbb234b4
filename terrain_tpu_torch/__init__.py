"""PyTorch/CUDA port of terrain_tpu for one NVIDIA H100.

The JAX package `terrain_tpu` is the reference; this package mirrors its
module names where a reader looks for a counterpart and imports nothing of
it (nor JAX).

Conventions:
  * activations are NHWC tensors, exactly as in the JAX package and on the
    server's wire; plain convolutions view them as channels-last NCHW for
    `F.conv2d`, so no layout copy is made around them;
  * parameters are fp32; `compute_dtype` (bf16 under TERRAIN_DTYPE=bf16)
    is applied where the JAX code casts;
  * entry points run on `cuda` unless the caller passes device="cpu"; with
    no card and no such request they raise (terrain_tpu_torch.device);
  * the fp32 path needs TF32 off (`device.strict_fp32()`), which the entry
    points (training CLI, server CLI, chip_smoke.py) set -- importing sets
    nothing.
"""

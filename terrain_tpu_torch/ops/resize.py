"""Upsampling ops, NHWC (terrain_tpu/ops/resize.py:24-89).

Bilinear x2 is half-pixel with edge clamp:
    out[2j]   = 0.25*in[j-1] + 0.75*in[j]
    out[2j+1] = 0.75*in[j]   + 0.25*in[j+1]   (indices clamped at edges)
Like the JAX op it interpolates in fp32 and returns the input dtype.  Three
exact forms, chosen as terrain_tpu chooses, by switches read at call time:
  * TERRAIN_PALLAS=1, in the kernel's regime (fp32, H and W >= 128): the
    hand-written kernel, ops/kernels/bilinear.py;
  * TERRAIN_RESIZE=dense (and not the kernel): the separable form, two
    shifted views and an interleave per axis;
  * otherwise `F.interpolate(scale_factor=2, mode="bilinear",
    align_corners=False)`, the counterpart of `jax.image.resize`.
`upsample_bilinear_2x_lowp` interpolates in the input's own dtype, as
terrain_tpu's counterpart (resize.py:92-99), for the backward composites
of ops/kernels/bilinear_conv.py.
"""

import os

import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels import bilinear as _bl


def upsample_nearest_2x(x):
    """Repeat-upscale by 2 in H and W (lasagne Upscale2DLayer)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample_bilinear_2x(x):
    """Bilinear x2 with half-pixel centres and edge clamp, in fp32."""
    pallas = os.environ.get("TERRAIN_PALLAS") == "1"
    if pallas and _bl.supported(tuple(x.shape), x.dtype):
        return _bl.bilinear_2x(x)
    if not pallas and os.environ.get("TERRAIN_RESIZE", "xla") != "xla":
        return _bl.bilinear_2x_plain(x)
    xc = x.float().permute(0, 3, 1, 2)
    up = F.interpolate(xc, scale_factor=2, mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).to(x.dtype)


def upsample_bilinear_2x_lowp(x):
    """Bilinear x2 as `upsample_bilinear_2x`, computed in x.dtype."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)

"""Upsampling ops, NHWC (terrain_tpu/ops/resize.py:24-89).

Bilinear x2 is half-pixel with edge clamp:
    out[2j]   = 0.25*in[j-1] + 0.75*in[j]
    out[2j+1] = 0.75*in[j]   + 0.25*in[j+1]   (indices clamped at edges)
which is `F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)`.  Like the JAX op it interpolates in fp32 and returns
the input dtype.
"""

import torch.nn.functional as F


def upsample_nearest_2x(x):
    """Repeat-upscale by 2 in H and W (lasagne Upscale2DLayer)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample_bilinear_2x(x):
    """Bilinear x2 with half-pixel centres and edge clamp, in fp32."""
    xc = x.float().permute(0, 3, 1, 2)
    up = F.interpolate(xc, scale_factor=2, mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).to(x.dtype)

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
    align_corners=False)`, the counterpart of `jax.image.resize`, behind
    `Bilinear2xLib`: its backward is the separable adjoint
    (`interp_axis_t`, shifted adds), because `F.interpolate`'s own
    backward accumulates with atomics on the card and gives other bits
    from run to run (the JAX op gives the same bits every run).
`upsample_bilinear_2x_lowp` interpolates in the input's own dtype, as
terrain_tpu's counterpart (resize.py:92-99), for the backward composites
of ops/kernels/bilinear_conv.py, through the same function.

`upsample_nearest_2x` repeats by broadcasting: the backward of a broadcast
is a sum, where `repeat_interleave`'s is an index_add with atomics.
"""

import os

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from terrain_tpu_torch.ops.kernels import bilinear as _bl


def upsample_nearest_2x(x):
    """Repeat-upscale by 2 in H and W (lasagne Upscale2DLayer)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


class Bilinear2xLib(torch.autograd.Function):
    """`F.interpolate`'s bilinear x2 of x (N,H,W,C) in x.dtype, with the
    separable adjoint as its backward, computed in fp32 and cast to
    x.dtype: the same linear map's transpose, with no atomics."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear", align_corners=False)
        return up.permute(0, 2, 3, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _bl.interp_axis_t(_bl.interp_axis_t(g.float(), 2), 1).to(
            ctx.dtype)


def upsample_bilinear_2x(x):
    """Bilinear x2 with half-pixel centres and edge clamp, in fp32."""
    pallas = os.environ.get("TERRAIN_PALLAS") == "1"
    if pallas and _bl.supported(tuple(x.shape), x.dtype):
        return _bl.bilinear_2x(x)
    if not pallas and os.environ.get("TERRAIN_RESIZE", "xla") != "xla":
        return _bl.bilinear_2x_plain(x)
    return Bilinear2xLib.apply(x.float()).to(x.dtype)


def upsample_bilinear_2x_lowp(x):
    """Bilinear x2 as `upsample_bilinear_2x`, computed in x.dtype."""
    return Bilinear2xLib.apply(x)

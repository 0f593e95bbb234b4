"""Pooling ops on NHWC tensors (terrain_tpu/ops/pool.py:116-156), as the
DCGAN discriminator uses them: 2x2 max or average pooling between stages
and one average pool over the remaining extent.  No implicit padding
(windows that do not fit are dropped, XLA's VALID).

TERRAIN_POOL_VJP, read at call time as in terrain_tpu, selects the 2x2 s2
max pool's formulation: unset or 'sas' is the library pool (terrain_tpu's
default is XLA's reduce_window, whose gradient is select-and-scatter);
'pallas' sends shapes in the regime of ops/kernels/pool2.py to the
hand-written forward and backward kernels (a CUDA tensor launches them or
raises; a CPU tensor runs their plain versions; shapes off the regime take
the library pool).  'lanes' and 'dense' are terrain_tpu's measured-loss
formulations (terrain_tpu/ops/pool.py:45-113), XLA code there and so plain
tensor ops here, each an autograd Function with the same adjoint:
  * 'lanes', 2x2 windows: the forward pairs the columns in a contiguous
    (n, h, w/2, 2c) view and then the rows; the backward sends each
    cotangent to the row-major-first maximum, as select-and-scatter does;
  * 'dense', any size with stride == size: the backward splits each
    cotangent equally among the window's tied maxima, so on ties its
    gradient differs from the other formulations'.
As in terrain_tpu, each takes the pool only where x is floating, the
stride equals the size and H and W divide by it (pallas also needs
pool2's regime, lanes a 2x2 window); every other pool is the library's.

Ties.  select-and-scatter sends a window's cotangent to one element, the
first maximum in row-major order.  `F.max_pool2d` does the same: its
forward scans the window in row-major order and replaces the running
maximum only on a strictly greater value (or a NaN), and its backward adds
the cotangent at that recorded index.  tests/test_torch_train.py pins this
on deliberate ties.

On a slab of image rows (parallel/spatial.pool: a 2x2 pool of a slab of
an even number of rows holds whole windows and needs no halo) the
formulation is chosen on the whole image's shape (`route_shape`), so a
slab runs the pool2 kernels exactly where one process does; the pool2
kernels take any even height.  Ties go to the same element as on the
whole image: a window lies in one slab.
"""

import os

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from terrain_tpu_torch.ops.kernels import pool2 as _p2


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _lanes_core(x):
    """The 2x2 s2 max of x (N,H,W,C) by pairing its columns in the
    contiguous (n, h, w/2, 2c) view, then its rows; and the column
    pairs' maximum m."""
    n, h, w, c = x.shape
    xr = x.reshape(n, h, w // 2, 2 * c)
    m = torch.maximum(xr[..., :c], xr[..., c:])
    return torch.maximum(m[:, 0::2], m[:, 1::2]), m


class LanesPool(torch.autograd.Function):
    """TERRAIN_POOL_VJP=lanes (terrain_tpu/ops/pool.py:69-113): ties to
    the row-major-first maximum, the row pair before the column pair."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _lanes_core(x)[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        n, h, w, c = x.shape
        xr = x.reshape(n, h, w // 2, 2 * c)
        a, b = xr[..., :c], xr[..., c:]
        m = torch.maximum(a, b)
        hm = m[:, 0::2] >= m[:, 1::2]
        ge = g.to(x.dtype)
        zero = ge.new_zeros(())
        dm = torch.stack([torch.where(hm, ge, zero),
                          torch.where(hm, zero, ge)], 2).reshape(
            n, h, w // 2, c)
        wm = a >= b
        dxr = torch.cat([torch.where(wm, dm, zero),
                         torch.where(wm, zero, dm)], -1)
        return dxr.reshape(n, h, w, c)


class DensePool(torch.autograd.Function):
    """TERRAIN_POOL_VJP=dense (terrain_tpu/ops/pool.py:45-66): a
    size x size pool of stride size whose backward splits each cotangent
    equally among the window's elements equal to its maximum."""

    @staticmethod
    def forward(ctx, x, k):
        n, h, w, c = x.shape
        y = x.reshape(n, h // k, k, w // k, k, c).amax((2, 4))
        ctx.k = k
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        n, h, w, c = x.shape
        k = ctx.k
        xr = x.reshape(n, h // k, k, w // k, k, c)
        mask = (xr == y[:, :, None, :, None, :]).to(g.dtype)
        cnt = mask.sum((2, 4), keepdim=True)
        dx = mask * (g[:, :, None, :, None, :] / cnt)
        return dx.reshape(x.shape).to(x.dtype), None


def max_pool2d(x, size=2, stride=None, route_shape=None):
    """Max pool, x (N,H,W,C).  `route_shape`: the shape whose regime
    picks the formulation (default x's; a slab's whole image)."""
    mode = os.environ.get("TERRAIN_POOL_VJP", "sas")
    shape = route_shape or tuple(x.shape)
    if (isinstance(size, int) and (stride or size) == size
            and x.is_floating_point()
            and shape[1] % size == 0 and shape[2] % size == 0):
        if mode == "pallas" and size == 2 and _p2.supported(shape):
            return _p2.max_pool2(x)
        if mode == "lanes" and size == 2:
            return LanesPool.apply(x)
        if mode == "dense":
            return DensePool.apply(x, size)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x, size=2, stride=None, route_shape=None):
    """Average pool, summed in fp32 and cast back to x.dtype.  It has one
    formulation: `route_shape` is taken as max_pool2d's and not read."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1).to(x.dtype)

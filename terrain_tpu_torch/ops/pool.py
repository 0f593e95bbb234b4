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
the library pool).  'lanes' and 'dense', terrain_tpu's measured-loss
formulations, are not ported and raise.

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

import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels import pool2 as _p2


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool2d(x, size=2, stride=None, route_shape=None):
    """Max pool, x (N,H,W,C).  `route_shape`: the shape whose regime
    picks the formulation (default x's; a slab's whole image)."""
    mode = os.environ.get("TERRAIN_POOL_VJP", "sas")
    if mode in ("lanes", "dense"):
        raise NotImplementedError(
            f"TERRAIN_POOL_VJP={mode} is not ported; use sas or pallas")
    if (mode == "pallas" and size == 2 and (stride or size) == 2
            and x.is_floating_point()
            and _p2.supported(route_shape or tuple(x.shape))):
        return _p2.max_pool2(x)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x, size=2, stride=None, route_shape=None):
    """Average pool, summed in fp32 and cast back to x.dtype.  It has one
    formulation: `route_shape` is taken as max_pool2d's and not read."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1).to(x.dtype)

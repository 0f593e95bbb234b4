"""Pooling ops on NHWC tensors (terrain_tpu/ops/pool.py:116-156), as the
DCGAN discriminator uses them: 2x2 max or average pooling between stages
and one average pool over the remaining extent.  No implicit padding
(windows that do not fit are dropped, XLA's VALID).

Only terrain_tpu's default max-pool formulation is ported (XLA's
reduce_window, whose gradient is select-and-scatter); its other
TERRAIN_POOL_VJP modes are measured-loss references and an opt-in kernel.

Ties.  select-and-scatter sends a window's cotangent to one element, the
first maximum in row-major order.  `F.max_pool2d` does the same: its
forward scans the window in row-major order and replaces the running
maximum only on a strictly greater value (or a NaN), and its backward adds
the cotangent at that recorded index.  tests/test_torch_train.py pins this
on deliberate ties.
"""

import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool2d(x, size=2, stride=None):
    """Max pool, x (N,H,W,C)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x, size=2, stride=None):
    """Average pool, summed in fp32 and cast back to x.dtype."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), _pair(size),
                     _pair(stride or size))
    return y.permute(0, 2, 3, 1).to(x.dtype)

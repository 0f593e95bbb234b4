"""bilinear: bilinear x2 upsample with half-pixel centres and edge clamp over
NHWC fp32 tensors, differentiable.

Port of terrain_tpu/ops/pallas/bilinear.py.  It runs when terrain_tpu's own
switch TERRAIN_PALLAS=1 is set (ops/resize.py): on the flagship with the
fused decoder kernel switched off (TERRAIN_PALLAS_DECODER=0, ops/fused.py),
the U-Net's last bilinear decoder stage, (N,128,128,256) fp32, is the one
call in the regime.  The forward CUDA kernel is csrc/bilinear.cu;
`bilinear_2x_plain` is its plain PyTorch version in the kernel's order of
arithmetic (rows, then columns; each product and sum rounded), used for CPU
tensors and as the card-side reference.

The backward is the linear transpose, PyTorch code here as it is XLA code in
terrain_tpu (bilinear.py:133-137): `bilinear_2x_bwd`, the adjoint of the
plain version written out as shifted adds, with no atomics, so it gives the
same bits every run (`F.interpolate`'s backward accumulates with atomics on
the card).
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, nhwc_contiguous, stream_of)
from terrain_tpu_torch.utils.roofline import itemsize

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel("bilinear", "bilinear_2x_launch", [_P] * 2 + [_I] * 4
                    + [_P], name="bilinear", symbol="bilinear_2x_kernel",
                    cost_args=("n", "h", "w", "c", "dtype"))
# forward calls of the plain version (CPU tensors), backward passes of
# Bilinear2xFn, and inputs the op had to copy into NHWC-contiguous memory
PLAIN = OpCounter()
BACKWARD = OpCounter()
COPIES = OpCounter()

# terrain_tpu's regime (bilinear.py:73-87): 32-row/column tiles, and at least
# 128 rows and columns, where the TPU kernel beat XLA's resize
TILE = 32
MIN_SPATIAL = 128


def cost(name, n, h, w, c, dtype):
    """(flops, bytes, tf32_passes) of one launch of the kernel (`name`
    "bilinear") on an (n,h,w,c) input: three flops per interpolated value
    (the row pass makes 2H*W, the column pass 4H*W values per channel), the
    input read once and the 4x output written once."""
    return (3.0 * n * (2 * h * w + 4 * h * w) * c,
            itemsize(dtype) * n * h * w * c * 5, 0)


def _pick_tile(dim, target, align=8):
    """Tile of the TPU kernel (bilinear.py:63-67).  The CUDA kernel has no
    tiles; the term stays in `supported` so both packages route the same
    shapes."""
    for t in (target, 128, 64, 32, 16, 8):
        if t <= target and dim % t == 0 and t % align == 0:
            return t
    return 0


def supported(shape, dtype=torch.float32):
    """terrain_tpu's `pallas_supported` (bilinear.py:83-87): fp32 only."""
    n, h, w, c = shape
    return bool(h >= MIN_SPATIAL and w >= MIN_SPATIAL
                and _pick_tile(h, TILE) and _pick_tile(w, TILE)
                and c % 128 == 0 and dtype == torch.float32)


def interp_axis(x, axis):
    """Factor-2 half-pixel bilinear along `axis`, edge-clamped
    (terrain_tpu/ops/resize.py `_interp_axis`): two shifted views, two
    weighted sums, an interleave."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    axis)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shp = list(x.shape)
    shp[axis] = 2 * n
    return torch.stack([even, odd], axis + 1).reshape(shp)


def interp_axis_t(g, axis):
    """The adjoint of `interp_axis`: (.., 2n, ..) -> (.., n, ..).  Output j
    of the even phase took 0.25*x[max(j-1, 0)] + 0.75*x[j], of the odd phase
    0.75*x[j] + 0.25*x[min(j+1, n-1)]; each cotangent goes back the same
    way."""
    n = g.shape[axis] // 2
    shp = list(g.shape)
    shp[axis:axis + 1] = [n, 2]
    g2 = g.reshape(shp)
    ge, go = g2.select(axis + 1, 0), g2.select(axis + 1, 1)
    qe, qo = 0.25 * ge, 0.25 * go
    zero = torch.zeros_like(qe.narrow(axis, 0, 1))
    dx = (0.75 * ge + 0.75 * go
          + torch.cat([qe.narrow(axis, 1, n - 1), zero], axis)
          + torch.cat([zero, qo.narrow(axis, 0, n - 1)], axis))
    # the clamped taps at the two edges
    dx.narrow(axis, 0, 1).add_(qe.narrow(axis, 0, 1))
    dx.narrow(axis, n - 1, 1).add_(qo.narrow(axis, n - 1, 1))
    return dx


def bilinear_2x_plain(x):
    """Plain version: x (N,H,W,C) -> (N,2H,2W,C), in fp32, cast to
    x.dtype."""
    return interp_axis(interp_axis(x.float(), 1), 2).to(x.dtype)


def bilinear_2x_fwd(x):
    """Forward primitive (not differentiable: use `bilinear_2x`)."""
    if all_on_cpu("bilinear", x):
        PLAIN.calls += 1
        return bilinear_2x_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"bilinear: the kernel takes fp32, not {x.dtype}")
    if x.ndim != 4 or x.shape[3] % 4 or x.numel() == 0 \
            or x.data_ptr() % 16:
        raise ValueError(f"bilinear: x {tuple(x.shape)} (C a multiple of 4, "
                         f"16-byte aligned)")
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), y.data_ptr(), n, h, w, c, stream_of(x),
                  outputs=(y,), shape=(n, h, w, c, x.dtype))
    return y


def bilinear_2x_bwd(g, dtype):
    """Backward: dx from the cotangent alone (the op is linear), in fp32,
    cast to `dtype`."""
    BACKWARD.calls += 1
    return interp_axis_t(interp_axis_t(g.float(), 2), 1).to(dtype)


class Bilinear2xFn(torch.autograd.Function):
    """bilinear_2x with its transpose as the backward (terrain_tpu's
    custom_vjp, bilinear.py:122-140).  Saves no tensor: the backward needs
    only the input's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return bilinear_2x_fwd(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return bilinear_2x_bwd(g, ctx.dtype)


def bilinear_2x(x):
    """Bilinear x2 of x (N,H,W,C), differentiable: the kernel for CUDA
    tensors, its plain version for CPU tensors, through one
    `autograd.Function` either way.  Callers check `supported`."""
    return Bilinear2xFn.apply(nhwc_contiguous(x, COPIES))

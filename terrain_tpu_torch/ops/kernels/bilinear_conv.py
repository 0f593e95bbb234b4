"""bilinear_conv: fused bilinear x2 upsample + 3x3 zero-pad conv + bias,
differentiable.

Port of terrain_tpu/ops/pallas/bilinear_conv.py.  On the flagship it runs
the U-Net decoder stages (N,64,64,512)->(N,128,128,128) and
(N,128,128,256)->(N,256,256,64).  The forward CUDA kernel is
csrc/bilinear_conv.cu (TF32 tensor cores, products split 3xTF32 for fp32
accuracy); `bilinear_conv_plain` is its plain PyTorch version
(the fp32 composite, terrain_tpu's `_xla_composite`), used for CPU tensors
and as the card-side reference.

The backward is not a kernel in terrain_tpu either (`_bwd`,
bilinear_conv.py:312-332, is XLA code), so here it is PyTorch code, chosen
as terrain_tpu chooses it, by TERRAIN_BC_BWD read at each backward pass:
  * conv6 (default): dX from `dx_conv6`, `_dx_conv6` as written -- one
    stride-2 6x6 conv of the cotangent with the combined kernel, with no
    2x-resolution intermediate, plus four border strips for the upsample's
    edge clamp -- and dW, db of the composite, all in x.dtype;
  * xla32: dX, dW, db of the composite in fp32 (`_xla_composite`), for
    the cotangent in fp32, whatever the compute dtype;
  * anything else (terrain_tpu's "dense"): the composite's gradients in
    x.dtype, its upsample too (`_dense_composite`).
The composite is conv3x3(bilinear_2x(x)) + b; its gradients are the
library's conv gradients and autograd through the upsample alone
(`composite_grads`), so no forward conv runs.  Results are cast to the
dtypes of x, w and b, and the forward is the kernel under every value.
`BilinearConvFn` ties them together; `BACKWARD.calls` counts its backward
passes.
"""

import ctypes
import functools
import os

import torch
import torch.nn.functional as F
from torch.nn import grad as ng

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, stream_of)
from terrain_tpu_torch.utils.roofline import itemsize

TILE = 32
MIN_SPATIAL = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "bilinear_conv", "bilinear_conv_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    symbol="bilinear_conv_kernel",
    cost_args=("n", "h", "w", "c", "f", "dtype"))
BACKWARD = OpCounter()  # backward passes of BilinearConvFn
PLAIN = OpCounter()     # calls of the plain version (CPU tensors)


def cost(name, n, h, w, c, f, dtype):
    """(flops, bytes, tf32_passes) of one launch of the kernel (`name`
    "bilinear_conv") on an (n,h,w,c) input to (n,2h,2w,f): the 3x3 conv's
    products at the upsampled size, x, w and y moved once, b in fp32; its
    fp32 products take three TF32 passes (3xTF32)."""
    return (2.0 * n * 4 * h * w * 9 * c * f,
            itemsize(dtype) * (n * h * w * (c + 4 * f) + 9 * c * f) + 4 * f, 3)


def _pick_tile(dim, target):
    for t in (target, 64, 32, 16, 8):
        if t <= target and dim % t == 0 and t % 8 == 0:
            return t
    return 0


def supported(x_shape, w_shape):
    """Shape rule of the kernel's regime: terrain_tpu's guard
    (bilinear_conv.py:111-127) without its backend test."""
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    ct = min(c, 128)
    return (kh == 3 and kw == 3 and ci == c
            and h >= MIN_SPATIAL and w >= MIN_SPATIAL
            and bool(_pick_tile(h, TILE)) and bool(_pick_tile(w, TILE))
            and c % ct == 0 and c % 8 == 0 and f % 8 == 0 and f <= 1024
            and c * f <= 512 * 128)


def bilinear_conv_plain(x, w, b):
    """Plain version: upsample and conv in fp32, then cast to x.dtype.
    x (N,H,W,C), w (3,3,C,F) HWIO, b (F,)."""
    up = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    y = F.conv2d(up, w.float().permute(3, 2, 0, 1), padding=1)
    y = y + b.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def bilinear_conv_fwd(x, w, b):
    """Forward primitive (not differentiable on CUDA tensors: use
    `bilinear_conv`).  w in x.dtype, b fp32."""
    if all_on_cpu("bilinear_conv", x, w, b):
        PLAIN.calls += 1
        return bilinear_conv_plain(x, w, b)
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or b.dtype != torch.float32:
        raise TypeError(
            f"bilinear_conv: x {x.dtype}, w {w.dtype}, b {b.dtype}")
    # the kernel takes channels in k8 steps and copies 16-byte pieces
    if x.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or x.shape[3] % 8 != 0 or w.shape[3] % 8 != 0 \
            or tuple(b.shape) != (w.shape[3],) \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"bilinear_conv: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} (C and F "
                         f"must be multiples of 8, x and w 16-byte aligned)")
    n, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((n, 2 * h, 2 * wd, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  n, h, wd, c, f, _DTYPES[x.dtype], stream_of(x),
                  outputs=(y,), shape=(n, h, wd, c, f, x.dtype))
    return y


@functools.lru_cache(maxsize=None)
def _tap_matrix(device):
    """M[a,u] with Kc[a,b] = sum_{u,v} M[a,u] M[b,v] w[u,v]: per axis, the
    bilinear-x2 adjoint (4 taps [1/4,3/4,3/4,1/4], stride 2) composed with
    the 3x3 conv adjoint (terrain_tpu `_tap_matrix_bilinear`).  Made once
    on each device: a copy from the host inside a train step would wait for
    the device, which a CUDA graph capture refuses."""
    k1 = (0.25, 0.75, 0.75, 0.25)
    m = torch.zeros(6, 3)
    for a in range(6):
        for u in range(3):
            if 0 <= a - 2 + u < 4:
                m[a, u] = k1[a - 2 + u]
    return m.to(device)


def _down4(v, axis):
    """Stride-2 4-tap [1/4,3/4,3/4,1/4] downsample along `axis`, zero pad
    (1,2), plus the edge-clamp adjoint: 1/4 of the first/last input sample
    onto the first/last output sample (terrain_tpu `_down4`, fix=True)."""
    n = v.shape[axis]
    ho = n // 2
    pad = [0, 0] * (v.ndim - 1 - axis) + [1, 2]
    vp = F.pad(v, pad)

    def sl(a):
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(a, a + 2 * ho - 1, 2)
        return vp[tuple(idx)]

    out = 0.25 * sl(0) + 0.75 * sl(1) + 0.75 * sl(2) + 0.25 * sl(3)
    head = out.narrow(axis, 0, 1) + 0.25 * v.narrow(axis, 0, 1)
    tail = out.narrow(axis, ho - 1, 1) + 0.25 * v.narrow(axis, n - 1, 1)
    return torch.cat([head, out.narrow(axis, 1, ho - 2), tail], dim=axis)


def dx_conv6(g, w):
    """Exact dX of (bilinear x2 -> conv3x3 'same'), terrain_tpu `_dx_conv6`
    (bilinear_conv.py:236-299).  g (N,2H,2W,F) in the compute dtype, w
    (3,3,C,F) HWIO -> (N,H,W,C) in g.dtype.  The interior is one stride-2
    6x6 conv of g in g.dtype; the first/last rows and columns, where the
    upsample clamps, come from fp32 strips of the 3x3 conv adjoint."""
    n, h2, w2, _ = g.shape
    if h2 < 4 or w2 < 4:
        raise ValueError(f"dx_conv6 needs cotangent H,W >= 4: {tuple(g.shape)}")
    ho, wo = h2 // 2, w2 // 2
    cd = g.dtype
    m = _tap_matrix(g.device)
    w32 = w.float()
    kc = torch.einsum("au,bv,uvio->ioab", m, m, w32).to(cd)  # (C,F,6,6)
    gn = g.permute(0, 3, 1, 2)  # NCHW view
    # pad (2,2) reads what terrain_tpu's (2,3) does: the third high row is
    # never under a window of an even-sized input
    main = F.conv2d(gn, kc, stride=2, padding=2)  # (N,C,H,W)

    wt = w32.flip(0, 1).permute(2, 3, 0, 1)  # (C,F,3,3): the conv adjoint
    g32 = gn.float()

    def strip(v, pad):
        return F.conv2d(F.pad(v, pad), wt)

    t_top = strip(g32[:, :, 0:4], (1, 1, 1, 0))       # t rows 0..2
    t_bot = strip(g32[:, :, h2 - 4:], (1, 1, 0, 1))   # t rows 2H-3..2H-1
    t_lef = strip(g32[:, :, :, 0:4], (1, 0, 1, 1))    # t cols 0..2
    t_rig = strip(g32[:, :, :, w2 - 4:], (0, 1, 1, 1))
    # clamp-inclusive weights [1, 3/4, 1/4] on the three border lines, then
    # the full (clamped) adjoint along the other axis
    row0 = _down4(t_top[:, :, 0:1] + 0.75 * t_top[:, :, 1:2]
                  + 0.25 * t_top[:, :, 2:3], 3)
    rowl = _down4(0.25 * t_bot[:, :, 0:1] + 0.75 * t_bot[:, :, 1:2]
                  + t_bot[:, :, 2:3], 3)
    col0 = _down4(t_lef[..., 0:1] + 0.75 * t_lef[..., 1:2]
                  + 0.25 * t_lef[..., 2:3], 2)
    coll = _down4(0.25 * t_rig[..., 0:1] + 0.75 * t_rig[..., 1:2]
                  + t_rig[..., 2:3], 2)
    mid = torch.cat([col0[:, :, 1:ho - 1].to(cd),
                     main[:, :, 1:ho - 1, 1:wo - 1],
                     coll[:, :, 1:ho - 1].to(cd)], dim=3)
    dx = torch.cat([row0.to(cd), mid, rowl.to(cd)], dim=2)
    return dx.permute(0, 2, 3, 1).contiguous()


def composite_grads(x, w, g, dtype, need=(True, True, True)):
    """dX (N,H,W,C), dW (3,3,C,F) and db (F,) of conv3x3(bilinear_2x(x)) + b
    for the cotangent g (N,2H,2W,F), computed in `dtype` (terrain_tpu's
    `_dense_composite` vjp in x.dtype, `_xla_composite`'s in fp32); each is
    None unless `need` asks for it.  db sums in fp32."""
    from terrain_tpu_torch.ops.resize import upsample_bilinear_2x_lowp

    need_x, need_w, need_b = need
    db = g.sum(dim=(0, 1, 2), dtype=torch.float32) if need_b else None
    if not (need_x or need_w):
        return None, None, db
    gn = g.to(dtype).permute(0, 3, 1, 2)
    xd = x.detach().to(dtype).requires_grad_(need_x)
    with torch.enable_grad():
        up = upsample_bilinear_2x_lowp(xd).permute(0, 3, 1, 2)
    wn = w.to(dtype).permute(3, 2, 0, 1)  # (F,C,3,3)
    dx = dw = None
    if need_w:
        dw = ng.conv2d_weight(up.detach(), tuple(wn.shape), gn, padding=1)
        dw = dw.permute(2, 3, 1, 0)
    if need_x:
        t = ng.conv2d_input(tuple(up.shape), wn, gn, padding=1)
        (dx,) = torch.autograd.grad(up, xd, t)
    return dx, dw, db


class BilinearConvFn(torch.autograd.Function):
    """bilinear_conv with terrain_tpu's backward under TERRAIN_BC_BWD
    (conv6, xla32 or dense): results cast to the dtypes of x, w, b; a
    gradient nobody asked for is not computed."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return bilinear_conv_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        BACKWARD.calls += 1
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        mode = os.environ.get("TERRAIN_BC_BWD", "conv6")
        if mode == "conv6":
            gc = g.to(x.dtype)
            _, dw, db = composite_grads(x, w, gc, x.dtype,
                                        (False, need[1], need[2]))
            dx = dx_conv6(gc, w) if need[0] else None
        else:
            dt = torch.float32 if mode == "xla32" else x.dtype
            dx, dw, db = composite_grads(x, w, g, dt, need)
        return tuple(None if v is None else v.to(want) for v, want in
                     zip((dx, dw, db), (x.dtype, w.dtype, ctx.b_dtype)))


def bilinear_conv(x, w, b):
    """Fused bilinear x2 + conv3x3 'same' + bias, differentiable: the
    kernel for CUDA tensors, the plain version (which autograd follows) for
    CPU tensors.  w in x.dtype, b fp32."""
    if all_on_cpu("bilinear_conv", x, w, b):
        PLAIN.calls += 1
        return bilinear_conv_plain(x, w, b)
    return BilinearConvFn.apply(x, w, b)

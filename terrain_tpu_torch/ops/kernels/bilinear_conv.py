"""bilinear_conv: fused bilinear x2 upsample + 3x3 zero-pad conv + bias,
differentiable.

Port of terrain_tpu/ops/pallas/bilinear_conv.py.  On the flagship it runs
the U-Net decoder stages (N,64,64,512)->(N,128,128,128) and
(N,128,128,256)->(N,256,256,64).  The forward CUDA kernel is
csrc/bilinear_conv.cu; `bilinear_conv_plain` is its plain PyTorch version
(the fp32 composite, terrain_tpu's `_xla_composite`), used for CPU tensors
and as the card-side reference.

The backward is not a kernel in terrain_tpu either (`_bwd`,
bilinear_conv.py:312-332, is XLA code), so here it is PyTorch code:
`dx_conv6` is `_dx_conv6` as written -- one stride-2 6x6 conv of the
cotangent with the combined kernel, with no 2x-resolution intermediate,
plus four border strips for the upsample's edge clamp -- and dW, db are the
gradient of conv3x3(bilinear_2x(x)) in x.dtype.  `BilinearConvFn` ties the
two together; `BACKWARD.calls` counts its backward passes.
"""

import ctypes

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, stream_of)

TILE = 32
MIN_SPATIAL = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "bilinear_conv", "bilinear_conv_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
BACKWARD = OpCounter()  # backward passes of BilinearConvFn


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
        return bilinear_conv_plain(x, w, b)
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or b.dtype != torch.float32:
        raise TypeError(
            f"bilinear_conv: x {x.dtype}, w {w.dtype}, b {b.dtype}")
    if x.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or w.shape[3] % 8 != 0 or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"bilinear_conv: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    n, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((n, 2 * h, 2 * wd, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  n, h, wd, c, f, _DTYPES[x.dtype], stream_of(x))
    return y


def _tap_matrix():
    """M[a,u] with Kc[a,b] = sum_{u,v} M[a,u] M[b,v] w[u,v]: per axis, the
    bilinear-x2 adjoint (4 taps [1/4,3/4,3/4,1/4], stride 2) composed with
    the 3x3 conv adjoint (terrain_tpu `_tap_matrix_bilinear`)."""
    k1 = (0.25, 0.75, 0.75, 0.25)
    m = torch.zeros(6, 3)
    for a in range(6):
        for u in range(3):
            if 0 <= a - 2 + u < 4:
                m[a, u] = k1[a - 2 + u]
    return m


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
    m = _tap_matrix().to(g.device)
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


def dw_db(x, g, w_shape):
    """dW (3,3,C,F) and db (F,) of conv3x3(bilinear_2x(x)) + b for the
    cotangent g, computed in x.dtype as terrain_tpu's `_dense_composite`
    vjp does."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    c, f = w_shape[2], w_shape[3]
    gn = g.permute(0, 3, 1, 2)
    dw = torch.nn.grad.conv2d_weight(up, (f, c, 3, 3), gn, padding=1)
    return dw.permute(2, 3, 1, 0), g.sum(dim=(0, 1, 2), dtype=torch.float32)


class BilinearConvFn(torch.autograd.Function):
    """bilinear_conv with terrain_tpu's `conv6` backward: g cast to
    x.dtype, results cast to the dtypes of x, w, b; a gradient nobody
    asked for is not computed."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return bilinear_conv_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        BACKWARD.calls += 1
        x, w = ctx.saved_tensors
        gc = g.to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dx_conv6(gc, w).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = dw_db(x, gc, w.shape)
            dw = dw.to(w.dtype)
        return dx, dw, db


def bilinear_conv(x, w, b):
    """Fused bilinear x2 + conv3x3 'same' + bias, differentiable: the
    kernel for CUDA tensors, the plain version (which autograd follows) for
    CPU tensors.  w in x.dtype, b fp32."""
    if all_on_cpu("bilinear_conv", x, w, b):
        return bilinear_conv_plain(x, w, b)
    return BilinearConvFn.apply(x, w, b)

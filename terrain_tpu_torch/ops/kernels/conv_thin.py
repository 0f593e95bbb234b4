"""conv_thin: 3x3 s1 zero-pad conv with cout <= 8, no bias, differentiable.

Port of terrain_tpu/ops/pallas/conv_thin.py.  On the flagship it is the
DCGAN generator's output conv after phase decomposition
(ops/fused.upsample2x_nearest_conv: 5x5 -> 1 becomes 3x3 64 -> 4 at 256^2),
forward in serving and forward + dX + dW in a train step.  The CUDA kernels
are in csrc/conv_thin.cu; the `*_plain` functions are their plain PyTorch
versions, used for CPU tensors and as the card-side references.

Each primitive (`conv_thin_fwd`, `conv_thin_dx`, `conv_thin_dw`) runs its
plain version only because its tensors lie on the CPU; on CUDA tensors it
launches its kernel or raises.  `ConvThinFn` ties them into one
differentiable op, as terrain_tpu's custom_vjp does (conv_thin.py:269-291).
"""

import ctypes

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, all_on_cpu, partial_blocks, stream_of)

K = 3
TH = 16  # the JAX guard's band height (h % TH == 0)
SW = 64  # output columns of a strip of the row stream (csrc/conv_thin.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel("conv_thin", "conv_thin_launch",
                    [_P] * 3 + [_I] * 6 + [_P])
KERNEL_DX = CudaKernel("conv_thin", "conv_thin_dx_launch",
                       [_P] * 3 + [_I] * 6 + [_P])
KERNEL_DW = CudaKernel("conv_thin", "conv_thin_dw_launch",
                       [_P] * 4 + [_I] * 7 + [_P])

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_THIN_TH": "the TPU kernel's row-band tile height; these "
                       "kernels' tiles are their own",
}


def supported(x_shape, w_shape, stride, padding):
    """Shape rule of the kernel's regime: terrain_tpu's guard
    (conv_thin.py:140-161) without its backend test and without its n <= 4
    gate, which was a TPU timing decision (RESULTS_r4 4c) that would send
    the server's bucket-8 batches around the kernel."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    s = stride if isinstance(stride, tuple) else (stride, stride)
    return (padding == "same" and s == (1, 1)
            and kh == K and kw == K and ci == c
            and 8 <= c <= 64 and c % 8 == 0 and 1 <= f <= 8
            and h % TH == 0 and h >= 64
            and w % 128 == 0 and 128 <= w <= 1024)


def walk(n, h, w, blocks):
    """The row stream's walk, as csrc/conv_thin.cu's `walk` lays it out:
    output rows in (image, strip, row) order, `strips` column strips of SW
    outputs an image, an equal `share` of them for each of `grid` <=
    `blocks` blocks (the last share may be shorter, later ones empty).
    Returns (strips, grid, share)."""
    strips = -(-w // SW)
    rows = n * strips * h
    grid = min(rows, blocks)
    return strips, grid, -(-rows // grid)


def check_stream(name, x):
    """The row stream copies x's rows in whole 16-byte pieces: C must be a
    multiple of 8 (a pixel is then 16 or 32 bytes) and x 16-byte aligned.
    Raises ValueError otherwise."""
    if x.shape[-1] % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: x {tuple(x.shape)} at offset "
                         f"{x.data_ptr() % 16} mod 16 (C must be a multiple "
                         f"of 8, x 16-byte aligned)")


def _nchw(t):
    return t.float().permute(0, 3, 1, 2)


def conv_thin_plain(x, w):
    """Plain version: products of x.dtype values summed in fp32, output in
    x.dtype.  x (N,H,W,C), w (3,3,C,F) HWIO."""
    wq = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(_nchw(x), wq, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_thin_dx_plain(g, w):
    """dX[n,h,w,i] = sum g[n,h+1-dy,w+1-dx,o] * w[dy,dx,i,o]: the 3x3 conv
    of g with rot180(w), in/out swapped.  g (N,H,W,F) -> (N,H,W,C) in
    g.dtype."""
    wr = w.to(g.dtype).float().flip(0, 1).permute(2, 3, 0, 1)  # (C,F,3,3)
    dx = F.conv2d(_nchw(g), wr, padding=1)
    return dx.permute(0, 2, 3, 1).to(g.dtype).contiguous()


def conv_thin_dw_plain(x, g):
    """dW[dy,dx,i,o] = sum x[n,h+dy-1,w+dx-1,i] * g[n,h,w,o], fp32
    (3,3,C,F): one contraction over all pixels per tap."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    return torch.stack([torch.stack([
        torch.einsum("nhwi,nhwo->io", xp[:, dy:dy + h, dx:dx + w], gf)
        for dx in range(K)]) for dy in range(K)])


def _check(name, a, w_shape, c, f, b=None):
    """a (N,H,W,c) and optionally b (N,H,W,f) with a (3,3,C,F) weight."""
    if a.dtype not in _DTYPES or (b is not None and b.dtype != a.dtype):
        raise TypeError(f"{name}: dtypes {a.dtype}, "
                        f"{None if b is None else b.dtype}")
    if a.ndim != 4 or a.shape[3] != c or not 1 <= w_shape[3] <= 8 \
            or not 1 <= w_shape[2] <= 64 or tuple(w_shape[:2]) != (K, K) \
            or (b is not None and tuple(b.shape) != (*a.shape[:3], f)):
        raise ValueError(f"{name}: {tuple(a.shape)} with w {tuple(w_shape)}")


def conv_thin_fwd(x, w):
    """Forward primitive (not differentiable on CUDA tensors: use
    `conv_thin`)."""
    if all_on_cpu("conv_thin", x, w):
        return conv_thin_plain(x, w)
    _check("conv_thin", x, w.shape, w.shape[2], w.shape[3])
    if w.dtype != x.dtype:
        raise TypeError(f"conv_thin: x {x.dtype}, w {w.dtype}")
    check_stream("conv_thin", x)
    n, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, f,
                  _DTYPES[x.dtype], stream_of(x))
    return y


def conv_thin_dx(g, w):
    """dX of conv_thin: g (N,H,W,F), w (3,3,C,F) in g.dtype -> (N,H,W,C)."""
    if all_on_cpu("conv_thin_dx", g, w):
        return conv_thin_dx_plain(g, w)
    _check("conv_thin_dx", g, w.shape, w.shape[3], w.shape[3])
    if w.dtype != g.dtype:
        raise TypeError(f"conv_thin_dx: g {g.dtype}, w {w.dtype}")
    n, h, wd, f = g.shape
    c = w.shape[2]
    dx = torch.empty((n, h, wd, c), dtype=g.dtype, device=g.device)
    KERNEL_DX.launch(g.data_ptr(), w.data_ptr(), dx.data_ptr(), n, h, wd, c,
                     f, _DTYPES[g.dtype], stream_of(g))
    return dx


def conv_thin_dw(x, g):
    """dW of conv_thin: x (N,H,W,C), g (N,H,W,F) -> fp32 (3,3,C,F)."""
    if all_on_cpu("conv_thin_dw", x, g):
        return conv_thin_dw_plain(x, g)
    c, f = x.shape[-1], g.shape[-1]
    _check("conv_thin_dw", x, (K, K, c, f), c, f, b=g)
    check_stream("conv_thin_dw", x)
    n, h, wd, _ = x.shape
    nb = partial_blocks(x)
    # the block partials and, in the last row, dW, one allocation a call
    # (the returned view keeps the partials' buffer alive with it)
    part = torch.empty((nb + 1, K * K * c * f), dtype=torch.float32,
                       device=x.device)
    ptr = part.data_ptr()
    KERNEL_DW.launch(x.data_ptr(), g.data_ptr(), ptr,
                     ptr + 4 * nb * K * K * c * f, nb, n, h, wd, c, f,
                     _DTYPES[x.dtype], stream_of(x))
    return part[nb].view(K, K, c, f)


class ConvThinFn(torch.autograd.Function):
    """conv_thin with its gradient kernels (terrain_tpu's _conv_thin_bwd,
    conv_thin.py:283-288): g is cast to x.dtype, dW back to w.dtype; a
    gradient nobody asked for is not computed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv_thin_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv_thin_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = conv_thin_dw(x, g).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def conv_thin(x, w):
    """3x3 s1 'same' conv, cout <= 8, no bias, differentiable: the kernels
    for CUDA tensors, the plain version (which autograd follows) for CPU
    tensors."""
    if all_on_cpu("conv_thin", x, w):
        return conv_thin_plain(x, w)
    return ConvThinFn.apply(x, w)

"""conv_stem: 5x5 s1 zero-pad conv of a one-channel image into F maps, with
bias and an optional fused LeakyReLU, differentiable.

Port of terrain_tpu/ops/pallas/conv_stem.py.  On the flagship it is the
DCGAN discriminator's first layer, (2N,512,512,1) -> 64 with LeakyReLU(0.2):
forward twice per train step (the fake batch with frozen parameters, and
concat[real, fake]), dX once (generator path) and dW+db once
(discriminator path).  The CUDA kernels are in csrc/conv_stem.cu; the
`*_plain` functions are their plain PyTorch versions, used for CPU tensors
and as the card-side references.

With a slope the activation's backward select `g if y >= 0 else slope*g`
runs inside the dW and dX kernels against the saved output y (y == 0
counts as positive, terrain_tpu conv_stem.py:373-374,396), so the masked
cotangent never goes through device memory.

Types (terrain_tpu/ops/conv.py:33-36, conv_stem.py:256-257,366,383): x and
w arrive in the compute dtype and are used in fp32; b is fp32 and never
rounded; y is x.dtype; dW is returned in w.dtype, db in fp32, dX in
x.dtype.
"""

import ctypes

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, partial_blocks, stream_of)
from terrain_tpu_torch.utils.roofline import itemsize

K = 5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL_FWD = CudaKernel("conv_stem", "conv_stem_fwd_launch",
                        [_P] * 4 + [_I] * 5 + [_F, _I, _P],
                        symbol="stem_fwd_kernel",
                        cost_args=("n", "h", "w", "f", "dtype"))
KERNEL_DW = CudaKernel("conv_stem", "conv_stem_dw_launch",
                       [_P] * 5 + [_I] * 6 + [_F, _I, _P],
                       symbol="stem_dw_kernel",
                       cost_args=("n", "h", "w", "f", "mask", "dtype"))
KERNEL_DX = CudaKernel("conv_stem", "conv_stem_dx_launch",
                       [_P] * 4 + [_I] * 5 + [_F, _I, _P],
                       symbol="stem_dx_kernel",
                       cost_args=("n", "h", "w", "f", "mask", "dtype"))
PLAIN = OpCounter()  # calls of the plain versions (CPU tensors)

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_ACT_BWD": "the leaky select always runs inside the dW and dX "
                       "kernels, in fp32 (terrain_tpu's =1 formulation; "
                       "its default rounds slope*g to the compute dtype "
                       "first, which differs in bf16 by that one rounding)",
    "TERRAIN_STEM_PLANES": "the dtype of the TPU kernels' shifted plane "
                           "stack in HBM; these kernels read x itself",
    "TERRAIN_STEM_TH": "the TPU kernels' row-band tile height; these "
                       "kernels' tiles are fixed by F",
}


def cost(name, n, h, w, f, dtype, mask=0):
    """(flops, bytes, tf32_passes) of one launch of `name` (conv_stem_fwd,
    conv_stem_dw or conv_stem_dx) at an (n,h,w,1) image and F maps; `mask`
    1 when dW or dX reads the saved output for the leaky select.  Each
    input read once, each output written once (dW and db in fp32)."""
    es, k = itemsize(dtype), 2 if mask else 1
    if name == "conv_stem_fwd":
        return (2.0 * n * h * w * 25 * f,
                es * (n * h * w * (1 + f) + 25 * f) + 4 * f, 0)
    if name == "conv_stem_dw":
        return (2.0 * n * h * w * 26 * f,
                es * n * h * w * (1 + k * f) + 4 * 26 * f, 0)
    return (2.0 * n * h * w * 25 * f,
            es * (n * h * w * (1 + k * f) + 25 * f), 0)


def supported(x_shape, w_shape, stride, padding):
    """Shape rule of the kernels' regime: terrain_tpu's guard
    (conv_stem.py:197-211) without its backend test."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    return (padding == "same" and stride in (1, (1, 1))
            and kh == K and kw == K and c == 1 and ci == 1
            and h >= 256 and w >= 256 and w % 128 == 0
            and f % 8 == 0 and f <= 512 and h % 8 == 0)


def _leaky(y, slope):
    return y if slope is None else torch.maximum(y, slope * y)


def _masked(g, y, slope):
    g = g.float()
    return g if slope is None else torch.where(y >= 0, g, slope * g)


def conv_stem_fwd_plain(x, w, b, slope=None):
    """x (N,H,W,1), w (5,5,1,F) HWIO, b (F,) -> (N,H,W,F) in x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(x.dtype).float().permute(3, 2, 0, 1), padding=2)
    y = _leaky(y + b.float()[:, None, None], slope)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_stem_dw_plain(x, g, y=None, slope=None):
    """fp32 dW (5,5,1,F) and db (F,): one contraction over all pixels per
    tap."""
    gm = _masked(g, y, slope)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.float()[..., 0], (2, 2, 2, 2))
    dw = torch.stack([torch.stack([
        torch.einsum("nhw,nhwf->f", xp[:, dy:dy + h, dx:dx + w], gm)
        for dx in range(K)]) for dy in range(K)])
    return dw[:, :, None, :].contiguous(), gm.sum(dim=(0, 1, 2))


def conv_stem_dx_plain(g, w, y=None, slope=None):
    """dX (N,H,W,1) in g.dtype: the 5x5 conv of the masked g with
    rot180(w), F -> 1."""
    gm = _masked(g, y, slope)
    wr = w.to(g.dtype).float().flip(0, 1).permute(2, 3, 0, 1)  # (1,F,5,5)
    dx = F.conv2d(gm.permute(0, 3, 1, 2), wr, padding=2)
    return dx.permute(0, 2, 3, 1).to(g.dtype).contiguous()


def _check(name, x=None, w=None, g=None, y=None):
    ref = x if x is not None else g
    f = (w if w is not None else g).shape[-1]
    for t in (x, w, g, y):
        if t is not None and (t.dtype not in _DTYPES or t.dtype != ref.dtype):
            raise TypeError(f"{name}: dtypes differ or are unsupported: "
                            f"{t.dtype} vs {ref.dtype}")
    nhw = tuple(ref.shape[:3])
    ok = ref.ndim == 4 and f % 8 == 0 and f <= 512
    ok = ok and (x is None or tuple(x.shape) == (*nhw, 1))
    ok = ok and (w is None or tuple(w.shape) == (K, K, 1, f))
    ok = ok and all(t is None or tuple(t.shape) == (*nhw, f) for t in (g, y))
    if not ok:
        raise ValueError(f"{name}: shapes " + ", ".join(
            str(tuple(t.shape)) for t in (x, w, g, y) if t is not None))
    return (*nhw, f)


def conv_stem_fwd(x, w, b, slope=None):
    """Forward primitive (not differentiable on CUDA tensors: use
    `conv_stem`)."""
    if all_on_cpu("conv_stem", x, w, b):
        PLAIN.calls += 1
        return conv_stem_fwd_plain(x, w, b, slope)
    n, h, wd, f = _check("conv_stem", x=x, w=w)
    if b.dtype != torch.float32 or tuple(b.shape) != (f,):
        raise TypeError(f"conv_stem: b {b.dtype} {tuple(b.shape)}")
    y = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    KERNEL_FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                      n, h, wd, f, int(slope is not None), float(slope or 0.0),
                      _DTYPES[x.dtype], stream_of(x), outputs=(y,),
                      shape=(n, h, wd, f, x.dtype))
    return y


def conv_stem_dw(x, g, y=None, slope=None):
    """dW+db primitive: fp32 (5,5,1,F) and (F,).  y is the saved output,
    needed with a slope."""
    mask = slope is not None
    ts = (x, g, y) if mask else (x, g)
    if all_on_cpu("conv_stem_dw", *ts):
        PLAIN.calls += 1
        return conv_stem_dw_plain(x, g, y, slope)
    n, h, wd, f = _check("conv_stem_dw", x=x, g=g, y=y if mask else None)
    if any(t.data_ptr() % 16 for t in ts[1:]):
        raise ValueError("conv_stem_dw: g and y must be 16-byte aligned")
    # one persistent block per SM, streaming its share of the tiles
    nb = partial_blocks(x, per_sm=1)
    part = torch.empty((nb, (K * K + 1) * f), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((K * K + 1, f), dtype=torch.float32, device=x.device)
    KERNEL_DW.launch(x.data_ptr(), g.data_ptr(),
                     y.data_ptr() if mask else None, part.data_ptr(),
                     out.data_ptr(), nb, n, h, wd, f, int(mask),
                     float(slope or 0.0), _DTYPES[x.dtype], stream_of(x),
                     outputs=(out,), shape=(n, h, wd, f, int(mask), x.dtype))
    return out[:K * K].reshape(K, K, 1, f), out[K * K]


def conv_stem_dx(g, w, y=None, slope=None):
    """dX primitive: (N,H,W,1) in g.dtype."""
    mask = slope is not None
    ts = (g, w, y) if mask else (g, w)
    if all_on_cpu("conv_stem_dx", *ts):
        PLAIN.calls += 1
        return conv_stem_dx_plain(g, w, y, slope)
    n, h, wd, f = _check("conv_stem_dx", w=w, g=g, y=y if mask else None)
    if any(t.data_ptr() % 16 for t in ts[:1] + ts[2:]):
        raise ValueError("conv_stem_dx: g and y must be 16-byte aligned")
    dx = torch.empty((n, h, wd, 1), dtype=g.dtype, device=g.device)
    KERNEL_DX.launch(g.data_ptr(), y.data_ptr() if mask else None,
                     w.data_ptr(), dx.data_ptr(), n, h, wd, f, int(mask),
                     float(slope or 0.0), _DTYPES[g.dtype], stream_of(g),
                     outputs=(dx,), shape=(n, h, wd, f, int(mask), g.dtype))
    return dx


class ConvStemFn(torch.autograd.Function):
    """conv_stem with its gradient kernels (terrain_tpu's _conv_stem_bwd,
    conv_stem.py:377-399, with the select in the kernels).  A gradient
    nobody asked for is not computed: the generator path of a train step
    needs dX only, the discriminator path dW+db only."""

    @staticmethod
    def forward(ctx, x, w, b, slope):
        y = conv_stem_fwd(x, w, b, slope)
        ctx.slope = slope
        ctx.save_for_backward(x, w, y if slope is not None else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_stem_dx(g, w, y, ctx.slope)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv_stem_dw(x, g, y, ctx.slope)
            dw = dw.to(w.dtype)
        return dx, dw, db, None


def conv_stem(x, w, b, slope=None):
    """5x5 s1 'same' conv, cin 1, + bias, optional LeakyReLU(slope),
    differentiable: the kernels for CUDA tensors, the plain version (which
    autograd follows) for CPU tensors.  w in x.dtype, b fp32."""
    if all_on_cpu("conv_stem", x, w, b):
        PLAIN.calls += 1
        return conv_stem_fwd_plain(x, w, b, slope)
    return ConvStemFn.apply(x, w, b, slope)

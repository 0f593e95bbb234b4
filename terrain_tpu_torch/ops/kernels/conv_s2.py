"""conv_s2: 3x3 stride-2 conv with symmetric padding 1 of an image with few
channels (cin 1, 2 or 4) into F maps, with bias and an optional fused
LeakyReLU, differentiable.

Port of terrain_tpu/ops/pallas/conv_s2.py.  On the flagship it is the U-Net
encoder's first conv, (N,512,512,1) -> 64 without activation, and PatchGAN's
first conv over concat(A, B), (N and 2N,512,512,4) -> 64 with
LeakyReLU(0.01): forward three times per train step and dW+db twice.  The
CUDA kernels are in csrc/conv_s2.cu; the `*_plain` functions are their plain
PyTorch versions, used for CPU tensors and as the card-side references.

Padding is one row and one column on BOTH sides (Lasagne 'same',
terrain_tpu/ops/conv.py:8-11): output row y taps input rows 2y-1 .. 2y+1.

With a slope the dW kernel takes the raw cotangent and the saved output y
and applies the activation's backward select `g if y >= 0 else slope*g`
itself (conv_s2.py:108-111), so the masked cotangent makes no round trip
through device memory on that side.  dX is no kernel in terrain_tpu either
(conv_s2.py:284-288): it is `torch.nn.grad.conv2d_input` on the selected
cotangent, and is skipped when the input needs no gradient (the U-Net's
input is data; PatchGAN's discriminator pass sees detached inputs).

Types (terrain_tpu/ops/conv.py:55-56, conv_s2.py:172-173): x and w arrive
in the compute dtype and are used in fp32; b is fp32 and never rounded; y is
x.dtype; dW is returned in w.dtype, db in fp32, dX in x.dtype.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, nhwc_contiguous, partial_blocks,
    stream_of)
from terrain_tpu_torch.utils.roofline import itemsize

K = 3
DW_PER_SM = 1  # dW+db: one persistent block an SM (csrc/conv_s2.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL_FWD = CudaKernel("conv_s2", "conv_s2_fwd_launch",
                        [_P] * 4 + [_I] * 6 + [_F, _I, _P],
                        symbol="s2_fwd_kernel",
                        cost_args=("n", "h", "w", "c", "f", "dtype"))
KERNEL_DW = CudaKernel("conv_s2", "conv_s2_dw_launch",
                       [_P] * 5 + [_I] * 7 + [_F, _I, _P],
                       symbol="s2_dw_kernel",
                       cost_args=("n", "h", "w", "c", "f", "mask", "dtype"))

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_ACT_BWD": "the leaky select always runs inside the dW kernel, "
                       "in fp32 (terrain_tpu's =1 formulation)",
}
# calls of the plain versions (CPU tensors), and tensors the op had to copy
# into NHWC-contiguous memory before a launch
PLAIN = OpCounter()
COPIES = OpCounter()


def cost(name, n, h, w, c, f, dtype, mask=0):
    """(flops, bytes, tf32_passes) of one launch of `name` (conv_s2_fwd or
    conv_s2_dw) on an (n,h,w,c) input and (n,h/2,w/2,f) output or
    cotangent; `mask` 1 when dW reads the saved output for the leaky
    select.  Each input read once, each output written once (dW and db in
    fp32)."""
    es, k = itemsize(dtype), 2 if mask else 1
    if name == "conv_s2_fwd":
        return (2.0 * n * (h // 2) * (w // 2) * 9 * c * f,
                es * (n * h * w * c + n * h * w // 4 * f + 9 * c * f) + 4 * f,
                0)
    return (2.0 * n * (h // 2) * (w // 2) * (9 * c + 1) * f,
            es * (n * h * w * c + k * n * h * w // 4 * f)
            + 4 * (9 * c + 1) * f, 0)


def _pick_th(hout):
    for t in (16, 8):
        if hout % t == 0:
            return t
    return 0


def supported(x_shape, w_shape, stride, padding):
    """Shape rule of the kernels' regime: terrain_tpu's guard
    (conv_s2.py:136-151) without its backend test."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    s = stride if isinstance(stride, tuple) else (stride, stride)
    return (padding == "same" and tuple(s) == (2, 2)
            and kh == K and kw == K and ci == c and c in (1, 2, 4)
            and h % 2 == 0 and w % 2 == 0
            and (w // 2) % 128 == 0 and h >= 64
            and f % 8 == 0 and f <= 512
            and _pick_th(h // 2) != 0)


def _masked(g, y, slope):
    g = g.float()
    return g if slope is None else torch.where(y >= 0, g, slope * g)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def conv_s2_fwd_plain(x, w, b, slope=None):
    """x (N,H,W,cin), w (3,3,cin,F) HWIO, b (F,) -> (N,H/2,W/2,F) in
    x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 _oihw(w.to(x.dtype).float()), stride=2, padding=1)
    y = y + b.float()[:, None, None]
    if slope is not None:
        y = torch.maximum(y, slope * y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_s2_dw_plain(x, g, y=None, slope=None):
    """fp32 dW (3,3,cin,F) and db (F,) from the raw cotangent; the select
    against the saved output y is applied here when a slope is given."""
    gm = _masked(g, y, slope)
    cin, f = x.shape[-1], g.shape[-1]
    dw = nn_grad.conv2d_weight(x.float().permute(0, 3, 1, 2), (f, cin, K, K),
                               gm.permute(0, 3, 1, 2), stride=2, padding=1)
    return dw.permute(2, 3, 1, 0).contiguous(), gm.sum(dim=(0, 1, 2))


def conv_s2_dx(g, w, x_shape, y=None, slope=None):
    """dX (N,H,W,cin) in g.dtype: the library's transposed conv of the
    selected cotangent, on any device (no kernel, as in terrain_tpu)."""
    gx = g if slope is None else torch.where(y >= 0, g, slope * g)
    n, h, wd, cin = x_shape
    dx = nn_grad.conv2d_input((n, cin, h, wd), _oihw(w).to(g.dtype),
                              gx.permute(0, 3, 1, 2), stride=2, padding=1)
    return dx.permute(0, 2, 3, 1)


def _check(name, x, w=None, g=None, y=None):
    f = (w if w is not None else g).shape[-1]
    for t in (x, w, g, y):
        if t is not None and (t.dtype not in _DTYPES or t.dtype != x.dtype):
            raise TypeError(f"{name}: dtypes differ or are unsupported: "
                            f"{t.dtype} vs {x.dtype}")
    ok = x.ndim == 4 and x.shape[-1] in (1, 2, 4)
    ok = ok and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    ok = ok and f % 8 == 0 and f <= 512
    if ok:
        n, h, wd, cin = x.shape
        ok = w is None or tuple(w.shape) == (K, K, cin, f)
        ok = ok and all(t is None or tuple(t.shape) == (n, h // 2, wd // 2, f)
                        for t in (g, y))
    if not ok:
        raise ValueError(f"{name}: shapes " + ", ".join(
            str(tuple(t.shape)) for t in (x, w, g, y) if t is not None))
    return n, h, wd, cin, f


def conv_s2_fwd(x, w, b, slope=None):
    """Forward primitive (not differentiable: use `conv_s2`)."""
    if all_on_cpu("conv_s2", x, w, b):
        PLAIN.calls += 1
        return conv_s2_fwd_plain(x, w, b, slope)
    n, h, wd, cin, f = _check("conv_s2", x, w=w)
    if b.dtype != torch.float32 or tuple(b.shape) != (f,):
        raise TypeError(f"conv_s2: b {b.dtype} {tuple(b.shape)}")
    y = torch.empty((n, h // 2, wd // 2, f), dtype=x.dtype, device=x.device)
    KERNEL_FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                      n, h, wd, cin, f, int(slope is not None),
                      float(slope or 0.0), _DTYPES[x.dtype], stream_of(x),
                      outputs=(y,), shape=(n, h, wd, cin, f, x.dtype))
    return y


def check_dw_aligned(ts):
    """dW+db copies g and y tiles by 1-D bulk copies: both must be 16-byte
    aligned.  Raises ValueError otherwise."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("conv_s2_dw: g and y must be 16-byte aligned, not "
                         f"at offsets {[t.data_ptr() % 16 for t in ts]}")


def conv_s2_dw(x, g, y=None, slope=None):
    """dW+db primitive: fp32 (3,3,cin,F) and (F,).  g is the raw cotangent;
    y is the saved output, needed with a slope."""
    mask = slope is not None
    ts = (x, g, y) if mask else (x, g)
    if all_on_cpu("conv_s2_dw", *ts):
        PLAIN.calls += 1
        return conv_s2_dw_plain(x, g, y, slope)
    n, h, wd, cin, f = _check("conv_s2_dw", x, g=g, y=y if mask else None)
    check_dw_aligned(ts[1:])
    rows = K * K * cin + 1
    nb = partial_blocks(x, per_sm=DW_PER_SM)
    part = torch.empty((nb, rows * f), dtype=torch.float32, device=x.device)
    out = torch.empty((rows, f), dtype=torch.float32, device=x.device)
    KERNEL_DW.launch(x.data_ptr(), g.data_ptr(),
                     y.data_ptr() if mask else None, part.data_ptr(),
                     out.data_ptr(), nb, n, h, wd, cin, f, int(mask),
                     float(slope or 0.0), _DTYPES[x.dtype], stream_of(x),
                     outputs=(out,),
                     shape=(n, h, wd, cin, f, int(mask), x.dtype))
    return out[:rows - 1].reshape(K, K, cin, f), out[rows - 1]


class ConvS2Fn(torch.autograd.Function):
    """conv_s2 with its dW+db kernel (terrain_tpu's _conv_s2_bwd,
    conv_s2.py:263-289, with the select in the kernel).  A gradient nobody
    asked for is not computed."""

    @staticmethod
    def forward(ctx, x, w, b, slope):
        y = conv_s2_fwd(x, w, b, slope)
        ctx.slope = slope
        ctx.save_for_backward(x, w, y if slope is not None else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = nhwc_contiguous(g.to(x.dtype), COPIES)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_s2_dx(g, w, tuple(x.shape), y, ctx.slope)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv_s2_dw(x, g, y, ctx.slope)
            dw = dw.to(w.dtype)
        return dx, dw, db, None


def conv_s2(x, w, b, slope=None):
    """3x3 s2 'same' conv, cin 1/2/4, + bias, optional LeakyReLU(slope),
    differentiable: the kernels for CUDA tensors, their plain versions for
    CPU tensors, through one `autograd.Function` either way.  w (3,3,cin,F)
    in x.dtype, b fp32.  Callers check `supported`."""
    return ConvS2Fn.apply(nhwc_contiguous(x, COPIES), w, b, slope)

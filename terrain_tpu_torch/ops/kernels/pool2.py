"""pool2: 2x2 stride-2 max pool over NHWC tensors, forward and backward.

Port of terrain_tpu/ops/pallas/pool2.py.  On the flagship it is the DCGAN
discriminator's max pool between stages (six of its seven stages lie in the
regime; the 8x8 one does not), forward and backward in both discriminator
passes of a train step.  The CUDA kernels are in csrc/pool2.cu; the
`*_plain` functions are their plain PyTorch versions, in the kernels' own
arithmetic (pairwise maxima, two `>=` selects), used for CPU tensors and as
the card-side references.

Ties: the cotangent of a window goes to ONE element, the first maximum in
row-major order (pool2.py:84-94): the even row wins when its maximum is >=
the odd row's, and inside the winning row the even column wins when a >= b.

NaN: the forward propagates it (maximum of a NaN and anything is NaN, in
the kernel as in `torch.maximum`); `>=` is false for a NaN, so the backward
then routes the cotangent to the later element.  `F.max_pool2d` also
propagates NaN forward but records the NaN's own index; the two differ only
on inputs that already hold NaN.

Compares run in fp32 and the result is written in x's dtype: always exactly
one of the four inputs, in bf16 too.
"""

import ctypes

import torch

from terrain_tpu_torch.ops.kernels._build import (
    CudaKernel, OpCounter, all_on_cpu, nhwc_contiguous, stream_of)
from terrain_tpu_torch.utils.roofline import itemsize

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

_ARGS = ("n", "h", "w", "c", "dtype")  # cost()'s shape arguments
KERNEL_FWD = CudaKernel("pool2", "pool2_fwd_launch",
                        [_P] * 2 + [_I] * 5 + [_P],
                        symbol="pool2_fwd_kernel", cost_args=_ARGS)
KERNEL_BWD = CudaKernel("pool2", "pool2_bwd_launch",
                        [_P] * 3 + [_I] * 5 + [_P],
                        symbol="pool2_bwd_kernel", cost_args=_ARGS)
# calls of the plain versions (CPU tensors), and tensors the op had to copy
# into NHWC-contiguous memory before a launch
PLAIN = OpCounter()
COPIES = OpCounter()


def cost(name, n, h, w, c, dtype):
    """(flops, bytes, tf32_passes) of one launch of `name` (pool2_fwd or
    pool2_bwd) at an (n,h,w,c) input: the forward's three compares per
    output and the backward's five operations, each input read once, each
    output written once."""
    es = itemsize(dtype)
    if name == "pool2_fwd":
        return (3.0 * n * (h // 2) * (w // 2) * c, es * n * h * w * c * 5 // 4,
                0)
    return 5.0 * n * (h // 2) * (w // 2) * c, es * n * h * w * c * 9 // 4, 0


def _pick_th(h, w, c):
    """Row-block height of the TPU kernel (pool2.py:43-55).  The CUDA kernels
    have no blocks; the term stays in `supported` so both packages route the
    same shapes."""
    for t in (16, 8, 4, 2, 1):
        if (h // 2) % t == 0 and t * w * c <= 131072:
            return t
    return 0


def supported(x_shape):
    """Shape rule of the kernels' regime: terrain_tpu's guard
    (pool2.py:58-70) without its backend test."""
    if len(x_shape) != 4:
        return False
    n, h, w, c = x_shape
    return (h % 2 == 0 and w % 2 == 0 and (w // 2) % 8 == 0
            and c % 8 == 0 and c <= 512
            and _pick_th(h, w, c) != 0 and h >= 8)


def _window(x):
    """The four elements of every window, fp32: a0 b0 / a1 b1."""
    xf = x.float()
    return (xf[:, 0::2, 0::2], xf[:, 0::2, 1::2],
            xf[:, 1::2, 0::2], xf[:, 1::2, 1::2])


def pool2_fwd_plain(x):
    """x (N,H,W,C) -> (N,H/2,W/2,C) in x.dtype."""
    a0, b0, a1, b1 = _window(x)
    y = torch.maximum(torch.maximum(a0, b0), torch.maximum(a1, b1))
    return y.to(x.dtype).contiguous()


def pool2_bwd_plain(x, g):
    """dx (N,H,W,C) in x.dtype: g at each window's first maximum, 0
    elsewhere."""
    a0, b0, a1, b1 = _window(x)
    hm = torch.maximum(a0, b0) >= torch.maximum(a1, b1)
    gf = g.float()
    zero = torch.zeros_like(gf)
    de, do = torch.where(hm, gf, zero), torch.where(hm, zero, gf)
    we, wo = a0 >= b0, a1 >= b1
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dx[:, 0::2, 0::2] = torch.where(we, de, zero).to(x.dtype)
    dx[:, 0::2, 1::2] = torch.where(we, zero, de).to(x.dtype)
    dx[:, 1::2, 0::2] = torch.where(wo, do, zero).to(x.dtype)
    dx[:, 1::2, 1::2] = torch.where(wo, zero, do).to(x.dtype)
    return dx


def _check(name, x, g=None):
    if x.dtype not in _DTYPES or (g is not None and g.dtype != x.dtype):
        raise TypeError(f"{name}: dtypes {x.dtype}"
                        + (f", {g.dtype}" if g is not None else ""))
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}")
    n, h, w, c = x.shape
    ok = h % 2 == 0 and w % 2 == 0 and c % 4 == 0 and min(n, h, w, c) > 0
    if g is not None:
        ok = ok and tuple(g.shape) == (n, h // 2, w // 2, c)
    if not ok:
        raise ValueError(f"{name}: shapes {tuple(x.shape)}"
                         + (f", {tuple(g.shape)}" if g is not None else ""))
    return n, h, w, c


def pool2_fwd(x):
    """Forward primitive (not differentiable: use `max_pool2`)."""
    if all_on_cpu("pool2", x):
        PLAIN.calls += 1
        return pool2_fwd_plain(x)
    n, h, w, c = _check("pool2", x)
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    KERNEL_FWD.launch(x.data_ptr(), y.data_ptr(), n, h, w, c,
                      _DTYPES[x.dtype], stream_of(x), outputs=(y,),
                      shape=(n, h, w, c, x.dtype))
    return y


def pool2_bwd(x, g):
    """Backward primitive: dx from the saved input and the cotangent."""
    if all_on_cpu("pool2_bwd", x, g):
        PLAIN.calls += 1
        return pool2_bwd_plain(x, g)
    n, h, w, c = _check("pool2_bwd", x, g)
    dx = torch.empty_like(x)
    KERNEL_BWD.launch(x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, h, w, c,
                      _DTYPES[x.dtype], stream_of(x), outputs=(dx,),
                      shape=(n, h, w, c, x.dtype))
    return dx


class Pool2Fn(torch.autograd.Function):
    """max_pool2 with its backward kernel (terrain_tpu's custom_vjp,
    pool2.py:144-159).  Saves x only."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pool2_bwd(x, nhwc_contiguous(g.to(x.dtype), COPIES))


def max_pool2(x):
    """2x2 s2 max pool of x (N,H,W,C), differentiable: the kernels for CUDA
    tensors, their plain versions for CPU tensors, through one
    `autograd.Function` either way.  Callers check `supported`."""
    return Pool2Fn.apply(nhwc_contiguous(x, COPIES))

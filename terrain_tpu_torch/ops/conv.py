"""Convolution ops on NHWC activations (terrain_tpu/ops/conv.py).

Weights use PyTorch's layouts: conv (O, I, kh, kw); transposed conv
(I, O, kh, kw), already spatially flipped so that `F.conv_transpose2d`
computes what terrain_tpu's `lax.conv_transpose` does (models/convert.py
does the flip); dense (dout, din).

Padding is explicit and symmetric, (k-1)//2 for 'same', as Lasagne pads
even for strided convs -- never F.conv2d's string 'same', which differs
from it for stride 2.  Plain convolutions go to `F.conv2d` on a
channels-last NCHW view of the NHWC tensor.  Two regimes go to hand-written
kernels instead, tried in terrain_tpu's order (ops/conv.py:98-102): the
one-channel 5x5 s1 stem conv (ops/kernels/conv_stem.py, with the LeakyReLU
fused through `conv2d_leaky`), then thin-cout 3x3 s1 convs
(ops/kernels/conv_thin.py).  The dispatch is a pure shape rule.
"""

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.activations import leaky_relu
from terrain_tpu_torch.ops.kernels import conv_stem as _cs
from terrain_tpu_torch.ops.kernels import conv_thin as _ct


def _to_pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _try_stem(x, w, b, s, padding, cd, slope=None):
    """The stem kernel in its regime (bias and activation included), else
    None.  x and w go in the compute dtype, the bias in fp32, unrounded."""
    cout, cin, kh, kw = w.shape
    if not _cs.supported(tuple(x.shape), (kh, kw, cin, cout), s, padding):
        return None
    bb = b.float() if b is not None else torch.zeros(cout, device=x.device)
    return _cs.conv_stem(x.to(cd).contiguous(),
                         w.to(cd).permute(2, 3, 1, 0).contiguous(),
                         bb.contiguous(), slope)


def conv2d(x, w, b=None, *, stride=1, padding="same", compute_dtype=None):
    """2D cross-correlation, NHWC x OIHW -> NHWC; padding 'same'
    (symmetric (k-1)//2) or 'valid'."""
    cout, cin, kh, kw = w.shape
    s = _to_pair(stride)
    cd = compute_dtype or x.dtype
    out = _try_stem(x, w, b, s, padding, cd)
    if out is not None:
        return out
    if _ct.supported(tuple(x.shape), (kh, kw, cin, cout), s, padding):
        out = _ct.conv_thin(x.to(cd).contiguous(),
                            w.to(cd).permute(2, 3, 1, 0).contiguous())
    else:
        if padding == "same":
            pad = ((kh - 1) // 2, (kw - 1) // 2)
        elif padding == "valid":
            pad = (0, 0)
        else:
            raise ValueError(f"padding must be 'same' or 'valid': {padding!r}")
        out = _nhwc(F.conv2d(_nchw(x.to(cd)), w.to(cd), stride=s,
                             padding=pad))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def conv2d_leaky(x, w, b=None, *, slope=0.2, stride=1, padding="same",
                 compute_dtype=None):
    """conv2d followed by LeakyReLU(slope): in the stem regime one kernel
    with the activation as its epilogue (terrain_tpu ops/conv.py:124-145),
    else leaky_relu(conv2d(...))."""
    out = _try_stem(x, w, b, _to_pair(stride), padding,
                    compute_dtype or x.dtype, slope=slope)
    if out is not None:
        return out
    return leaky_relu(conv2d(x, w, b, stride=stride, padding=padding,
                             compute_dtype=compute_dtype), slope)


def conv2d_transpose(x, w, b=None, *, stride=2, compute_dtype=None):
    """Transposed conv, VALID, crop 0: output (in-1)*stride + k, as
    lasagne Deconv2DLayer.  w is (I, O, kh, kw), spatially flipped.  The
    k=2 s=2 case (every U-Net decoder deconv) is the exact matmul +
    depth-to-space of ops/fused.deconv2x2."""
    s = _to_pair(stride)
    if tuple(w.shape[2:]) == (2, 2) and s == (2, 2):
        from terrain_tpu_torch.ops.fused import deconv2x2

        return deconv2x2(x, w, b, compute_dtype=compute_dtype)
    cd = compute_dtype or x.dtype
    out = _nhwc(F.conv_transpose2d(_nchw(x.to(cd)), w.to(cd), stride=s))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def dense(x, w, b=None, *, compute_dtype=None):
    """Fully connected layer, x (N, din), w (dout, din)."""
    cd = compute_dtype or x.dtype
    out = F.linear(x.to(cd), w.to(cd))
    if b is not None:
        out = out + b.to(out.dtype)
    return out

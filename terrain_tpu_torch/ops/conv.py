"""Convolution ops on NHWC activations (terrain_tpu/ops/conv.py).

Weights use PyTorch's layouts: conv (O, I, kh, kw); transposed conv
(I, O, kh, kw), already spatially flipped so that `F.conv_transpose2d`
computes what terrain_tpu's `lax.conv_transpose` does (models/convert.py
does the flip); dense (dout, din).

Padding is explicit and symmetric, (k-1)//2 for 'same', as Lasagne pads
even for strided convs -- never F.conv2d's string 'same', which differs
from it for stride 2.  Plain convolutions go to `F.conv2d` on a
channels-last NCHW view of the NHWC tensor.  Three regimes go to
hand-written kernels instead, tried in terrain_tpu's order
(ops/conv.py:98-102): the one-channel 5x5 s1 stem conv
(ops/kernels/conv_stem.py, with the LeakyReLU fused through `conv2d_leaky`),
then small-cin 3x3 s2 first-layer convs (ops/kernels/conv_s2.py, LeakyReLU
fused likewise), then thin-cout 3x3 s1 convs (ops/kernels/conv_thin.py).
Stem and thin are on by default and conv_s2 is opt-in, by terrain_tpu's own
switches, read at call time (ops/conv.py:25-29,46-49,65-69):
TERRAIN_PALLAS_STEM=0 and TERRAIN_PALLAS_THIN=0 turn one kernel off,
TERRAIN_PALLAS_CONVS2=1 turns conv_s2 on, and the master switch
TERRAIN_PALLAS_CONV=0 turns every conv kernel off (the fused decoder's too,
ops/fused.py), and TERRAIN_STEM_ACT=0 keeps the LeakyReLU out of the
kernels' epilogues.  Off, the library conv runs; on, a CUDA tensor in the
regime launches the kernel or raises, a CPU tensor runs its plain version.

One library regime has a weight gradient of its own: the 5x5 stride-1
'same' convs with cin >= 64 in fp32 (the DCGAN discriminator's hidden
layers) run `Conv5x5`, whose forward and dX are cuDNN's and whose dW is
`conv5x5_dw`, tap-shifted matrix products (one a kernel row) over fixed
blocks of the N*H*W rows, summed in a fixed order.  cuDNN's own fp32 dW
of these convs (its Winograd, at 64-256²) is 8e-3 to 4e-2 off fp64
relative to its largest entry on an H100, its deterministic and default
algorithms alike, where the JAX package's fp32 is within a few 1e-6.
The same code runs on the CPU.

On a slab of image rows (spatial parallelism, parallel/spatial.on_slab
runs a 'same' conv on the slab with its halo of neighbours' rows) the
route is the one the whole image takes: the kernels' regimes are read on
the whole image's shape (`route_shape`), so a slab launches the kernel
exactly where one process does: the stem and conv_s2 on the
discriminators' first layers, conv_thin on the DCGAN generator's output
conv, whose kernels take any height (their tiles are bounds-checked;
chip_smoke.py holds them at the slabs' heights), and `Conv5x5` on the
DCGAN discriminator's hidden layers, whose dW then sums its fixed blocks
over the slab with its halo.
"""

import os

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.activations import leaky_relu
from terrain_tpu_torch.ops.kernels import conv_s2 as _c2
from terrain_tpu_torch.ops.kernels import conv_stem as _cs
from terrain_tpu_torch.ops.kernels import conv_thin as _ct


def _to_pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv_kernel_on(switch):
    """A default-on conv kernel's switch: off when `switch`=0 or the master
    switch TERRAIN_PALLAS_CONV=0 is set."""
    return (os.environ.get("TERRAIN_PALLAS_CONV", "1") != "0"
            and os.environ.get(switch, "1") != "0")


def _try_stem(x, w, b, s, padding, cd, slope=None, shape=None):
    """The stem kernel, unless switched off, in its regime (read on
    `shape`, default x's; bias and activation included), else None.  x and
    w go in the compute dtype, the bias in fp32, unrounded."""
    cout, cin, kh, kw = w.shape
    if not conv_kernel_on("TERRAIN_PALLAS_STEM"):
        return None
    if not _cs.supported(shape or tuple(x.shape), (kh, kw, cin, cout), s,
                         padding):
        return None
    bb = b.float() if b is not None else torch.zeros(cout, device=x.device)
    return _cs.conv_stem(x.to(cd).contiguous(),
                         w.to(cd).permute(2, 3, 1, 0).contiguous(),
                         bb.contiguous(), slope)


def _try_s2(x, w, b, s, padding, cd, slope=None, shape=None):
    """The conv_s2 kernel when switched on and in its regime (read on
    `shape`, default x's; bias and activation included), else None."""
    if (os.environ.get("TERRAIN_PALLAS_CONVS2", "0") != "1"
            or os.environ.get("TERRAIN_PALLAS_CONV", "1") == "0"):
        return None
    cout, cin, kh, kw = w.shape
    if not _c2.supported(shape or tuple(x.shape), (kh, kw, cin, cout), s,
                         padding):
        return None
    bb = b.float() if b is not None else torch.zeros(cout, device=x.device)
    return _c2.conv_s2(x.to(cd), w.to(cd).permute(2, 3, 1, 0).contiguous(),
                       bb.contiguous(), slope)


# conv5x5_dw: rows of N*H*W summed by one product, at most
DW_BLOCK = 4096


def _conv5x5_regime(x, w, s, padding, cd):
    cout, cin, kh, kw = w.shape
    return (cd == torch.float32 and (kh, kw) == (5, 5) and s == (1, 1)
            and padding == "same" and cin >= 64)


def conv5x5_dw(x, g, block=DW_BLOCK):
    """dW (cout, cin, 5, 5) of the 5x5 stride-1 'same' conv of x
    (N, cin, H, W) under the cotangent g (N, cout, H, W), both any layout,
    in fp32.

    x is padded to (H+4, W+4) and each image flattened to L = (H+4)(W+4)
    rows of cin; g is put at the top left of the same grid, zeros around
    it.  Tap (i, j) then pairs g's row q with x's row q + i(W+4) + j of
    the same image, so the five taps of kernel row i are one product of
    g's rows with x's five row ranges shifted by i(W+4) + 0..4, copied side
    by side (5 cin columns).  Each image takes a whole number of blocks of
    equal length, at most `block` rows (zeros at its end); every block is
    one product (cuBLAS, or the CPU's matmul), whose partial sums are
    added over the blocks in one fixed-order sum."""
    n, cin, h, w = x.shape
    cout = g.shape[1]
    q = w + 4
    L = (h + 4) * q
    rows = -(-L // -(-L // block) // 64) * 64  # blocks of equal length
    per = -(-L // rows) * rows                  # an image's rows
    reach = 4 * q + 4                           # the largest tap offset
    xb = x.new_zeros((n * per + reach, cin), dtype=torch.float32)
    xb[:n * per].view(n, per, cin)[:, :L].view(n, h + 4, q, cin)[
        :, 2:h + 2, 2:w + 2] = x.permute(0, 2, 3, 1)
    gb = g.new_zeros((n * per, cout), dtype=torch.float32)
    gb.view(n, per, cout)[:, :L].view(n, h + 4, q, cout)[:, :h, :w] = \
        g.permute(0, 2, 3, 1)
    gs = gb.view(-1, rows, cout)
    nb = gs.shape[0]
    parts = x.new_empty((5, nb, 5 * cin, cout), dtype=torch.float32)
    for i in range(5):
        xs = torch.stack([xb[i * q + j:i * q + j + n * per]
                          for j in range(5)], 1)
        torch.bmm(xs.view(nb, rows, 5 * cin).transpose(1, 2), gs,
                  out=parts[i])
    return parts.sum(1).view(5, 5, cin, cout).permute(3, 2, 0, 1) \
        .contiguous()


class Conv5x5(torch.autograd.Function):
    """F.conv2d of a 5x5 stride-1 'same' fp32 conv, x (N, cin, H, W), w
    (cout, cin, 5, 5), no bias: the forward and dX are cuDNN's (the
    library's on the CPU), dW is `conv5x5_dw`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1), (2, 2), (1, 1), False, (0, 0), 1,
                (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            dw = conv5x5_dw(x, g)
        return dx, dw


def conv2d(x, w, b=None, *, stride=1, padding="same", compute_dtype=None,
           route_shape=None):
    """2D cross-correlation, NHWC x OIHW -> NHWC; padding 'same'
    (symmetric (k-1)//2) or 'valid'.  `route_shape`: the shape whose
    regime picks the route (default x's; a slab's whole image)."""
    cout, cin, kh, kw = w.shape
    s = _to_pair(stride)
    cd = compute_dtype or x.dtype
    shape = route_shape or tuple(x.shape)
    out = _try_stem(x, w, b, s, padding, cd, shape=shape)
    if out is None:
        out = _try_s2(x, w, b, s, padding, cd, shape=shape)
    if out is not None:
        return out
    if conv_kernel_on("TERRAIN_PALLAS_THIN") and _ct.supported(
            shape, (kh, kw, cin, cout), s, padding):
        out = _ct.conv_thin(x.to(cd).contiguous(),
                            w.to(cd).permute(2, 3, 1, 0).contiguous())
    else:
        if padding == "same":
            pad = ((kh - 1) // 2, (kw - 1) // 2)
        elif padding == "valid":
            pad = (0, 0)
        else:
            raise ValueError(f"padding must be 'same' or 'valid': {padding!r}")
        if _conv5x5_regime(x, w, s, padding, cd):
            out = _nhwc(Conv5x5.apply(_nchw(x.to(cd)), w.to(cd)))
        else:
            out = _nhwc(F.conv2d(_nchw(x.to(cd)), w.to(cd), stride=s,
                                 padding=pad))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def conv2d_leaky(x, w, b=None, *, slope=0.2, stride=1, padding="same",
                 compute_dtype=None, route_shape=None):
    """conv2d followed by LeakyReLU(slope): in the stem regime, and in
    conv_s2's when that is switched on, one kernel with the activation as its
    epilogue (terrain_tpu ops/conv.py:124-145), else leaky_relu(conv2d(...)).
    TERRAIN_STEM_ACT=0 opts out of the fusion, as in terrain_tpu: the
    kernels then run without the epilogue and the activation after them.
    `route_shape` as conv2d's."""
    if os.environ.get("TERRAIN_STEM_ACT", "1") != "0":
        s, cd = _to_pair(stride), compute_dtype or x.dtype
        out = _try_stem(x, w, b, s, padding, cd, slope=slope,
                        shape=route_shape)
        if out is None:
            out = _try_s2(x, w, b, s, padding, cd, slope=slope,
                          shape=route_shape)
        if out is not None:
            return out
    return leaky_relu(conv2d(x, w, b, stride=stride, padding=padding,
                             compute_dtype=compute_dtype,
                             route_shape=route_shape), slope)


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

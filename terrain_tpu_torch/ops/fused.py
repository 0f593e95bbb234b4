"""Exact fused upsample+conv ops (terrain_tpu/ops/fused.py).

1. upsample2x_nearest_conv: repeat-upscale x2 followed by an odd-k 'same'
   conv is ONE low-resolution conv with 4x output channels (the per-phase
   kernels, built in fp32 from the grouping matrix G) and a depth-to-space.
   For output q = 2i+phi, tap k' reads the repeated input at
   i + floor((phi+k')/2), so summing taps grouped by that offset is exact.
   On a slab of image rows (parallel/spatial.on_slab: the slab with one
   low-resolution halo row on each side) the low-resolution conv is routed
   on the whole image's shape (`route_shape`), so the DCGAN generator's
   output conv takes the conv_thin kernel exactly where one process does.
2. deconv2x2: the k=2 s=2 transposed conv writes non-overlapping 2x2
   blocks -- a matmul with 4x output channels and a depth-to-space.
3. bilinear2x_conv3x3: bilinear x2 then 3x3 'same' conv; in the kernel's
   regime it is the fused bilinear_conv kernel (ops/kernels), elsewhere, or
   with TERRAIN_PALLAS_DECODER=0 or TERRAIN_PALLAS_CONV=0, the composite.
   On a slab of image rows (parallel/spatial.on_slab: the slab with one
   halo row on each side) the choice is made on the whole image's shape
   (`route_shape`), so a slab takes the kernel exactly where one process
   does (the kernel has no row-tile rule of its own: its tiles are
   bounds-checked, so a slab of any height launches; chip_smoke.py holds
   it at the slabs' heights).
4. bilinear2x_conv: bilinear x2 then a k x k 'same' conv, unfused, as the
   DCGAN generator with bilinear_upsample takes them
   (terrain_tpu/models/dcgan.py:109-119): one op only so that a slab of
   image rows can take the halo both reads need (parallel/spatial.on_slab:
   two low-resolution rows on each side for k = 5), the upsample and the
   conv each routed on the whole image's shape.
Each op names `upsample_taps`, the low-resolution rows an upsampled row
reads (2 bilinear, 1 nearest), from which parallel/spatial.upsample_halo
counts a slab's halo.
"""

from functools import lru_cache

import numpy as np
import torch

from terrain_tpu_torch.ops.conv import conv2d, conv_kernel_on
from terrain_tpu_torch.ops.kernels import bilinear_conv as _bc
from terrain_tpu_torch.ops.resize import upsample_bilinear_2x

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_NEAREST_BWD": "an exact reformulation of upsample2x_nearest_"
                           "conv's dX as one stride-2 conv, an XLA A/B knob; "
                           "autograd's conv gradient gives the same values",
    "TERRAIN_DECONV_BWD": "an exact reformulation of deconv2x2's dX as a "
                          "stride-2 2x2 conv, an XLA A/B knob; autograd's "
                          "matmul gradient gives the same values",
}


@lru_cache(maxsize=None)
def _phase_grouping(k):
    """G[phi, k_idx, d_idx] = 1 iff floor((phi + k')/2) == d, k' = k_idx - p.
    Returns (G, n_taps) with a common d range across both phases."""
    if k % 2 != 1:
        raise ValueError("phase decomposition requires an odd kernel size")
    p = (k - 1) // 2
    dmin = -((p + 1) // 2)
    dmax = (1 + p) // 2
    n_taps = dmax - dmin + 1
    G = np.zeros((2, k, n_taps), np.float32)
    for phi in range(2):
        for ki in range(k):
            G[phi, ki, (phi + ki - p) // 2 - dmin] = 1.0
    return G, n_taps


@lru_cache(maxsize=None)
def _grouping_on(k, device):
    """G of `_phase_grouping` as a tensor on `device`, made once: a copy
    from the host inside a train step would wait for the device, which a
    CUDA graph capture refuses."""
    return torch.from_numpy(_phase_grouping(k)[0]).to(device)


def _depth_to_space2(y, cout):
    """(N,H,W,(2,2,cout)) -> (N,2H,2W,cout)."""
    n, h, w = y.shape[0], y.shape[1], y.shape[2]
    y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, cout)


def upsample2x_nearest_conv(x, w, b=None, *, compute_dtype=None,
                            route_shape=None):
    """Exactly conv2d(upsample_nearest_2x(x), w, 'same', stride 1).

    x (N,H,W,cin); w (cout,cin,k,k), k odd.  Output (N,2H,2W,cout); the
    bias is added after the depth-to-space.  `route_shape`: the input
    shape whose regime picks the low-resolution conv's route (default
    x's; a slab's whole image)."""
    cd = compute_dtype or x.dtype
    cout, cin, k, _ = w.shape
    n_taps = _phase_grouping(k)[1]
    g = _grouping_on(k, w.device)
    # K[(p,q,o), i, a, b] = sum_{h,w} w[o,i,h,w] G[p,h,a] G[q,w,b]
    K = torch.einsum("oihw,pha,qwb->pqoiab", w.float(), g, g)
    K = K.reshape(4 * cout, cin, n_taps, n_taps).to(cd)
    y = _depth_to_space2(conv2d(x, K, stride=1, padding="same",
                                compute_dtype=cd, route_shape=route_shape),
                         cout)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def deconv2x2(x, w, b=None, *, compute_dtype=None):
    """Exactly conv2d_transpose(x, w, stride=2) for k=2.  w is (I,O,2,2),
    spatially flipped (ops/conv.py)."""
    cd = compute_dtype or x.dtype
    cin, cout = w.shape[0], w.shape[1]
    wm = w.permute(0, 2, 3, 1).reshape(cin, 4 * cout).to(cd)
    y = _depth_to_space2(torch.matmul(x.to(cd), wm), cout)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def bilinear2x_conv3x3(x, w, b=None, *, compute_dtype=None,
                       route_shape=None):
    """Bilinear x2 upsample then 3x3 'same' conv (the U-Net decoder's
    bilinear stage).  w (cout,cin,3,3).  In the bilinear_conv regime, unless
    switched off, this is the fused kernel (all arithmetic in fp32, output
    in the compute dtype); otherwise the unfused composite runs, whose
    upsample is ops/resize.upsample_bilinear_2x.  `route_shape`: the
    shape whose regime picks the route (default x's; a slab's whole
    image)."""
    cd = compute_dtype or x.dtype
    cout, cin = w.shape[0], w.shape[1]
    shape = route_shape or tuple(x.shape)
    # terrain_tpu's TERRAIN_PALLAS_DECODER switch (ops/fused.py:168-182)
    if conv_kernel_on("TERRAIN_PALLAS_DECODER") and _bc.supported(
            shape, (3, 3, cin, cout)):
        bb = b if b is not None else torch.zeros(cout, device=x.device)
        return _bc.bilinear_conv(
            x.to(cd).contiguous(), w.to(cd).permute(2, 3, 1, 0).contiguous(),
            bb.float().contiguous())
    n, h, wd, c = shape
    return conv2d(upsample_bilinear_2x(x, route_shape=shape), w, b, stride=1,
                  padding="same", compute_dtype=cd,
                  route_shape=(n, 2 * h, 2 * wd, c))


def bilinear2x_conv(x, w, b=None, *, compute_dtype=None, route_shape=None):
    """conv2d(upsample_bilinear_2x(x), w, 'same', stride 1), w (cout, cin,
    k, k).  `route_shape`: the input shape whose regime picks both
    routes (default x's; a slab's whole image)."""
    n, h, wd, c = route_shape or tuple(x.shape)
    return conv2d(upsample_bilinear_2x(x, route_shape=(n, h, wd, c)), w, b,
                  stride=1, padding="same",
                  compute_dtype=compute_dtype or x.dtype,
                  route_shape=(n, 2 * h, 2 * wd, c))


upsample2x_nearest_conv.upsample_taps = 1
bilinear2x_conv3x3.upsample_taps = 2
bilinear2x_conv.upsample_taps = 2

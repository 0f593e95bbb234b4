"""jax.image.resize(x, shape, method="bilinear") without JAX: the
antialiased resize that tools/compare_published.py brings sample sets to
one scale with, before the SWD pyramid (eval/swd.py) and the terrain W1
(eval/terrain.py) compare them.

Along each axis whose size changes, one weight matrix (jax's
compute_weight_mat): a triangle filter centred on each output sample,
widened by 1/scale when the axis shrinks (so a downscale low-passes), its
weights normalised to sum to one, all in fp32 as jax computes them.  The
image is contracted with the height's matrix, then the width's.
"""

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def resize_weights(in_size, out_size, device=None):
    """(in_size, out_size) fp32 weights of one axis: column j holds the
    input samples' shares of output sample j."""
    f32 = torch.float32
    inv = 1.0 / (out_size / in_size)
    sample = ((torch.arange(out_size, dtype=f32) + 0.5)
              * torch.tensor(inv, dtype=f32) - 0.5)
    width = torch.tensor(max(inv, 1.0), dtype=f32)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    w = torch.clamp(1 - (x / width).abs(), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_bilinear(x, height, width):
    """(N, H, W, C) -> (N, height, width, C), fp32, where x is."""
    x = x.float()
    n, h, w, c = x.shape
    # the projections are fp32 products, never TF32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if h != height:
            x = torch.einsum("nhwc,hH->nHwc", x,
                             resize_weights(h, height, x.device))
        if w != width:
            x = torch.einsum("nhwc,wW->nhWc", x,
                             resize_weights(w, width, x.device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return x.contiguous()

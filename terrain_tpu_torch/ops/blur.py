"""Fixed-kernel Gaussian blur, NHWC, separable and depthwise
(terrain_tpu/ops/blur.py): two depthwise 1-D convs with symmetric 'same'
zero padding and fp32 taps generated from sigma, computed in fp32 and
returned in the input dtype."""

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize, sigma):
    """Normalized 1-D Gaussian taps, fp32."""
    if ksize % 2 != 1:
        raise ValueError("kernel size must be odd")
    r = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x, sigma=1.0, ksize=None):
    """Blur (N, H, W, C) with a separable Gaussian, per channel: along H
    first, then along W, as terrain_tpu."""
    if ksize is None:
        ksize = int(2 * np.ceil(3 * sigma) + 1)
    c = x.shape[-1]
    pad = (ksize - 1) // 2
    k = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).to(x.device)
    xf = x.float().permute(0, 3, 1, 2)
    out = F.conv2d(xf, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1),
                   padding=(pad, 0), groups=c)
    out = F.conv2d(out, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize),
                   padding=(0, pad), groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype)

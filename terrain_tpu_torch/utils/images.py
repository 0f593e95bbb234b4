"""Image post-processing and PNG writing (terrain_tpu/utils/images.py), on
the port's own PNG codec (serve/png.py).

Grayscale lives in [0,1] (sigmoid, x/255), color in [-1,1] (tanh,
(x-127.5)/127.5); `convert_to_rgb` maps both to [0,1] RGB.
"""

import os

import numpy as np
import torch

from terrain_tpu_torch.serve.png import encode_png


def convert_to_rgb(img, is_grayscale=False):
    """(H, W, C) float -> (H, W, 3) float in [0, 1]."""
    img = np.asarray(img)
    if img.ndim != 3:
        raise ValueError(f"image must be HWC, got shape {img.shape}")
    ch = img.shape[-1]
    if ch not in (1, 3):
        raise ValueError(f"unsupported channel count {ch}, must be 1 or 3")
    out = np.repeat(img, 3, axis=-1) if ch == 1 else img
    if not is_grayscale:
        out = (out * 127.5 + 127.5) / 255.0
    return np.clip(out, 0.0, 1.0)


def save_png(path, img01):
    """Save a float [0,1] (H, W, 1|3) image as PNG."""
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    save_png_u8(path, arr)


def to_u8(x, is_grayscale, scale=1):
    """Quantize a float image batch (N,H,W,C) to uint8 on its device, before
    it is fetched: color maps [-1,1] -> [0,1] via (x+1)/2, then
    floor(v*255 + 0.5) clipped to [0,255] -- the same bytes as
    convert_to_rgb -> save_png.  scale > 1 box-averages scale x scale blocks
    first (a preview, TERRAIN_ARTIFACT_SCALE); no-op unless both spatial
    dims divide by it."""
    x = torch.as_tensor(x).float()
    s = int(scale)
    if s > 1 and x.ndim == 4 and x.shape[1] % s == 0 and x.shape[2] % s == 0:
        n, h, w, c = x.shape
        x = x.reshape(n, h // s, s, w // s, s, c).mean(dim=(2, 4))
    if not is_grayscale:
        x = x * 0.5 + 0.5
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0, 255).to(torch.uint8)


def save_png_u8(path, img_u8):
    """Save a uint8 (H, W, 1|3) image (from `to_u8`) as PNG; one channel is
    written as a grayscale PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img_u8)))


def write_image_grid(filepath, imgs, pad=2):
    """(n, m, H, W, 3) float [0,1] images -> one PNG of n rows and m columns
    with `pad` white pixels between cells."""
    imgs = np.asarray(imgs, np.float32)
    n, m, h, w, c = imgs.shape
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    grid = np.ones((n * h + (n - 1) * pad, m * w + (m - 1) * pad, c),
                   np.float32)
    for i in range(n):
        for j in range(m):
            grid[i * (h + pad):i * (h + pad) + h,
                 j * (w + pad):j * (w + pad) + w] = imgs[i, j]
    save_png(filepath, grid)

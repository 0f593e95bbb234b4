"""The host helpers of the raster crop path
(terrain_tpu/data/native.py:94-141), in numpy.

terrain_tpu runs them in a C++ library (terrain_tpu/native/terrain_io.cpp)
with numpy fallbacks.  They are host work of a few crops a batch, so numpy
is the implementation here, written to give the library's bytes: the
library computes in float32 (x * (1/255), x * (1/127.5) - 1, zeros / size),
which differs in the last bit from numpy's float64 forms of the same
formulas.
"""

import numpy as np

_K_GRAY = np.float32(1.0) / np.float32(255.0)
_K_COLOR = np.float32(1.0) / np.float32(127.5)
# every uint8 value's float32 image, computed as the library computes it
_LUT_GRAY = np.arange(256, dtype=np.float32) * _K_GRAY
_LUT_COLOR = np.arange(256, dtype=np.float32) * _K_COLOR - np.float32(1.0)


def crop_batch_u8(src, ys, xs, crop):
    """Gather windows: src (H, W, C) or (H, W) uint8, ys/xs (n,) top-left
    corners -> (n, crop, crop, C).  A window that leaves the raster
    raises ValueError."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim == 2:
        src = src[:, :, None]
    h, w, c = src.shape
    ys = np.asarray(ys, dtype=np.int64).reshape(-1)
    xs = np.asarray(xs, dtype=np.int64).reshape(-1)
    if ys.shape != xs.shape:
        raise ValueError(f"{ys.shape[0]} rows but {xs.shape[0]} columns")
    bad = (ys < 0) | (ys > h - crop) | (xs < 0) | (xs > w - crop)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"window {i} at ({ys[i]}, {xs[i]}) of size {crop} leaves the "
            f"{h}x{w} raster")
    out = np.empty((ys.shape[0], crop, crop, c), np.uint8)
    for i, (y, x) in enumerate(zip(ys, xs)):
        out[i] = src[y:y + crop, x:x + crop]
    return out


def normalize_u8_f32(src, gray):
    """uint8 -> float32: x/255 (gray) or x/127.5 - 1 (color), in the
    library's float32 arithmetic."""
    src = np.asarray(src, dtype=np.uint8)
    return (_LUT_GRAY if gray else _LUT_COLOR)[src]


def zero_fraction(crops):
    """Per-crop fraction of zero bytes; crops (n, ...) uint8 -> (n,)
    float32."""
    crops = np.asarray(crops, dtype=np.uint8)
    n = crops.shape[0]
    size = crops.size // max(n, 1)
    zeros = np.count_nonzero(crops.reshape(n, -1) == 0, axis=1)
    return zeros.astype(np.float32) / np.float32(size)

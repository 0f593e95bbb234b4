"""Synthetic terrain-like paired data for tests and smoke runs
(terrain_tpu/data/synthetic.py; numpy only, the same bytes for equal seeds).

Heightmaps are band-limited random fields; textures are a hue ramp over
height plus noise, so A->B has learnable structure.  Layout as the reference
h5: uint8, NHWC, keys xt/yt/xv/yv.
"""

import numpy as np


def _upsample_bilinear(low, size):
    """(n, k, k) -> (n, size, size), separable bilinear."""
    k = low.shape[1]
    idx = np.linspace(0, k - 1, size).astype(np.float32)
    i0 = np.floor(idx).astype(int)
    i1 = np.minimum(i0 + 1, k - 1)
    f = idx - i0
    rows = low[:, i0, :] * (1 - f)[None, :, None] + low[:, i1, :] * f[None, :, None]
    return rows[:, :, i0] * (1 - f)[None, None, :] + rows[:, :, i1] * f[None, None, :]


def make_heightmaps(n, size, rnd):
    """Fractal (multi-octave, ~1/f) random terrain in [0, 255] uint8,
    (n, size, size, 1): octaves at k = 2, 4, ..., size/8, the amplitude
    falling by 0.55 per octave, each image normalized to the full range."""
    acc = np.zeros((n, size, size), np.float32)
    amp = 1.0
    k = 2
    while k <= max(size // 8, 2):
        low = rnd.rand(n, k, k).astype(np.float32) - 0.5
        acc += amp * _upsample_bilinear(low, size)
        amp *= 0.55
        k *= 2
    lo = acc.min(axis=(1, 2), keepdims=True)
    hi = acc.max(axis=(1, 2), keepdims=True)
    full = (acc - lo) / (hi - lo + 1e-8)
    return (full[..., None] * 255).astype(np.uint8)


def texture_from_height(hm_u8, rnd):
    """Colormap over height (low green-ish, high brown/white) plus noise."""
    h = hm_u8.astype(np.float32) / 255.0  # (n, s, s, 1)
    r = 80 + 140 * h
    g = 120 - 40 * h
    b = 60 + 20 * h
    tex = np.concatenate([r, g, b], axis=-1)
    tex = tex + rnd.randn(*tex.shape).astype(np.float32) * 4
    return np.clip(tex, 0, 255).astype(np.uint8)


def make_pairs(n, size, seed=0):
    rnd = np.random.RandomState(seed)
    x = make_heightmaps(n, size, rnd)
    y = texture_from_height(x, rnd)
    return x, y


def write_h5(path, n_train=16, n_valid=4, size=64, seed=0):
    """Write a reference-layout h5 (xt/yt/xv/yv, uint8 NHWC) with data/h5.py's
    writer."""
    from terrain_tpu_torch.data import h5

    xt, yt = make_pairs(n_train, size, seed)
    xv, yv = make_pairs(n_valid, size, seed + 1)
    return h5.write(path, {"xt": xt, "yt": yt, "xv": xv, "yv": yv})

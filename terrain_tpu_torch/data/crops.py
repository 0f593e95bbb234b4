"""On-the-fly raster crops (terrain_tpu/data/crops.py:21-83): the whole
raster pair stays in host memory and each batch is a set of random
windows, rejection-sampled through the ocean filter (a crop whose
heightmap is more than 90% zeros is discarded).

Offsets come from `np.random.RandomState(seed)`, drawn in the same order
as terrain_tpu's, so both packages cut the same crops from the same seed.
The iterator has the Hdf5Iterator interface (`.N`, `next()`), so the
trainer takes it unchanged, behind its prefetcher; `.N` is the nominal
epoch size in crops.
"""

import numpy as np

from terrain_tpu_torch.data import native
from terrain_tpu_torch.data.hdf5 import normalize_pair


class RasterCropIterator:
    """Infinite iterator of random paired crops from one raster pair.

    heightmap: (H, W) or (H, W, 1), cast to uint8 as terrain_tpu casts it
    (a 16-bit raster wraps modulo 256); texture: (H, W, 3) uint8.  Yields
    normalized float32 NHWC (X, Y) batches."""

    def __init__(self, heightmap, texture, bs, crop=512, epoch_size=240,
                 ocean_threshold=0.9, seed=0, is_a_grayscale=True,
                 is_b_grayscale=False, max_tries=64):
        heightmap = np.asarray(heightmap, np.uint8)
        if heightmap.ndim == 2:
            heightmap = heightmap[:, :, None]
        texture = np.asarray(texture, np.uint8)
        if heightmap.shape[:2] != texture.shape[:2]:
            raise ValueError(f"heightmap {heightmap.shape[:2]} and texture "
                             f"{texture.shape[:2]} differ in size")
        if heightmap.shape[0] < crop or heightmap.shape[1] < crop:
            raise ValueError(f"a {heightmap.shape[0]}x{heightmap.shape[1]} "
                             f"raster has no {crop}px window")
        self.hm = heightmap
        self.tex = texture
        self.bs = bs
        self.crop = crop
        self.N = epoch_size
        self.ocean_threshold = ocean_threshold
        self.max_tries = max_tries
        self.is_a_grayscale = is_a_grayscale
        self.is_b_grayscale = is_b_grayscale
        self._rnd = np.random.RandomState(seed)
        self.drawn = 0  # offsets drawn, accepted or not

    def _sample_offsets(self, n):
        h, w = self.hm.shape[0], self.hm.shape[1]
        ys = self._rnd.randint(0, h - self.crop + 1, size=n).astype(np.int64)
        xs = self._rnd.randint(0, w - self.crop + 1, size=n).astype(np.int64)
        self.drawn += n
        return ys, xs

    def next_uint8(self):
        """One batch of accepted crops, uint8: (X (bs,c,c,1), Y (bs,c,c,3))."""
        got_h, got_t = [], []
        need = self.bs
        for _ in range(self.max_tries):
            ys, xs = self._sample_offsets(max(need * 2, 4))
            hms = native.crop_batch_u8(self.hm, ys, xs, self.crop)
            keep = native.zero_fraction(hms) <= self.ocean_threshold
            if keep.any():
                idx = np.nonzero(keep)[0][:need]
                got_h.append(hms[idx])
                got_t.append(native.crop_batch_u8(self.tex, ys[idx], xs[idx],
                                                  self.crop))
                need -= len(idx)
            if need <= 0:
                break
        if need > 0:
            raise RuntimeError(
                f"could not find {self.bs} non-ocean crops in "
                f"{self.max_tries} tries (threshold {self.ocean_threshold})")
        return np.concatenate(got_h), np.concatenate(got_t)

    def __iter__(self):
        return self

    def __next__(self):
        x, y = self.next_uint8()
        return normalize_pair(x, y, self.is_a_grayscale, self.is_b_grayscale)

    next = __next__

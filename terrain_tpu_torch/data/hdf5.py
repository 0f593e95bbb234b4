"""Host-side paired-batch iterator (terrain_tpu/data/hdf5.py; numpy only).

An infinite iterator over paired uint8 arrays: contiguous batch slices whose
order is shuffled each pass by a `np.random.RandomState` (seed 0 by
default), cast to float32, grayscale normalized to [0,1] (x/255) and color
to [-1,1] ((x-127.5)/127.5).  Batches stay NHWC; augmentation is the
trainer's, on the device.  For equal seeds the order is the JAX package's.
"""

import numpy as np


def get_slices(length, bs):
    """Contiguous batch slices, with a ragged tail slice."""
    slices = []
    b = 0
    while b * bs < length:
        slices.append(slice(b * bs, (b + 1) * bs))
        b += 1
    return slices


def normalize_pair(x, y, is_a_grayscale, is_b_grayscale, is_uint8=True):
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if is_uint8:
        x = x / 255.0 if is_a_grayscale else (x - 127.5) / 127.5
        y = y / 255.0 if is_b_grayscale else (y - 127.5) / 127.5
    return x, y


class Hdf5Iterator:
    """Infinite (X, Y) float32 NHWC batch iterator.

    X, y: h5py datasets or numpy arrays of shape (N, H, W, C), uint8 (h5
    datasets are read into host memory once unless `cache=False`).  Exposes
    `.N` (dataset length) and `.next()`.
    """

    def __init__(self, X, y, bs, is_a_grayscale=True, is_b_grayscale=False,
                 is_uint8=True, seed=0, cache=True):
        if X.shape[0] != y.shape[0]:
            raise ValueError(f"unpaired data: {X.shape[0]} vs {y.shape[0]}")
        if cache and not isinstance(X, np.ndarray):
            X = X[:]
            y = y[:]
        self._X, self._y = X, y
        self.N = X.shape[0]
        self.bs = bs
        self.is_a_grayscale = is_a_grayscale
        self.is_b_grayscale = is_b_grayscale
        self.is_uint8 = is_uint8
        self._rnd = np.random.RandomState(seed)
        self._gen = self._iterate()

    def _iterate(self):
        while True:
            slices = get_slices(self.N, self.bs)
            self._rnd.shuffle(slices)
            for sl in slices:
                yield normalize_pair(
                    self._X[sl], self._y[sl],
                    self.is_a_grayscale, self.is_b_grayscale, self.is_uint8)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    next = __next__


def epoch_index_schedule(n, bs, rnd):
    """The slice shuffle as index vectors, for the device-resident path: a
    list of int32 index arrays, one per step of an epoch, in the same
    shuffled-contiguous-slice order as Hdf5Iterator.  Ragged tail slices are
    skipped (the train loop runs N // bs steps anyway)."""
    slices = get_slices(n, bs)
    rnd.shuffle(slices)
    out = []
    for sl in slices:
        idx = np.arange(sl.start, min(sl.stop, n), dtype=np.int32)
        if idx.size == bs:
            out.append(idx)
    return out

"""Device-resident dataset (terrain_tpu/data/device_cache.py).

The shipped training set is small by the card's standards (240 crops x
512^2 x (1+3) bytes = 250 MB), so the whole uint8 dataset lives in device
memory and each train step gathers, normalizes and augments its batch
there.  Per step the host ships one index vector and the latent batch.
"""

import os

import numpy as np
import torch

from terrain_tpu_torch.data.augment import augment_pair
from terrain_tpu_torch.device import resolve_device


class DeviceDataset:
    """Paired uint8 arrays on the device, and `prepare` functions for the
    train step (terrain_tpu_torch.train.step.build_train_step).

    TERRAIN_DEVICE_DATA ("const" or "arg") tells terrain_tpu how the arrays
    reach its compiled step.  There is no compiled program here, so both
    values are accepted and mean the same: `prepare` reads the tensors this
    object holds."""

    def __init__(self, x, y, is_a_grayscale=True, is_b_grayscale=False,
                 device=None, mode=None):
        x = np.ascontiguousarray(x, dtype=np.uint8)
        y = np.ascontiguousarray(y, dtype=np.uint8)
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"unpaired data: {x.shape[0]} vs {y.shape[0]}")
        self.mode = mode or os.environ.get("TERRAIN_DEVICE_DATA", "const")
        if self.mode not in ("const", "arg"):
            raise ValueError(f"TERRAIN_DEVICE_DATA must be const or arg, "
                             f"got {self.mode!r}")
        self.N = x.shape[0]
        self.is_a_grayscale = is_a_grayscale
        self.is_b_grayscale = is_b_grayscale
        self.device = resolve_device(device)
        self.x = torch.from_numpy(x).to(self.device)
        self.y = torch.from_numpy(y).to(self.device)

    def gather_normalize(self, idx):
        """(bs,) integer indices -> (X, Y) float32 NHWC, normalized."""
        idx = torch.as_tensor(idx).to(self.device)
        return gather_normalize(self.x, self.y, idx,
                                self.is_a_grayscale, self.is_b_grayscale)

    def batch_args(self, Z, idx):
        """The train-step batch tuple for this dataset's prepare function."""
        return (Z, idx)

    def make_prepare(self, augment=True, shard=None):
        """Returns prepare(batch, rngs) -> (Z, X, Y) for batch = (Z, idx).
        With `augment`, the pair is transformed with draws from
        rngs["augment"], a `torch.Generator`.  Inside a CUDA graph of steps
        (train/step.py) Z and idx are views of the graph's static buffers;
        prepare neither copies from nor waits on the host, which a capture
        would refuse.

        Data parallelism: the dataset is replicated on every rank's device
        and idx holds this rank's slice of the global batch's indices;
        `shard` = (index, count) places it in the global batch for the
        augmentation's draws (augment_pair)."""

        def prepare(batch, rngs):
            Z, idx = batch
            X, Y = self.gather_normalize(idx)
            if augment:
                X, Y = augment_pair(rngs["augment"], X, Y, shard=shard)
            return Z, X, Y

        return prepare


def gather_normalize(x_u8, y_u8, idx, is_a_grayscale, is_b_grayscale):
    """(N,...) uint8 pair + (bs,) indices -> normalized float32 batch:
    grayscale to [0,1] (x/255), color to [-1,1] ((x-127.5)/127.5)."""
    xs = x_u8.index_select(0, idx).float()
    ys = y_u8.index_select(0, idx).float()
    xs = xs / 255.0 if is_a_grayscale else (xs - 127.5) / 127.5
    ys = ys / 255.0 if is_b_grayscale else (ys - 127.5) / 127.5
    return xs, ys

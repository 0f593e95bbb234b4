"""Data layer: the host-side paired iterator, on-the-fly raster crops, the
device-resident dataset, paired augmentation on the device, and synthetic
pairs."""

from terrain_tpu_torch.data.augment import augment_pair
from terrain_tpu_torch.data.crops import RasterCropIterator
from terrain_tpu_torch.data.device_cache import DeviceDataset
from terrain_tpu_torch.data.hdf5 import (
    Hdf5Iterator, epoch_index_schedule, get_slices, normalize_pair)

__all__ = ["augment_pair", "DeviceDataset", "Hdf5Iterator",
           "RasterCropIterator", "epoch_index_schedule", "get_slices",
           "normalize_pair"]

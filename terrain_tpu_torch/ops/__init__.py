"""Ops on NHWC tensors: the port of terrain_tpu/ops used by the models."""

from terrain_tpu_torch.ops.activations import get_activation, leaky_relu
from terrain_tpu_torch.ops.conv import (
    conv2d, conv2d_leaky, conv2d_transpose, dense)
from terrain_tpu_torch.ops.fused import (
    bilinear2x_conv, bilinear2x_conv3x3, deconv2x2, upsample2x_nearest_conv)
from terrain_tpu_torch.ops.norm import BatchNorm, batch_norm
from terrain_tpu_torch.ops.pool import avg_pool2d, max_pool2d
from terrain_tpu_torch.ops.resize import (
    upsample_bilinear_2x, upsample_nearest_2x)

__all__ = [
    "BatchNorm", "avg_pool2d", "batch_norm", "bilinear2x_conv",
    "bilinear2x_conv3x3", "conv2d",
    "conv2d_leaky", "conv2d_transpose", "deconv2x2", "dense",
    "get_activation", "leaky_relu", "max_pool2d", "upsample2x_nearest_conv", "upsample_bilinear_2x", "upsample_nearest_2x",
]

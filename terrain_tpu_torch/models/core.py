"""Layers with parameters, init and dropout (terrain_tpu/models/core.py).

Each layer module knows its counterpart in terrain_tpu's parameter trees:
`load_jax(params, state)` takes that subtree (numpy arrays, JAX layouts)
and `to_jax()` gives it back, so models/convert.py can walk a whole model
key path for key path.  Initialization draws from an explicit
`torch.Generator` in the same layer order as the JAX `init`; the numbers
differ from JAX's (threefry vs Philox), the distribution does not.
"""

import math

import numpy as np
import torch
from torch import nn

from terrain_tpu_torch.ops.norm import _copy, _np


def glorot_uniform(shape, fan_in, fan_out, generator, gain=1.0):
    """lasagne.init.GlorotUniform: U(-a, a), a = gain*sqrt(6/(fan_in+fan_out))."""
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


class Conv(nn.Module):
    """Conv weights (cout, cin, k, k) + bias; Glorot fans use the receptive
    field, as lasagne.  JAX layout: HWIO."""

    def __init__(self, k, cin, cout, generator):
        super().__init__()
        self.w = nn.Parameter(glorot_uniform(
            (cout, cin, k, k), cin * k * k, cout * k * k, generator))
        self.b = nn.Parameter(torch.zeros(cout))

    def load_jax(self, params, state):
        _copy(self.w, np.transpose(params["w"], (3, 2, 0, 1)))
        _copy(self.b, params["b"])

    def to_jax(self):
        return {"w": _np(self.w.permute(2, 3, 1, 0)), "b": _np(self.b)}, None


class Deconv(nn.Module):
    """Transposed-conv weights (cin, cout, k, k), spatially flipped, so
    `F.conv_transpose2d` equals terrain_tpu's `lax.conv_transpose` with the
    HWIO kernel (unflipped they differ by 4.5-5.2 max-abs)."""

    def __init__(self, k, cin, cout, generator):
        super().__init__()
        # Glorot over the HWIO draw, then the same flip/permute as load_jax
        w = glorot_uniform((k, k, cin, cout), cin * k * k, cout * k * k,
                           generator)
        self.w = nn.Parameter(w.flip(0, 1).permute(2, 3, 0, 1).contiguous())
        self.b = nn.Parameter(torch.zeros(cout))

    def load_jax(self, params, state):
        w = np.flip(np.asarray(params["w"]), (0, 1)).transpose(2, 3, 0, 1)
        _copy(self.w, np.ascontiguousarray(w))
        _copy(self.b, params["b"])

    def to_jax(self):
        w = self.w.permute(2, 3, 0, 1).flip(0, 1)
        return {"w": _np(w), "b": _np(self.b)}, None


class Dense(nn.Module):
    """Dense weights (dout, din) for `F.linear`; JAX layout (din, dout)."""

    def __init__(self, din, dout, generator):
        super().__init__()
        self.w = nn.Parameter(
            glorot_uniform((din, dout), din, dout, generator).t().contiguous())
        self.b = nn.Parameter(torch.zeros(dout))

    def load_jax(self, params, state):
        _copy(self.w, np.ascontiguousarray(np.asarray(params["w"]).T))
        _copy(self.b, params["b"])

    def to_jax(self):
        return {"w": _np(self.w.t()), "b": _np(self.b)}, None


def dropout(x, rate, generator, train):
    """Inverted dropout (lasagne DropoutLayer, rescale=True); the mask is
    drawn from `generator`, on x's device."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def param_count(module):
    """Learnable parameters (BN running statistics excluded), as the JAX
    param_count over the params tree."""
    return sum(p.numel() for p in module.parameters())

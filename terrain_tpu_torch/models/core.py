"""Layers with parameters, init and dropout (terrain_tpu/models/core.py).

Each layer module knows its counterpart in terrain_tpu's parameter trees:
`load_jax(params, state)` takes that subtree (numpy arrays, JAX layouts)
and `to_jax()` gives it back, so models/convert.py can walk a whole model
key path for key path.  Initialization draws from an explicit
`torch.Generator` in the same layer order as the JAX `init`; the numbers
differ from JAX's (threefry vs Philox), the distribution does not.

Tensor parallelism (parallel/tp.py): `Conv`, `Deconv` and `Dense` are
called as `layer(op, x, **kw)`, which is `op(x, w, b, **kw)` for a whole
layer.  A layer sharded on 'model' (`shard` set by parallel/tp.shard_module)
holds only its rank's contiguous slice of the output features, on
`OUT_AXIS` of its weight, and its bias whole; its call gathers the
features over the model group.  `load_jax` takes that slice of the full
terrain_tpu array, and `to_jax` gathers the full one (a collective: every
rank of the model group calls it), so the trees stay full.

Spatial parallelism (parallel/spatial.py): the image-to-image networks give
each layer the whole heights of its input and output (`io_rows`); a layer
of a network whose images are held in slabs of rows (`rows` set by
parallel/spatial.shard_rows) calls its op on the slab or on whole rows as
the rule has them (`spatial.call`).
"""

import math

import numpy as np
import torch
from torch import nn

from terrain_tpu_torch.ops.norm import _copy, _np
from terrain_tpu_torch.parallel import spatial, tp


def glorot_uniform(shape, fan_in, fan_out, generator, gain=1.0):
    """lasagne.init.GlorotUniform: U(-a, a), a = gain*sqrt(6/(fan_in+fan_out))."""
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


class _Layer(nn.Module):
    """A weight whose output features lie on OUT_AXIS (the last axis of
    its terrain_tpu layout, which is the weight's axes in JAX_AXES order),
    a bias, and its place on the model group (`shard`: None for the whole
    weight)."""

    OUT_AXIS = 0
    shard = None
    rows = None     # parallel/spatial.RowShard of a row-sharded network
    io_rows = None  # (H in, H out): whole heights, set by the network

    def forward(self, op, x, **kw):
        if self.rows is not None:
            return spatial.call(op, x, self.w, self.b, self.rows,
                                self.io_rows, **kw)
        return tp.call(op, x, self.w, self.b, self.shard, **kw)

    def jax_shape(self):
        """The full weight's shape in terrain_tpu's layout."""
        shape = list(self.w.shape)
        if self.shard is not None:
            shape[self.OUT_AXIS] *= self.shard.count
        return tuple(shape[a] for a in self.JAX_AXES)

    def _mine(self, w):
        """This rank's slice of a full weight in the port's layout."""
        w = torch.as_tensor(np.ascontiguousarray(w))
        if self.shard is None:
            return w
        return tp.slice_axis(w, self.OUT_AXIS, self.shard)

    def _full(self):
        """The full weight, gathered over the model group when sharded."""
        w = self.w.detach()
        if self.shard is None:
            return w
        return tp.gather_axis(w, self.OUT_AXIS, self.shard)


class Conv(_Layer):
    """Conv weights (cout, cin, k, k) + bias; Glorot fans use the receptive
    field, as lasagne.  JAX layout: HWIO."""

    def __init__(self, k, cin, cout, generator):
        super().__init__()
        self.w = nn.Parameter(glorot_uniform(
            (cout, cin, k, k), cin * k * k, cout * k * k, generator))
        self.b = nn.Parameter(torch.zeros(cout))

    JAX_AXES = (2, 3, 1, 0)

    def load_jax(self, params, state):
        _copy(self.w, self._mine(np.transpose(params["w"], (3, 2, 0, 1))))
        _copy(self.b, params["b"])

    def to_jax(self):
        return ({"w": _np(self._full().permute(2, 3, 1, 0)),
                 "b": _np(self.b)}, None)


class Deconv(_Layer):
    """Transposed-conv weights (cin, cout, k, k), spatially flipped, so
    `F.conv_transpose2d` equals terrain_tpu's `lax.conv_transpose` with the
    HWIO kernel (unflipped they differ by 4.5-5.2 max-abs)."""

    OUT_AXIS = 1

    def __init__(self, k, cin, cout, generator):
        super().__init__()
        # Glorot over the HWIO draw, then the same flip/permute as load_jax
        w = glorot_uniform((k, k, cin, cout), cin * k * k, cout * k * k,
                           generator)
        self.w = nn.Parameter(w.flip(0, 1).permute(2, 3, 0, 1).contiguous())
        self.b = nn.Parameter(torch.zeros(cout))

    JAX_AXES = (2, 3, 0, 1)

    def load_jax(self, params, state):
        w = np.flip(np.asarray(params["w"]), (0, 1)).transpose(2, 3, 0, 1)
        _copy(self.w, self._mine(w))
        _copy(self.b, params["b"])

    def to_jax(self):
        w = self._full().permute(2, 3, 0, 1).flip(0, 1)
        return {"w": _np(w), "b": _np(self.b)}, None


class Dense(_Layer):
    """Dense weights (dout, din) for `F.linear`; JAX layout (din, dout)."""

    def __init__(self, din, dout, generator):
        super().__init__()
        self.w = nn.Parameter(
            glorot_uniform((din, dout), din, dout, generator).t().contiguous())
        self.b = nn.Parameter(torch.zeros(dout))

    JAX_AXES = (1, 0)

    def load_jax(self, params, state):
        _copy(self.w, self._mine(np.asarray(params["w"]).T))
        _copy(self.b, params["b"])

    def to_jax(self):
        return {"w": _np(self._full().t()), "b": _np(self.b)}, None


def dropout(x, rate, generator, train, shard=None, rows=None):
    """Inverted dropout (lasagne DropoutLayer, rescale=True); the mask is
    drawn from `generator`, on x's device.  `shard` = (index, count): x
    holds rows index*N .. (index+1)*N of a global batch of count*N, whose
    mask is drawn and this rank's rows kept (data/augment.augment_pair).
    `rows` = (index, count): x is slab `index` of `count` of each image's
    rows; the whole images' mask is drawn and the slab's rows kept."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    index, count = shard or (0, 1)
    ri, rc = rows or (0, 1)
    n, h = x.shape[0], x.shape[1]
    mask = torch.rand((n * count, h * rc) + tuple(x.shape[2:]),
                      generator=generator, device=x.device)
    mask = mask[index * n:(index + 1) * n, ri * h:(ri + 1) * h] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def param_count(module):
    """Learnable parameters (BN running statistics excluded), as the JAX
    param_count over the params tree."""
    return sum(p.numel() for p in module.parameters())


def keystr(path):
    """A key path as jax.tree_util.keystr writes it: ['enc'][0]['w']."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def tree_leaves_with_path(tree, path=()):
    """(key path, leaf) of a terrain_tpu tree of dicts and lists, in
    jax.tree_util's flattening order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def describe(net):
    """terrain_tpu's models/core.describe for the port's network: its
    parameter count, its factory config, and each parameter's key path,
    shape and dtype in terrain_tpu's tree (models/convert.to_jax: JAX
    layouts; a sharded weight gathered whole, a collective), the same text
    for the same weights."""
    from terrain_tpu_torch.models import convert

    params = convert.to_jax(net)[0]
    flat = list(tree_leaves_with_path(params))
    total = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    lines = [f"{net.name}: {total:,} learnable params"]
    for k in sorted(net.config):
        lines.append(f"  config {k} = {net.config[k]!r}")
    for path, leaf in flat:
        lines.append(f"  {keystr(path)} {tuple(leaf.shape)} {leaf.dtype}")
    return "\n".join(lines)

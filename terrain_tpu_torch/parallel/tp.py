"""Tensor parallelism on 'model': the collectives around a layer whose
weight is split over the model group on its output features
(terrain_tpu shards such weights with NamedShardings and lets XLA insert
the collectives; here they are written out).

A sharded layer (models/core.py `Conv`, `Deconv`, `Dense`) holds only its
rank's contiguous slice of the output features as its parameter, and its
bias whole.  Its input is the same on every rank of the model group, so a
call is

    y = gather_features(op(enter_sharded(x), w_slice)) + b

  * `enter_sharded`: the identity forward; its backward sums the cotangent
    over the model group, which makes whole the dX that each rank computes
    from its own output features;
  * `gather_features`: every rank's output slice, concatenated on the last
    (feature) axis; its backward keeps this rank's slice of the cotangent,
    with no communication, since everything after the gather, and so its
    cotangent, is the same on every rank of the model group.

A replicated parameter therefore gets the same gradient on every rank of
the model group, and a sharded one its slice's gradient: the data group's
mean (train/step.py) then applies to both unchanged.  The bias is added
after the gather, as terrain_tpu keeps biases replicated.  Every
collective is an all_reduce (SUM): gloo runs no other on CUDA tensors, and
the card's check runs two gloo ranks on one card.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from terrain_tpu_torch.ops.activations import leaky_relu
from terrain_tpu_torch.ops.conv import conv2d, conv2d_leaky


class Shard:
    """A layer's place on the model group: this rank's `index` of `count`
    slices and the `group`.  A copy of a module shares it (a process group
    cannot be copied; models/convert.py copies modules to read them)."""

    __slots__ = ("index", "count", "group")

    def __init__(self, index, count, group):
        self.index, self.count, self.group = index, count, group

    def __deepcopy__(self, memo):
        return self

    def part(self, size):
        """(start, length) of this rank's slice of `size` features."""
        if size % self.count:
            raise ValueError(f"{size} features do not divide over "
                             f"{self.count} model ranks")
        n = size // self.count
        return self.index * n, n

    def __repr__(self):
        return f"Shard({self.index} of {self.count})"


def _comm_device(t, group):
    """Where a collective over `group` can run on t: NCCL takes CUDA
    tensors only, so a CPU tensor (a module copied to the host to be read)
    goes through the current card."""
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def gather_axis(t, axis, shard):
    """The whole tensor from every rank's slice `t` on `axis`: one
    all_reduce (SUM) of a zero buffer that holds this rank's slice."""
    axis = axis % t.dim()
    size = t.shape[axis] * shard.count
    shape = list(t.shape)
    shape[axis] = size
    dev = _comm_device(t, shard.group)
    full = torch.zeros(shape, dtype=t.dtype, device=dev)
    start, n = shard.part(size)
    full.narrow(axis, start, n).copy_(t)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=shard.group)
    return full.to(t.device)


def slice_axis(t, axis, shard):
    """This rank's contiguous slice of the whole tensor t on `axis`."""
    start, n = shard.part(t.shape[axis])
    return t.narrow(axis, start, n)


class GatherFeatures(torch.autograd.Function):
    """The last axis gathered over the model group; the backward keeps
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        return gather_axis(y, -1, shard)

    @staticmethod
    def backward(ctx, g):
        return slice_axis(g, -1, ctx.shard).contiguous(), None


class EnterSharded(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the model
    group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.shard.group)
        return g, None


def gather_features(y, shard):
    return GatherFeatures.apply(y, shard)


def enter_sharded(x, shard):
    return EnterSharded.apply(x, shard)


def call(op, x, w, b, shard, **kw):
    """op(x, w, b, **kw) of a layer: as it is without a shard; with one,
    the local op on this rank's weight slice without the bias, the gather,
    then the bias.  A fused activation (conv2d_leaky's `slope`) runs after
    the bias, on the whole output, as conv2d_leaky's unfused form does."""
    if shard is None:
        return op(x, w, b, **kw)
    slope = None
    if op is conv2d_leaky:
        op, slope = conv2d, kw.pop("slope", 0.2)
    y = gather_features(op(enter_sharded(x, shard), w, None, **kw), shard)
    if b is not None:
        y = y + b.to(y.dtype)
    return y if slope is None else leaky_relu(y, slope)


def wide_layers(module, n_model, min_features=256):
    """{name: layer} of the module's whole (not yet sharded) layers whose
    terrain_tpu weight `mesh.tp_shardings` (JAX's rule) splits over a
    'model' axis of n_model ranks."""
    from terrain_tpu_torch.parallel.mesh import Mesh, tp_shardings

    laid_out = Mesh(np.zeros((1, n_model), int))
    out = {}
    for name, m in module.named_modules():
        if hasattr(m, "OUT_AXIS") and m.shard is None:
            leaf = np.broadcast_to(np.float32(0), m.jax_shape())
            if "model" in tp_shardings(leaf, laid_out, min_features).spec:
                out[name] = m
    return out


def shard_module(module, mesh, min_features=256):
    """terrain_tpu's _place_on_mesh for one network's weights
    (train/trainer.py:777-793): every layer of `wide_layers` keeps this
    rank's slice of its weight as its parameter (the full weight broadcast
    first, as `mesh.place` does) and gathers in its call.  Returns the
    names of the layers sharded; the module's other tensors are left to
    the caller's `place`."""
    from terrain_tpu_torch.parallel.mesh import Sharding, place

    if mesh.shape["model"] == 1:
        return []
    if mesh.model_group is None:
        raise ValueError("a mesh with n_model > 1 needs a process group: "
                         "call parallel.initialize() before make_mesh()")
    wide = wide_layers(module, mesh.shape["model"], min_features)
    for m in wide.values():
        spec = [None] * m.w.dim()
        spec[m.OUT_AXIS] = "model"
        m.w = nn.Parameter(place(m.w.detach(), Sharding(mesh, spec)))
        m.shard = Shard(mesh.model_index, mesh.shape["model"],
                        mesh.model_group)
    return list(wide)

"""Lasagne batch normalization (terrain_tpu/ops/norm.py:35-57).

State is (mean, inv_std) and the running average is taken in inv_std
space, with eps 1e-4 and alpha 1e-2: not what `nn.BatchNorm2d` stores, so
this is written out by hand.  Statistics are computed in fp32 with the
biased variance, whatever the activation dtype.

Data parallelism: a BatchNorm whose `process_group` is set (the trainer
sets the mesh's data group, as `nn.SyncBatchNorm` takes one) normalizes
with the statistics of the global batch, all ranks' rows, as terrain_tpu's
mean over an axis sharded on 'data' (a psum, terrain_tpu/parallel/
mesh.py:10-14).  Two passes, as terrain_tpu's mean and var
(norm.py:45-47): the all-reduced fp32 sum gives the mean, then the
all-reduced sum of squared deviations from it the variance.  Each all-
reduce is `all_reduce_sum`, whose backward all-reduces the cotangent, so
every rank's gradient holds the other ranks' paths through the
statistics.  Without a group nothing changes.
"""

import torch
import torch.distributed as dist
from torch import nn

EPS = 1e-4  # lasagne BatchNormLayer default epsilon
ALPHA = 1e-2  # lasagne BatchNormLayer default running-average alpha


class AllReduceSum(torch.autograd.Function):
    """The sum of x over the ranks of `group`; its backward is the sum of
    the cotangents over the same ranks (each rank's loss reaches every
    rank's x through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    return AllReduceSum.apply(x, group)


def batch_norm(x, gamma, beta, mean, inv_std, *, train, eps=EPS, alpha=ALPHA,
               group=None):
    """Normalize over all axes but the last.  Returns (y, (mean, inv_std))
    with the new running statistics (unchanged in deterministic mode).
    With a process `group`, the statistics are those of the rows of every
    rank of the group, which must each hold as many."""
    if train:
        axes = tuple(range(x.ndim - 1))
        xf = x.float()
        if group is None:
            bmean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
        else:
            count = xf.numel() // xf.shape[-1] * dist.get_world_size(group)
            bmean = all_reduce_sum(xf.sum(dim=axes), group) / count
            d = xf - bmean
            var = all_reduce_sum((d * d).sum(dim=axes), group) / count
        binv = torch.rsqrt(var + eps)
        new_state = ((1.0 - alpha) * mean + alpha * bmean,
                     (1.0 - alpha) * inv_std + alpha * binv)
        mean, inv_std = bmean, binv
    else:
        new_state = (mean, inv_std)
    scale = (inv_std * gamma).to(x.dtype)
    shift = (beta - mean * inv_std * gamma).to(x.dtype)
    return x * scale + shift, new_state


class _Shared:
    """A process group held by a module: a copy of the module shares it
    (a group is a handle on the ranks' communicator and cannot be
    copied; models/convert.py copies modules to read them)."""

    __slots__ = ("group",)

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class BatchNorm(nn.Module):
    """Lasagne BatchNormLayer over the last (channel) axis.  The running
    statistics are buffers; `process_group` (None: this process's rows
    alone) is the group whose global batch the statistics are taken
    over.  `forward` writes them (in place, outside autograd) only when
    asked to with `update_stats=True` in train mode: a
    train step runs a discriminator up to three times, and only one of
    those passes may leave its statistics behind (train/step.py)."""

    def __init__(self, num_features):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("inv_std", torch.ones(num_features))
        self.process_group = None  # the data group of a mesh

    @property
    def process_group(self):
        return self._group.group

    @process_group.setter
    def process_group(self, group):
        self._group = _Shared(group)

    def forward(self, x, train=False, update_stats=False):
        y, (mean, inv_std) = batch_norm(
            x, self.gamma, self.beta, self.mean, self.inv_std, train=train,
            group=self.process_group)
        if train and update_stats:
            with torch.no_grad():
                self.mean.copy_(mean)
                self.inv_std.copy_(inv_std)
        return y

    def load_jax(self, params, state):
        _copy(self.gamma, params["gamma"])
        _copy(self.beta, params["beta"])
        _copy(self.mean, state["mean"])
        _copy(self.inv_std, state["inv_std"])

    def to_jax(self):
        return ({"gamma": _np(self.gamma), "beta": _np(self.beta)},
                {"mean": _np(self.mean), "inv_std": _np(self.inv_std)})


def _copy(dst, arr):
    src = torch.as_tensor(arr, dtype=dst.dtype)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _np(t):
    return t.detach().cpu().numpy().copy()

"""Lasagne batch normalization (terrain_tpu/ops/norm.py:35-57).

State is (mean, inv_std) and the running average is taken in inv_std
space, with eps 1e-4 and alpha 1e-2: not what `nn.BatchNorm2d` stores, so
this is written out by hand.  Statistics are computed in fp32 with the
biased variance, whatever the activation dtype.
"""

import torch
from torch import nn

EPS = 1e-4  # lasagne BatchNormLayer default epsilon
ALPHA = 1e-2  # lasagne BatchNormLayer default running-average alpha


def batch_norm(x, gamma, beta, mean, inv_std, *, train, eps=EPS, alpha=ALPHA):
    """Normalize over all axes but the last.  Returns (y, (mean, inv_std))
    with the new running statistics (unchanged in deterministic mode)."""
    if train:
        axes = tuple(range(x.ndim - 1))
        xf = x.float()
        bmean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        binv = torch.rsqrt(var + eps)
        new_state = ((1.0 - alpha) * mean + alpha * bmean,
                     (1.0 - alpha) * inv_std + alpha * binv)
        mean, inv_std = bmean, binv
    else:
        new_state = (mean, inv_std)
    scale = (inv_std * gamma).to(x.dtype)
    shift = (beta - mean * inv_std * gamma).to(x.dtype)
    return x * scale + shift, new_state


class BatchNorm(nn.Module):
    """Lasagne BatchNormLayer over the last (channel) axis.  The running
    statistics are buffers; this slice only reads them (serving), so
    `forward` leaves them unchanged in either mode."""

    def __init__(self, num_features):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("inv_std", torch.ones(num_features))

    def forward(self, x, train=False):
        y, _ = batch_norm(x, self.gamma, self.beta, self.mean, self.inv_std,
                          train=train)
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

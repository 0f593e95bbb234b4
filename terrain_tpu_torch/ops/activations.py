"""Activations, by-name registry (terrain_tpu/ops/activations.py).

Leakiness values matter for parity: the DCGAN blocks use 0.2, the U-Net
and PatchGAN use lasagne's `leaky_rectify` default of 0.01.
"""

import torch

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_LEAKY_MUL": "an exact reformulation of the LeakyReLU's "
                         "gradient (a saved 1-or-slope scale) for XLA; "
                         "autograd of torch.where gives the same values",
}


def linear(x):
    return x


def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, x * negative_slope)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


ACTIVATIONS = {
    "linear": linear,
    None: linear,
    "relu": relu,
    "rectify": relu,
    "leaky_rectify": leaky_relu,  # lasagne default leakiness 0.01
    "leaky_relu": leaky_relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
}


def get_activation(act):
    """Resolve an activation from a name or pass a callable through."""
    if callable(act):
        return act
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None

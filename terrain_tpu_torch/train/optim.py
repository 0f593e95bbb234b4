"""Optimizers with Lasagne's update rules (terrain_tpu/train/optim.py:32-67)
over the parameters of a module.

rmsprop:  accu' = rho*accu + (1-rho)*g^2
          p'    = p - lr * g / sqrt(accu' + eps)       (rho 0.9, eps 1e-6)
adam:     a_t = lr*sqrt(1-b2^t)/(1-b1^t);  m, v EMAs of g and g^2
          p'  = p - a_t * m / (sqrt(v) + eps)

Neither is the `torch.optim` class of the same name: `torch.optim.RMSprop`
adds eps outside the root and defaults alpha to 0.99; `torch.optim.Adam`
corrects m and v separately, which puts eps elsewhere.  The learning rate
is an argument of every `update`, so a scheduler can change it between
steps.  A CUDA graph of steps (train/step.py) records `lr` as the constant
of the fused update it was captured with, and is captured anew when lr
changes.  adam's step count `t` is a device int32 scalar in its state, as
in terrain_tpu (optim.py:48-65), and its bias correction a_t is computed
from it on the device: a replay of the graph advances both.

A state tensor has its parameter's shape: under tensor parallelism that
of the rank's slice (terrain_tpu shards it as its parameter); adam's `t`
is replicated.

Unlike the JAX package's pure functions, `update` changes the parameters
and the state IN PLACE, under `torch.no_grad()`, with the fused
`torch._foreach_*` ops: a step then makes no second copy of the weights.
"""

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    default_lr: float
    # init(params) -> state;  update(params, grads, state, lr) in place
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], None]


def rmsprop(learning_rate=1.0, rho=0.9, epsilon=1e-6):
    def init(params):
        return {"accu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(params, grads, state, lr):
        accu = state["accu"]
        torch._foreach_mul_(accu, rho)
        torch._foreach_addcmul_(accu, grads, grads, value=1.0 - rho)
        denom = torch._foreach_add(accu, epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_addcdiv_(params, grads, denom, value=-float(lr))

    return Optimizer("rmsprop", learning_rate, init, update)


def adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8):
    def init(params):
        dev = params[0].device if params else None
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params],
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(params, grads, state, lr):
        t = state["t"]
        t.add_(1)
        tf = t.float()
        # fp32 on the device, as terrain_tpu computes it
        a_t = (float(lr) * torch.sqrt(1.0 - torch.pow(beta2, tf))
               / (1.0 - torch.pow(beta1, tf)))
        torch._foreach_mul_(state["m"], beta1)
        torch._foreach_add_(state["m"], grads, alpha=1.0 - beta1)
        torch._foreach_mul_(state["v"], beta2)
        torch._foreach_addcmul_(state["v"], grads, grads, value=1.0 - beta2)
        denom = torch._foreach_sqrt(state["v"])
        torch._foreach_add_(denom, epsilon)
        # addcdiv takes its scale from the host only in some builds: the
        # device a_t scales m first
        step = torch._foreach_mul(state["m"], a_t)
        torch._foreach_addcdiv_(params, step, denom, value=-1.0)

    return Optimizer("adam", learning_rate, init, update)


OPTIMIZERS = {"rmsprop": rmsprop, "adam": adam}


def get_optimizer(opt, opt_args=None):
    """Resolve 'rmsprop'/'adam' (+ kwargs) or pass an Optimizer through.
    `learning_rate` in opt_args sets the default lr."""
    if isinstance(opt, Optimizer):
        return opt
    return OPTIMIZERS[opt](**dict(opt_args or {}))

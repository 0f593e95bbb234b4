"""Carry weights between terrain_tpu's trees and the port's modules.

terrain_tpu keeps a network as two nested dict/list trees of arrays,
`params` and `state` (the BN running statistics), in JAX layouts -- the
same trees a `terrain_tpu/v1` checkpoint holds.  The port's modules mirror
those trees attribute for attribute (dicts -> named submodules, lists ->
nn.ModuleList), and each layer module converts its own leaves
(models/core.py, ops/norm.py):
  * conv HWIO -> (O, I, kh, kw);
  * deconv HWIO -> spatially flipped (I, O, kh, kw) for F.conv_transpose2d;
  * dense (din, dout) -> (dout, din);
  * BN gamma/beta/mean/inv_std unchanged.

A gradient or an optimizer-state tree of terrain_tpu has the shape of
`params`, so `params_from_jax` / `params_to_jax` carry such a tree into the
port's layouts (one tensor per `module.parameters()` entry) and back.
"""

import copy

import torch
from torch import nn


def _is_leaf(module):
    return hasattr(module, "load_jax")


def load_jax(module, params, state):
    """Copy a terrain_tpu (params, state) tree into `module`, key path for
    key path.  Raises on a missing key, a shape mismatch, or a layer of
    the module that the tree did not reach."""
    seen = []
    _load(module, params, state, seen, "")
    leaves = [m for m in module.modules() if _is_leaf(m)]
    if len(seen) != len(leaves):
        raise ValueError(f"tree reached {len(seen)} of {len(leaves)} layers")
    return module


def _load(mod, p, s, seen, path):
    if _is_leaf(mod):
        try:
            mod.load_jax(p, s or {})
        except (KeyError, ValueError) as e:
            raise ValueError(f"{path or '<root>'}: {e}") from None
        seen.append(mod)
    elif isinstance(p, dict):
        for k, v in p.items():
            sub = getattr(mod, k, None)
            if not isinstance(sub, nn.Module):
                raise ValueError(f"{path}.{k}: no such submodule")
            _load(sub, v, (s or {}).get(k), seen, f"{path}.{k}")
    elif isinstance(p, (list, tuple)):
        if len(p) != len(mod):
            raise ValueError(f"{path}: {len(p)} entries vs {len(mod)}")
        for i, v in enumerate(p):
            _load(mod[i], v, s[i] if s else None, seen, f"{path}[{i}]")
    else:
        raise ValueError(f"{path}: unexpected {type(p).__name__}")


def to_jax(module):
    """The module's (params, state) trees in terrain_tpu's layout."""
    p, s = _dump(module)
    return p, (s if s is not None else {})


def _dump(mod):
    if _is_leaf(mod):
        return mod.to_jax()
    if isinstance(mod, nn.ModuleList):
        pairs = [_dump(m) for m in mod]
        return [q for q, _ in pairs], [t if t is not None else {}
                                       for _, t in pairs]
    params, state = {}, {}
    for k, m in mod.named_children():
        q, t = _dump(m)
        params[k] = q
        # state keeps BN entries and every list (as terrain_tpu's init does)
        if isinstance(m, nn.ModuleList) or t:
            state[k] = t
    return params, state


def params_from_jax(module, tree):
    """A terrain_tpu tree shaped like the module's `params` (weights,
    gradients, rmsprop `accu`) as a list of tensors in the port's layouts,
    in `module.parameters()` order."""
    tmp = copy.deepcopy(module).cpu()
    load_jax(tmp, tree, to_jax(tmp)[1])
    return [p.detach() for p in tmp.parameters()]


def params_to_jax(module, tensors):
    """The inverse: a list of tensors in `module.parameters()` order as a
    terrain_tpu tree shaped like `params`."""
    tmp = copy.deepcopy(module).cpu()
    with torch.no_grad():
        for p, t in zip(tmp.parameters(), tensors, strict=True):
            p.copy_(t)
    return to_jax(tmp)[0]

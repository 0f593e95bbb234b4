"""The `terrain_tpu/v1` checkpoint format (terrain_tpu/train/checkpoint.py:35-74).

A checkpoint is a gzip-pickled dict {"format": "terrain_tpu/v1",
"dcgan": {"gen", "disc"}, "p2p": {"gen", "disc"}, ["extra"]}, each network
entry {"params", "state"} holding terrain_tpu's nested trees of numpy
arrays in JAX layouts.  This module reads and writes it with numpy only,
so each package loads the other's `<epoch>.model`; models/convert.py
carries the trees into the port's modules.
"""

import gzip
import os
import pickle

import numpy as np

FORMAT = "terrain_tpu/v1"
_STAGES = {"dcgan": ("dcgan_gen", "dcgan_disc"), "p2p": ("p2p_gen", "p2p_disc")}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def save_model(filename, params, states, extra=None):
    """params/states: dicts keyed by net name (dcgan_gen, dcgan_disc,
    p2p_gen, p2p_disc) of terrain_tpu trees.  Written atomically."""
    payload = {"format": FORMAT}
    for stage, (g, d) in _STAGES.items():
        payload[stage] = {
            role: {"params": _to_numpy(params[net]),
                   "state": _to_numpy(states[net])}
            for role, net in (("gen", g), ("disc", d))}
    if extra is not None:
        payload["extra"] = extra
    tmp = f"{filename}.tmp"
    with gzip.open(tmp, "wb", compresslevel=1) as f:
        pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, filename)


def load_trees(filename, mode="both"):
    """{net name: (params, state)} for the stage(s) selected by `mode`
    ("both", "dcgan" or "p2p"), generators and discriminators.  Only open
    checkpoints this project wrote: unpickling can run code."""
    if mode not in ("both", "dcgan", "p2p"):
        raise ValueError(f"mode must be both|dcgan|p2p, got {mode!r}")
    with gzip.open(filename, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{filename}: not a {FORMAT} checkpoint")
    out = {}
    for stage in (("dcgan", "p2p") if mode == "both" else (mode,)):
        for role, net in zip(("gen", "disc"), _STAGES[stage]):
            entry = payload[stage][role]
            out[net] = (entry["params"], entry["state"])
    return out

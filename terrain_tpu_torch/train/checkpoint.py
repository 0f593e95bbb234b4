"""The `terrain_tpu/v1` checkpoint format (terrain_tpu/train/checkpoint.py:35-74).

A checkpoint is a gzip-pickled dict {"format": "terrain_tpu/v1",
"dcgan": {"gen", "disc"}, "p2p": {"gen", "disc"}, ["extra"]}, each network
entry {"params", "state"} holding terrain_tpu's nested trees of numpy
arrays in JAX layouts.  This module reads and writes it with numpy only,
so each package loads the other's `<epoch>.model`; models/convert.py
carries the trees into the port's modules.

The trees hold full arrays: under tensor parallelism the trainer gathers
each sharded weight (and its optimizer state) before it writes, on every
rank, and takes its slices again when it loads (models/core.py).

The optional "extra" entry carries what an exact resume needs beyond the
weights (optimizer states as terrain_tpu trees of numpy arrays, lr, step
counter, RNG states, plateau state); the trainer fills and reads it.
`pick_best_epoch` reads a run's swd.txt trend to choose a checkpoint.
"""

import glob
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


def load_model(filename, mode="both"):
    """({net name: (params, state)}, extra) for the stage(s) selected by
    `mode` ("both", "dcgan" or "p2p"), generators and discriminators;
    extra is None when the checkpoint carries none.  Only open checkpoints
    this project wrote: unpickling can run code."""
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
    return out, payload.get("extra")


def pick_best_epoch(out_dir, model_dir, metric="swd_mean"):
    """The checkpoint at the quality-best epoch of a run's swd.txt
    (terrain_tpu/train/checkpoint.py:77): reads the per-epoch trend, keeps
    the last row of a resumed epoch, finds the epoch minimizing `metric`
    ("swd_mean", "p2p_swd_mean", or "both" = their sum) and snaps to the
    nearest saved `<epoch>.model` in model_dir.

    Returns (path, ckpt_epoch, best_epoch, value), or None when swd.txt is
    absent or empty or no checkpoint exists."""
    swd_path = os.path.join(out_dir, "swd.txt")
    if not os.path.exists(swd_path):
        return None
    rows = {}
    with open(swd_path) as f:
        header = f.readline().strip().split(",")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != len(header):
                continue  # torn row from a killed run
            try:
                rows[int(float(parts[0]))] = {
                    k: float(v) for k, v in zip(header[1:], parts[1:])}
            except ValueError:
                continue
    if not rows:
        return None

    def score(r):
        if metric == "both":
            return r.get("swd_mean", np.inf) + r.get("p2p_swd_mean", 0.0)
        return r.get(metric, np.inf)

    best_epoch = min(rows, key=lambda e: score(rows[e]))
    value = score(rows[best_epoch])
    if not np.isfinite(value):
        return None
    ckpts = {}
    for p in glob.glob(os.path.join(model_dir, "*.model")):
        try:
            ckpts[int(os.path.basename(p).split(".")[0])] = p
        except ValueError:
            continue
    if not ckpts:
        return None
    ckpt_epoch = min(ckpts, key=lambda e: (abs(e - best_epoch), -e))
    return ckpts[ckpt_epoch], ckpt_epoch, best_epoch, value

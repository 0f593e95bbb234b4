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

The gzip stream is written as a sequence of gzip members, one for each
CHUNK bytes of the pickle, compressed at level 1 on a pool of host
threads (zlib releases the interpreter lock): deflate runs at ~20 MB/s a
core on the networks' float weights, so one thread took ~22 s for the
flagship's 394 MiB.  gzip readers (Python's `gzip`, terrain_tpu's
`load_model`, `gunzip`) read a multi-member file as one stream.
"""

import collections
import glob
import gzip
import os
import pickle
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FORMAT = "terrain_tpu/v1"
CHUNK = 16 << 20   # pickle bytes per gzip member
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
    with open(tmp, "wb") as f:
        with _GzipMembers(f) as g:
            pickle.dump(payload, g, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, filename)


def _member(data):
    c = zlib.compressobj(1, zlib.DEFLATED, 31)  # 31: a gzip member
    return c.compress(data) + c.flush()


class _GzipMembers:
    """A write-only file object over `f`: the bytes written are cut into
    CHUNK-byte pieces, each compressed into a gzip member on a thread
    pool, and the members written to `f` in order (at most two per thread
    in flight)."""

    def __init__(self, f):
        self.f = f
        self.buf = bytearray()
        self.workers = min(8, os.cpu_count() or 1)
        self.pool = ThreadPoolExecutor(self.workers)
        self.pending = collections.deque()

    def write(self, data):
        """`data`: bytes or any buffer (pickle hands large arrays over as
        PickleBuffers)."""
        self.buf += data
        while len(self.buf) >= CHUNK:
            self._submit(bytes(self.buf[:CHUNK]))
            del self.buf[:CHUNK]
        return memoryview(data).nbytes

    def _submit(self, data):
        self.pending.append(self.pool.submit(_member, data))
        while len(self.pending) > 2 * self.workers:
            self.f.write(self.pending.popleft().result())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                if self.buf:
                    self._submit(bytes(self.buf))
                while self.pending:
                    self.f.write(self.pending.popleft().result())
        finally:
            self.pool.shutdown(cancel_futures=True)


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

"""Terrain sampler service on the card (terrain_tpu/serve/server.py).

The same ops, buckets, padding, streaming and wire format as the JAX
server:

* concurrent requests are coalesced by the MicroBatcher and padded to
  power-of-two buckets (padding repeats row 0); all padding and slicing
  happens host-side on numpy;
* a two-stage request runs z -> heightmap -> texture on the device in one
  call of the pipeline's sampler, through the bilinear_conv and conv_thin
  kernels;
* png responses are quantized on the device (u16 heightmap, u8 texture,
  the exact encode_array_png contract), so the host copies 2-4x fewer
  bytes.

Ops (newline-delimited JSON, see protocol.py):
  {"op": "health"}                          -> {"ok": true, ...}
  {"op": "stats"}                           -> batcher counters
  {"op": "gz", "n": 4, "seed": 1,
   "deterministic": true, "texture": true}  -> heightmaps (+ textures)
  {"op": "atob", "heightmap": <b64 npy>}    -> textures for client arrays
  {"op": "interp", "seed": 7, "steps": 25,
   "deterministic": true}                   -> two-stage frames along a z-lerp
Every sampling op accepts ``"enc": "npy" | "png"``; ``interp`` also takes
``"stream": true`` for one response per device bucket.
"""

import socketserver
import threading

import numpy as np
import torch

from terrain_tpu_torch.device import strict_fp32
from terrain_tpu_torch.serve.batcher import MicroBatcher, bucket_size
from terrain_tpu_torch.serve.protocol import (
    decode_array, encode_array, encode_array_png, recv_msg, send_msg)

# terrain_tpu switches this module has no use for, each with the reason
NO_OP_SWITCHES = {
    "TERRAIN_SERVE_QFETCH": "=0 fetches fp32 and quantizes on the host; "
                            "the device quantization here gives the same "
                            "bytes (tests/test_torch_serve.py holds them "
                            "equal), so only the bytes fetched differ",
}


def _q16(a):
    """Heightmap [0,1] -> u16 levels, carried as int16 (v - 32768): the
    device has no general uint16 arithmetic; `_u16` undoes the offset."""
    v = torch.round(torch.clamp(a[..., 0], 0.0, 1.0) * 65535.0) - 32768.0
    return v.to(torch.int16)


def _u16(q):
    return q.view(np.uint16) ^ np.uint16(0x8000)


def _q8(b):
    return torch.round((torch.clamp(b, -1.0, 1.0) + 1.0) * 127.5) \
        .to(torch.uint8)


class TerrainServer:
    """Serves a TwoStagePipeline (terrain_tpu_torch.sample): its samplers,
    latent_dim, in_shp and device."""

    def __init__(self, model, host="127.0.0.1", port=0, *,
                 max_batch=8, wait_ms=2.0, png_level=3):
        strict_fp32()
        self.model = model
        self.max_batch = int(max_batch)
        self.png_level = int(png_level)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch, wait_ms=wait_ms)
        self._rng_lock = threading.Lock()
        self._global_rng = np.random.RandomState(0)
        self._stoch_rng = torch.Generator().manual_seed(0x5e7)
        # one device-dispatch lock across ALL ops: the batcher serializes
        # per op, but gz and atob workers could otherwise interleave
        self._dispatch_lock = threading.Lock()
        self.tcp = socketserver.ThreadingTCPServer(
            (host, port), self._make_handler())
        self.tcp.daemon_threads = True
        self.tcp.allow_reuse_address = True
        self.host, self.port = self.tcp.server_address
        self._thread = None

    # ------------------------------------------------------------- lifecycle
    def serve_forever(self):
        self.tcp.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(
            target=self.serve_forever, name="terrain-serve", daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.tcp.shutdown()
        self.tcp.server_close()
        self.batcher.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def warmup(self, verbose=False):
        """Run every bucket size (1, 2, 4, ..., max_batch) once, exact and
        quantized, so no first request pays the kernels' build, their
        first launch or cuDNN's algorithm choice."""
        m = self.model
        b = 1
        while True:
            z = np.zeros((b, m.latent_dim), np.float32)
            x = np.zeros((b, m.in_shp, m.in_shp, 1), np.float32)
            if verbose:
                print(f"warmup: gz/atob bucket={b} ...", flush=True)
            for wire in ("f32", "q"):
                self._two_stage(z, True, wire)
                self._atob(x, True, wire)
            if b >= self.max_batch:
                break
            b = min(b * 2, self.max_batch)
        if verbose:
            print("warmup: done", flush=True)

    # ------------------------------------------------------------ device work
    def _sample_z(self, n, seed):
        if seed is not None:
            return np.random.RandomState(int(seed)).rand(
                n, self.model.latent_dim).astype(np.float32)
        with self._rng_lock:
            return self._global_rng.rand(
                n, self.model.latent_dim).astype(np.float32)

    def _next_rng(self):
        """A fresh device generator per stochastic dispatch, seeded from
        the server's own torch generator."""
        with self._rng_lock:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._stoch_rng))
        return torch.Generator(device=self.model.device).manual_seed(seed)

    def _pad(self, arr, bucket):
        n = arr.shape[0]
        if n == bucket:
            return arr
        pad = np.repeat(arr[:1], bucket - n, axis=0)  # repeat row 0: same
        return np.concatenate([arr, pad], axis=0)     # shapes, valid values

    def _two_stage(self, Z, deterministic, wire="f32"):
        m = self.model
        z = torch.from_numpy(Z).to(m.device)
        with self._dispatch_lock:
            if deterministic:
                a, b = m.two_stage_det(z)
            else:
                a, b = m.two_stage_stoch(z, self._next_rng())
            if wire == "q":
                a, b = _q16(a), _q8(b)
        # host copies wait for the device outside the dispatch lock, so the
        # next batch can be enqueued meanwhile
        a, b = a.cpu().numpy(), b.cpu().numpy()
        return (_u16(a) if wire == "q" else a), b

    def _atob(self, X, deterministic, wire="f32"):
        m = self.model
        x = torch.from_numpy(X).to(m.device)
        with self._dispatch_lock:
            if deterministic:
                b = m.atob_det(x)
            else:
                b = m.atob_stoch(x, self._next_rng())
            if wire == "q":
                b = _q8(b)
        return b.cpu().numpy()

    def _run_batch(self, op, requests):
        """Executor for the MicroBatcher: one padded device dispatch for a
        coalesced batch, then split results back per request."""
        kind, deterministic, wire = op
        rows = [r["rows"] for r in requests]
        total = sum(rows)
        bucket = bucket_size(total, self.max_batch)
        cuts = np.cumsum(rows)[:-1]
        if kind == "gz":
            batch = np.concatenate([r["z"] for r in requests], axis=0)
            a, b = self._two_stage(self._pad(batch, bucket), deterministic,
                                   wire)
            return list(zip(np.split(a[:total], cuts),
                            np.split(b[:total], cuts)))
        if kind == "atob":
            batch = np.concatenate([r["x"] for r in requests], axis=0)
            b = self._atob(self._pad(batch, bucket), deterministic, wire)
            return np.split(b[:total], cuts)
        raise ValueError(f"unknown batch op {kind!r}")

    # -------------------------------------------------------------- requests
    def _encode(self, arr, kind, enc):
        if enc == "png":
            return encode_array_png(arr, kind, level=self.png_level)
        return encode_array(arr)

    def handle_request(self, msg, send_partial=None):
        """Handle one request; ``send_partial``, when provided by the
        transport, emits intermediate response objects for streaming ops
        (the returned object is always the FINAL response)."""
        op = msg.get("op")
        if op == "health":
            return {"ok": True, "latent_dim": self.model.latent_dim,
                    "in_shp": self.model.in_shp,
                    "max_batch": self.max_batch}
        if op == "stats":
            return {"ok": True, **self.batcher.snapshot()}
        deterministic = bool(msg.get("deterministic", True))
        enc = msg.get("enc", "npy")
        if enc not in ("npy", "png"):
            raise ValueError(f'enc must be "npy" or "png", got {enc!r}')
        # wire is part of the batch key: exact-npy and quantized requests
        # never coalesce into one dispatch
        wire = "q" if enc == "png" else "f32"
        if op == "gz":
            n = int(msg.get("n", 1))
            if not 1 <= n <= self.max_batch:
                raise ValueError(
                    f"n must be in [1, {self.max_batch}] per request")
            Z = self._sample_z(n, msg.get("seed"))
            a, b = self.batcher.submit(
                ("gz", deterministic, wire), {"z": Z, "rows": n}, n).result()
            out = {"ok": True, "heightmap": self._encode(a, "heightmap", enc)}
            if msg.get("texture", True):
                out["texture"] = self._encode(b, "texture", enc)
            return out
        if op == "atob":
            X = decode_array(msg["heightmap"]).astype(np.float32)
            if X.ndim == 3:
                X = X[None]
            m = self.model
            if X.shape[1:] != (m.in_shp, m.in_shp, 1):
                raise ValueError(
                    f"heightmap must be (n, {m.in_shp}, {m.in_shp}, 1), "
                    f"got {X.shape}")
            n = X.shape[0]
            if n > self.max_batch:
                raise ValueError(
                    f"n must be <= {self.max_batch} per request")
            b = self.batcher.submit(
                ("atob", deterministic, wire), {"x": X, "rows": n}, n).result()
            return {"ok": True, "texture": self._encode(b, "texture", enc)}
        if op == "interp":
            steps = int(msg.get("steps", 25))
            if not 2 <= steps <= 256:
                raise ValueError("steps must be in [2, 256]")
            stream = bool(msg.get("stream", False)) and send_partial is not None
            # z-lerp between two prior samples through the two-stage
            # pipeline, chunked into buckets server-side
            Z = self._sample_z(2, msg.get("seed"))
            t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
            zs = Z[0][None] * (1 - t) + Z[1][None] * t
            outs_a, outs_b = [], []
            for i in range(0, steps, self.max_batch):
                chunk = zs[i:i + self.max_batch]
                a, b = self.batcher.submit(
                    ("gz", deterministic, wire),
                    {"z": chunk, "rows": len(chunk)}, len(chunk)).result()
                if stream:
                    done = i + len(chunk) >= steps
                    part = {"ok": True, "stream": True, "done": done,
                            "frame_start": i, "frames": len(chunk),
                            "heightmap": self._encode(a, "heightmap", enc),
                            "texture": self._encode(b, "texture", enc)}
                    if done:
                        return part
                    send_partial(part)
                else:
                    outs_a.append(a)
                    outs_b.append(b)
            return {
                "ok": True,
                "heightmap": self._encode(
                    np.concatenate(outs_a), "heightmap", enc),
                "texture": self._encode(
                    np.concatenate(outs_b), "texture", enc)}
        raise ValueError(f"unknown op {op!r}")

    # -------------------------------------------------------------- transport
    def _make_handler(self):
        server = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = recv_msg(self.rfile)
                    except Exception as e:  # malformed frame: report, drop conn
                        try:
                            send_msg(self.wfile,
                                     {"ok": False, "error": f"bad request: {e}"})
                        except OSError:
                            pass
                        return
                    if msg is None:
                        return
                    try:
                        resp = server.handle_request(
                            msg,
                            send_partial=lambda obj: send_msg(self.wfile, obj))
                    except Exception as e:  # noqa: BLE001 — per-request isolation
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                    try:
                        send_msg(self.wfile, resp)
                    except OSError:
                        return

        return Handler

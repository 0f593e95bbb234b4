"""Python client for the terrain sampler service (see server.py).

A copy of terrain_tpu/serve/client.py; the wire format is the same, so it
talks to either package's server.  Thin wrapper over the newline-delimited
JSON protocol; splits oversized requests into server-sized chunks so
callers can ask for any n.
"""

import socket

import numpy as np

from terrain_tpu_torch.serve.protocol import (
    decode_payload, encode_array, recv_msg, send_msg)


class TerrainClient:
    def __init__(self, host="127.0.0.1", port=7642, timeout=600.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.wfile = self.sock.makefile("wb")
        info = self.request({"op": "health"})
        self.latent_dim = info["latent_dim"]
        self.in_shp = info["in_shp"]
        self.max_batch = info["max_batch"]

    def request(self, msg):
        send_msg(self.wfile, msg)
        resp = recv_msg(self.rfile)
        if resp is None:
            raise ConnectionError("server closed the connection")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "unknown server error"))
        return resp

    def health(self):
        return self.request({"op": "health"})

    def stats(self):
        return self.request({"op": "stats"})

    def generate(self, n=1, *, seed=None, deterministic=True, texture=True,
                 enc="npy"):
        """n terrain samples -> (heightmaps (n,H,W,1) in [0,1],
        textures (n,H,W,3) in [-1,1] or None).  ``enc="png"`` transports
        quantized PNGs (~7x fewer wire bytes at 512px, see protocol.py)."""
        hs, ts = [], []
        remaining, offset = n, 0
        while remaining > 0:
            k = min(remaining, self.max_batch)
            msg = {"op": "gz", "n": k, "deterministic": deterministic,
                   "texture": texture, "enc": enc}
            if seed is not None:
                msg["seed"] = int(seed) + offset  # distinct z per chunk
            resp = self.request(msg)
            hs.append(decode_payload(resp["heightmap"]))
            if texture:
                ts.append(decode_payload(resp["texture"]))
            remaining -= k
            offset += 1
        h = np.concatenate(hs, axis=0)
        return h, (np.concatenate(ts, axis=0) if texture else None)

    def texture_for(self, heightmap, *, deterministic=True, enc="npy"):
        """heightmap (n,H,W,1) or (H,W,1) in [0,1] -> texture(s)."""
        x = np.asarray(heightmap, dtype=np.float32)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        outs = []
        for i in range(0, x.shape[0], self.max_batch):
            resp = self.request({
                "op": "atob",
                "heightmap": encode_array(x[i:i + self.max_batch]),
                "deterministic": deterministic,
                "enc": enc,
            })
            outs.append(decode_payload(resp["texture"]))
        out = np.concatenate(outs, axis=0)
        return out[0] if squeeze else out

    def interpolate(self, *, seed=None, steps=25, deterministic=True,
                    enc="npy"):
        """Two-stage frames along a z-lerp -> (heightmaps, textures)."""
        msg = {"op": "interp", "steps": steps, "deterministic": deterministic,
               "enc": enc}
        if seed is not None:
            msg["seed"] = int(seed)
        resp = self.request(msg)
        return decode_payload(resp["heightmap"]), decode_payload(resp["texture"])

    def iter_interpolate(self, *, seed=None, steps=25, deterministic=True,
                         enc="npy"):
        """Streaming interpolation: yields (frame_start, heightmaps,
        textures) per server bucket as frames are computed — constant
        memory for long clips and time-to-first-frame of one bucket
        instead of the whole clip.

        Consume the generator fully (or close() the client) before issuing
        another request on this connection: abandoning it mid-stream leaves
        un-read chunks on the socket, which would desync later replies."""
        msg = {"op": "interp", "steps": steps, "deterministic": deterministic,
               "enc": enc, "stream": True}
        if seed is not None:
            msg["seed"] = int(seed)
        send_msg(self.wfile, msg)
        while True:
            resp = recv_msg(self.rfile)
            if resp is None:
                raise ConnectionError("server closed mid-stream")
            if not resp.get("ok"):
                raise RuntimeError(resp.get("error", "unknown server error"))
            yield (resp["frame_start"], decode_payload(resp["heightmap"]),
                   decode_payload(resp["texture"]))
            if resp.get("done"):
                return

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

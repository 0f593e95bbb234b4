"""Wire protocol for the terrain sampler service.

Newline-delimited JSON over a stream socket: one request object per line,
one response object per line, in order.  Arrays travel as base64-encoded
``.npy`` payloads inside the JSON (self-describing dtype + shape, no
pickle, language-agnostic), or — when the request asks for
``"enc": "png"`` — as per-frame base64 PNGs (16-bit grayscale for
heightmaps, 8-bit RGB for textures), ~7x smaller on the wire for 512px
samples at the cost of a documented quantization (see encode_array_png).

A copy of terrain_tpu/serve/protocol.py with the same wire format, so a
client of either package talks to a server of either; PNGs are written and
read by the port's own codec (serve/png.py) instead of the JAX package's
native encoder and imageio.
"""

import base64
import io
import json

import numpy as np

from terrain_tpu_torch.serve.png import decode_png, encode_png

MAX_LINE = 256 * 1024 * 1024  # refuse absurd payloads rather than OOM


def encode_array(arr):
    """numpy array -> base64 .npy string (self-describing, no pickle)."""
    buf = io.BytesIO()
    # note: not ascontiguousarray — that silently promotes 0-d to (1,)
    np.save(buf, np.asarray(arr, order="C"), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_array(s):
    """base64 .npy string -> numpy array."""
    buf = io.BytesIO(base64.b64decode(s.encode("ascii")))
    return np.load(buf, allow_pickle=False)


# --------------------------------------------------------------- png payloads
#
# PNG payloads quantize the float sampler outputs onto the integer ranges
# clients render anyway (the reference's own published artifacts are PNGs,
# README.md:48-61):
#   heightmap, model range [0, 1]   -> u16 grayscale (max err 1/131070)
#   texture,   model range [-1, 1]  -> u8 RGB        (max err 1/255)
# Exact float transport stays available as the default .npy encoding.

PNG_KINDS = ("heightmap", "texture")


def encode_array_png(arr, kind, level=3):
    """(n, H, W, C) float batch -> {"enc": "png", "kind": ..., "frames": [...]}.

    One base64 PNG per batch row.  ``kind`` selects the quantization
    contract above; ``level`` is the zlib effort.
    """
    if kind not in PNG_KINDS:
        raise ValueError(f"kind must be one of {PNG_KINDS}, got {kind!r}")
    a = np.asarray(arr)
    if a.dtype == (np.uint16 if kind == "heightmap" else np.uint8):
        # pre-quantized on the device (the server's png path): the same
        # rint/clip contract, 2-4x fewer bytes copied to the host
        q = a[..., 0] if (kind == "heightmap" and a.ndim == 4) else a
        if q.ndim != (3 if kind == "heightmap" else 4):
            raise ValueError(f"bad pre-quantized shape {a.shape} for {kind}")
    else:
        a = a.astype(np.float32, copy=False)
        if a.ndim != 4:
            raise ValueError(f"expected (n, H, W, C), got shape {a.shape}")
        if kind == "heightmap":
            q = np.rint(np.clip(a[..., 0], 0.0, 1.0) * 65535.0) \
                .astype(np.uint16)
        else:
            q = np.rint((np.clip(a, -1.0, 1.0) + 1.0) * 127.5) \
                .astype(np.uint8)
    frames = [base64.b64encode(encode_png(img, level=int(level)))
              .decode("ascii") for img in q]
    return {"enc": "png", "kind": kind, "frames": frames}


def decode_array_png(payload):
    """Inverse of encode_array_png -> (n, H, W, C) float32 in model range."""
    kind = payload["kind"]
    if kind not in PNG_KINDS:
        raise ValueError(f"bad png payload kind {kind!r}")
    imgs = [decode_png(base64.b64decode(f.encode("ascii")))
            for f in payload["frames"]]
    q = np.stack(imgs, axis=0)
    if kind == "heightmap":
        return q[..., :1].astype(np.float32) / 65535.0
    return q.astype(np.float32) / 127.5 - 1.0


def decode_payload(value):
    """Decode either wire encoding: .npy string or png payload dict."""
    if isinstance(value, str):
        return decode_array(value)
    if isinstance(value, dict) and value.get("enc") == "png":
        return decode_array_png(value)
    raise ValueError(f"unrecognized array payload: {type(value).__name__}")


def send_msg(wfile, obj):
    wfile.write((json.dumps(obj) + "\n").encode("utf-8"))
    wfile.flush()


def recv_msg(rfile):
    """Read one message; returns None on clean EOF."""
    line = rfile.readline(MAX_LINE)
    if not line:
        return None
    if len(line) >= MAX_LINE:
        raise ValueError(f"message exceeds {MAX_LINE} bytes")
    return json.loads(line.decode("utf-8"))

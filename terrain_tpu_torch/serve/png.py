"""A small PNG codec on numpy and zlib, for the server's png payloads.

The port depends on no image library.  `encode_png` writes 8- or 16-bit
gray or RGB images with the "Up" filter on every row (smooth terrain
compresses well under it, and it is vectorized both ways).  `decode_png`
reads any non-interlaced 8/16-bit gray, gray+alpha, RGB or RGBA PNG; rows
with the Average or Paeth filter are undone by a per-pixel loop, which is
slow but only needed for PNGs other encoders wrote.
"""

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR.items()}


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img, level=3):
    """img (H, W), (H, W, 1) or (H, W, 3) of uint8 or uint16 -> PNG bytes."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[-1] not in (1, 3):
        raise ValueError(f"expected (H, W, 1|3), got shape {a.shape}")
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"expected uint8 or uint16, got {a.dtype}")
    if not 0 <= int(level) <= 9:
        raise ValueError(f"zlib level must be in [0, 9], got {level}")
    h, w, c = a.shape
    raw = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = raw.view(np.uint8).reshape(h, w * c * (depth // 8))
    up = rows.copy()
    up[1:] -= rows[:-1]                  # filter 2 (Up), modulo 256
    data = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), int(level)))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype, row, prev, bpp):
    if ftype == 0:
        return row
    if ftype == 1:   # Sub: running sum along the row, per byte of a pixel
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:   # Up
        return row + prev
    out = row.astype(np.int32)
    p = prev.astype(np.int32)
    for i in range(out.size):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            out[i] = (out[i] + (left + p[i]) // 2) & 0xFF
        elif ftype == 4:
            ul = p[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, p[i], ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out.astype(np.uint8)


def decode_png(buf):
    """PNG bytes -> (H, W, C) uint8 or uint16 array."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        prev = out[r] = _unfilter_row(int(raw[r, 0]), raw[r, 1:], prev, bpp)
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    return img.reshape(h, w, c)

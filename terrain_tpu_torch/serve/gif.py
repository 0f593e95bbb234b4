"""Animated GIF for the port's clips (tools/render_clip.py), without an
image library.

`write_gif(path, frames, 40)` writes what
`imageio.v3.imwrite(path, frames, duration=40, loop=0)` writes through
Pillow 12.1.0's GIF plugin (GifImagePlugin `_normalize_mode`,
`_normalize_palette`, `_get_optimize`, `_getbbox`,
`_write_multiple_frames`): GIF89a with a NETSCAPE2.0 loop block and each
frame's delay (duration / 10, in hundredths of a second); a frame equal to
the one before it merged into it, its duration added; each later frame
cropped to the bounding box of its difference from the frame before, with
its own colour table and the pixels that did not change made transparent
(an index the frame does not use); a single frame interlaced when both
sides are at least 16.  Gray frames keep their values exactly (a table of
the values used), and so do colour frames of at most 256 colours; a
full-colour frame gets an adaptive palette of at most 256 entries by the
median cut that Pillow's `convert("P", palette=ADAPTIVE)` runs
(csrc/gif_encode.cpp, which also does the LZW coding; built at first use
with the host compiler, without one encoding raises).  The median cut is
rebuilt from Quant.c's rules, not from its code, so a full-colour frame is
held to an error bound against Pillow's, not to Pillow's bytes.  The
frames are quantized on host threads, one frame each; the differences are
then taken in order.

`read_gif` gives what `imageio.v3.imread` gives for such a file: the
frames composited, (N, H, W, 3) uint8.  It reads the GIFs that this
module and Pillow write (disposal 0 or 1); it is no TERRAIN_RASTER input
(data/raster.py refuses GIF, as the JAX package's crop iterator cannot
train from a frame axis).
"""

import concurrent.futures
import ctypes
import functools
import math
import os
import struct

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "gif_encode.cpp")
_THREADS = min(8, os.cpu_count() or 1)
_OPTIMIZE_PIXELS = 512 * 512  # Pillow compacts a palette below this size


@functools.lru_cache(maxsize=None)
def _lib():
    from terrain_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(_build.build_host(_SRC))
    lib.gif_quantize.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.gif_quantize.restype = ctypes.c_int
    lib.gif_lzw_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.gif_lzw_encode.restype = ctypes.c_int64
    lib.gif_lzw_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.gif_lzw_decode.restype = ctypes.c_int64
    return lib


def quantize(rgb):
    """rgb (H, W, 3) uint8 -> (palette (n, 3) uint8, indices (H, W)
    uint8): the median cut of csrc/gif_encode.cpp, at most 256 entries."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3), got shape {rgb.shape}")
    pal = np.zeros((256, 3), np.uint8)
    idx = np.empty(rgb.shape[:2], np.uint8)
    n = ctypes.c_int32()
    if _lib().gif_quantize(rgb.ctypes.data, idx.size, 256,
                           pal.ctypes.data, ctypes.byref(n), idx.ctypes.data):
        raise MemoryError("GIF: out of memory quantizing a frame")
    return pal[:n.value].copy(), idx


def _normalize(frame):
    """One frame -> (indices (H, W) uint8, palette (n, 3) uint8) as
    Pillow's `_normalize_mode` and `_normalize_palette` leave it with
    optimize on: gray (an L image) through a table of the values it uses;
    colour through the median cut, its unused entries dropped below
    512x512 pixels where they leave holes."""
    if frame.dtype != np.uint8:
        raise NotImplementedError(f"GIF: frames of {frame.dtype}; the port "
                                  f"writes uint8 gray or RGB frames")
    if frame.ndim == 2:
        used = np.flatnonzero(np.bincount(frame.ravel(), minlength=256))
        lut = np.zeros(256, np.uint8)
        lut[used] = np.arange(used.size)
        return lut[frame], np.repeat(used.astype(np.uint8)[:, None], 3, 1)
    if frame.ndim != 3 or frame.shape[-1] != 3:
        raise NotImplementedError(f"GIF: frames of shape {frame.shape}; the "
                                  f"port writes (H, W) gray or (H, W, 3) RGB")
    pal, idx = quantize(frame)
    if idx.size < _OPTIMIZE_PIXELS:
        used = np.flatnonzero(np.bincount(idx.ravel(), minlength=256))
        if used[-1] >= used.size:  # holes: keep the entries used
            lut = np.zeros(256, np.uint8)
            lut[used] = np.arange(used.size)
            return lut[idx], pal[used]
    return idx, pal


def _table_size(n):
    """The colour table size field of n entries (Pillow's
    `_get_color_table_size`): the table holds 2 << size entries."""
    return 1 if n * 3 < 9 else math.ceil(math.log(n, 2)) - 1


def _table(pal):
    size = _table_size(len(pal))
    out = np.zeros((2 << size, 3), np.uint8)
    out[:len(pal)] = pal
    return size, out.tobytes()


def _lzw(idx):
    """Indices -> the image data: the minimum code size (8, as Pillow
    writes it), the code stream's sub-blocks and the terminator."""
    flat = np.ascontiguousarray(idx, np.uint8).reshape(-1)
    cap = 2 * flat.size + 1024
    out = np.empty(cap, np.uint8)
    n = _lib().gif_lzw_encode(flat.ctypes.data, flat.size, 8,
                              out.ctypes.data, cap)
    if n < 0:
        raise AssertionError("GIF: the LZW buffer was too small")
    return b"\x08" + out[:n].tobytes()


def _frame_block(idx, pal, offset, duration, transparency, local, interlace):
    """The graphic control extension (where there is something to say), the
    image descriptor, the local table and the data of one frame."""
    out = b""
    delay = int(duration / 10) if duration else 0
    if transparency is not None or delay:
        out += (b"!\xf9\x04" + bytes([1 if transparency is not None else 0])
                + struct.pack("<H", delay)
                + bytes([transparency or 0]) + b"\x00")
    h, w = idx.shape
    flags = 64 if interlace else 0
    table = b""
    if local:
        size, table = _table(pal)
        flags |= 128 | size
    out += (b"," + struct.pack("<4H", offset[0], offset[1], w, h)
            + bytes([flags]) + table)
    if interlace:
        idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
    return out + _lzw(idx)


def _header(w, h, pal):
    """GIF89a, the screen, the global table and the NETSCAPE2.0 block of
    loop 0 (for ever)."""
    size, table = _table(pal)
    return (b"GIF89a" + struct.pack("<2H", w, h)
            + bytes([size + 128, 0, 0]) + table
            + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")


def _transparency(idx, n):
    """Pillow's `_new_color_index`: the first index past the palette, else
    the highest index the frame does not use, else none."""
    if n < 256:
        return n
    unused = np.flatnonzero(np.bincount(idx.ravel(), minlength=256) == 0)
    return int(unused[-1]) if unused.size else None


def encode_gif(frames, duration):
    """A list of frames of one shape, uint8 gray (H, W) or RGB (H, W, 3),
    -> the bytes of an animated GIF, as imageio.v3.imwrite(...,
    duration=duration, loop=0) writes them (module docstring)."""
    if not len(frames):
        raise ValueError("GIF: no frames")
    batch = np.stack([np.asarray(f) for f in frames])
    with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
        norm = list(pool.map(_normalize, batch))
    kept = []  # [indices, palette, bbox, duration, transparency, written]
    prev = None
    for idx, pal in norm:
        if kept:
            pidx, ppal = prev
            if pal.shape == ppal.shape and np.array_equal(pal, ppal):
                changed = idx != pidx
            else:
                changed = (pal[idx] != ppal[pidx]).any(-1)
            if not changed.any():
                if duration:
                    kept[-1][3] += duration
                continue
            rows = np.flatnonzero(changed.any(1))
            cols = np.flatnonzero(changed.any(0))
            bbox = (int(cols[0]), int(rows[0]), int(cols[-1]) + 1,
                    int(rows[-1]) + 1)
            trans = _transparency(idx, len(pal))
            written = idx
            if trans is not None:
                written = np.where(changed, idx, np.uint8(trans))
            kept.append([idx, pal, bbox, duration, trans, written])
        else:
            kept.append([idx, pal, None, duration, None, idx])
        prev = (idx, pal)
    h, w = kept[0][0].shape
    if len(kept) == 1:  # Pillow's single frame: interlaced where it can be
        idx, pal, _, dur, _, _ = kept[0]
        return (_header(w, h, pal)
                + _frame_block(idx, pal, (0, 0), dur, None, False,
                               min(w, h) >= 16) + b";")
    out = [_header(w, h, kept[0][1])]
    for idx, pal, bbox, dur, trans, written in kept:
        if bbox is None:
            out.append(_frame_block(written, pal, (0, 0), dur, None, False,
                                    False))
            continue
        x0, y0, x1, y1 = bbox
        out.append(_frame_block(written[y0:y1, x0:x1], pal, (x0, y0), dur,
                                trans, True, False))
    out.append(b";")
    return b"".join(out)


def write_gif(path, frames, duration):
    """`encode_gif` into the file at `path`."""
    data = encode_gif(frames, duration)
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------------ reading
def _sub_blocks(buf, pos):
    """The payloads of the sub-blocks at `pos`, joined, and the position
    after their terminator."""
    parts = []
    while True:
        if pos >= len(buf):
            raise ValueError("GIF: the data ends inside a block")
        n = buf[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(buf[pos:pos + n])
        pos += n


def _ramp(table):
    """Whether a colour table is the gray ramp 0, 1, 2, ... (Pillow then
    reads the frame as L, not P)."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return bool((t == np.arange(len(t))[:, None]).all())


def _parse(buf):
    """GIF bytes -> (width, height, global table or None, loop or None,
    [frame dicts: x, y, w, h, table, interlace, data, min_code,
    transparency, duration, disposal])."""
    buf = bytes(buf)
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("GIF: not a GIF file")
    w, h, flags = struct.unpack("<HHB", buf[6:11])
    pos = 13
    gtable = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        gtable = buf[pos:pos + n]
        pos += n
    loop, frames = None, []
    gce = {}
    while pos < len(buf):
        kind = buf[pos]
        pos += 1
        if kind == 0x3B:  # trailer
            break
        if kind == 0x21:  # an extension
            label = buf[pos]
            data, pos = _sub_blocks(buf, pos + 1)
            if label == 0xF9 and len(data) >= 4:
                gce = {"transparency": data[3] if data[0] & 1 else None,
                       "duration": struct.unpack("<H", data[1:3])[0] * 10,
                       "disposal": (data[0] >> 2) & 7}
            elif label == 0xFF and data.startswith(b"NETSCAPE2.0") and \
                    len(data) >= 14 and data[11] == 1:
                loop = struct.unpack("<H", data[12:14])[0]
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unknown block 0x{kind:02x} at {pos - 1}")
        x, y, fw, fh, fflags = struct.unpack("<4HB", buf[pos:pos + 9])
        pos += 9
        table = None
        if fflags & 128:
            n = 3 << ((fflags & 7) + 1)
            table = buf[pos:pos + n]
            pos += n
        min_code = buf[pos]
        data, pos = _sub_blocks(buf, pos + 1)
        frames.append({"x": x, "y": y, "w": fw, "h": fh, "table": table,
                       "interlace": bool(fflags & 64), "data": data,
                       "min_code": min_code, **{"transparency": None,
                                                "duration": None,
                                                "disposal": 0, **gce}})
        gce = {}
    if not frames:
        raise ValueError("GIF: no image in the file")
    return w, h, gtable, loop, frames


def _indices(fr):
    n = fr["w"] * fr["h"]
    out = np.zeros(n, np.uint8)
    data = np.frombuffer(fr["data"], np.uint8)
    got = _lib().gif_lzw_decode(data.ctypes.data, data.size, fr["min_code"],
                                out.ctypes.data, n)
    if got < 0:
        raise ValueError("GIF: a bad LZW code")
    idx = out.reshape(fr["h"], fr["w"])
    if fr["interlace"]:
        rows = np.concatenate([np.arange(0, fr["h"], 8),
                               np.arange(4, fr["h"], 8),
                               np.arange(2, fr["h"], 4),
                               np.arange(1, fr["h"], 2)])
        full = np.empty_like(idx)
        full[rows] = idx
        idx = full
    return idx


def _colours(table):
    """A colour table as 256 RGB entries (black past its end)."""
    pal = np.zeros((256, 3), np.uint8)
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)[:256]
    pal[:len(t)] = t
    return pal


def gif_meta(src):
    """{size: (width, height), loop, durations: [ms of each frame]} of a
    GIF (bytes or a path)."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            src = f.read()
    w, h, _, loop, frames = _parse(src)
    return {"size": (w, h), "loop": loop,
            "durations": [f["duration"] for f in frames]}


def read_gif(src):
    """A GIF (bytes or a path) -> the array imageio.v3.imread gives for it
    through Pillow: every frame composited over the ones before,
    (N, H, W, 3) uint8; a single frame on a gray-ramp table, which Pillow
    reads as L, (1, H, W).  Frames on a gray-ramp global table followed by
    more frames, a first frame with a transparent index and disposal 2 or 3
    raise, as the first two do in imageio."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            src = f.read()
    w, h, gtable, _, frames = _parse(src)
    out = np.empty((len(frames), h, w, 3), np.uint8)
    canvas = None
    for i, fr in enumerate(frames):
        if fr["disposal"] in (2, 3):
            raise NotImplementedError(f"GIF: frame {i} has disposal "
                                      f"{fr['disposal']}; read_gif reads "
                                      f"disposal 0 and 1")
        if fr["x"] + fr["w"] > w or fr["y"] + fr["h"] > h:
            raise NotImplementedError(f"GIF: frame {i} reaches past the "
                                      f"logical screen")
        table = fr["table"] if fr["table"] is not None else gtable
        if table is None:
            raise ValueError(f"GIF: frame {i} has no colour table")
        idx = _indices(fr)
        pal = _colours(table)
        x0, y0 = fr["x"], fr["y"]
        region = (slice(y0, y0 + fr["h"]), slice(x0, x0 + fr["w"]))
        if i == 0:
            if fr["transparency"] is not None:
                raise NotImplementedError("GIF: a transparent first frame "
                                          "(imageio gives RGBA frames)")
            if _ramp(table):
                if len(frames) > 1:
                    raise ValueError("GIF: frames on a gray-ramp table read "
                                     "as L and then P, which imageio cannot "
                                     "stack (No packer found from P to L)")
                g = np.zeros((h, w), np.uint8)
                g[region] = idx
                return g[None]
            canvas = np.zeros((h, w, 3), np.uint8)
            canvas[:] = pal[0]
            canvas[region] = pal[idx]
        else:
            if fr["transparency"] is None:
                canvas[region] = pal[idx]
            else:
                keep = idx == fr["transparency"]
                canvas[region] = np.where(keep[..., None], canvas[region],
                                          pal[idx])
        out[i] = canvas
    return out

"""Sun raster decoding for the trainer's raster pairs (TERRAIN_RASTER) and
the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes Sun raster
bytes, and a path of any name but *.sr, through Pillow (SunImagePlugin.py),
and a *.sr path through OpenCV (grfmt_sunras.cpp).  The port depends on no
image library: `decode_sun` reads the 32-byte header here, the rows with
numpy and byte-encoded (run-length) data with the port's host C++
(csrc/raster_decode.cpp's sun_rle, Pillow's SunRleDecode.c), and gives
`imageio.v3.imread`'s array (Pillow 12.1.0, OpenCV 5.0.0, imageio 2.37.4):
  * Pillow: depth 1 (bool (H, W), True where the bit is 0), 4 (gray, each
    sample times 17), 8 (gray), 24 (RGB; BGR in the file unless its type is
    3, RGB) and 32 (the same, then a pad byte: BGRX or RGBX);
    a colour map (type 1, at most 1024 bytes, planar R, G, B) turns depth
    4 and 8 into RGB through it, indices past it black; file types 0-5,
    type 2 byte-encoded (0x80 n v: n + 1 bytes v; 0x80 0: one 0x80; runs
    carry across rows, which hold no padding); raw rows padded to 16 bits;
  * OpenCV (`read_sun` of a *.sr path, data/cvread.py): uint8 (H, W, 3)
    for depths 1, 8 (through the colour map, or gray), 24 (BGR as stored)
    and 32 (a pad byte, then BGR), file types 0 and 1 only, rows padded
    to 16 bits.
What imageio cannot read (another depth or type, a colour map of another
type, a depth-1 image with a colour map, a truncated file) raises
ValueError.  A file of width 1 or 2 whose length field is 1 or 4 is
refused by name (NotImplementedError): Pillow's GIMP brush plugin, tried
before its Sun one, takes its header.
"""

import ctypes
import struct

import numpy as np

from terrain_tpu_torch.data import cvread
from terrain_tpu_torch.serve.png import pillow_bool

MAGIC = b"\x59\xa6\x6a\x95"
EXTENSIONS = (".ras", ".sr")
_MSG = 256


def _bad(what):
    raise ValueError(f"Sun raster: {what}")


def read_header(buf):
    """(width, height, depth, type, map type, map length) of a Sun raster's
    32-byte header, unsigned, as Pillow reads them; ValueError where it is
    cut short or is not one."""
    buf = bytes(buf)
    if len(buf) < 32 or buf[:4] != MAGIC:
        _bad("not a Sun raster header")
    w, h, depth, _, ftype, maptype, maplen = struct.unpack(">7I", buf[4:32])
    return w, h, depth, ftype, maptype, maplen


def _refuse_gimp_brush(head):
    """Pillow tries its GIMP brush plugin before its Sun one, and that one
    takes a header whose second and fifth words (a Sun raster's width and
    length) are 1 or 2 and 1 or 4."""
    w, length = struct.unpack(">I", head[4:8])[0], struct.unpack(
        ">I", head[16:20])[0]
    if w in (1, 2) and length in (1, 4):
        raise NotImplementedError(
            f"Sun raster: a width of {w} and a length field of {length} make "
            f"Pillow open the file as a GIMP brush (GbrImagePlugin), whose "
            f"reading the port does not reproduce")


def check_kind(path, head):
    """Raise NotImplementedError where the 32-byte header `head` of a file
    at `path` is one the port refuses (read through Pillow, a GIMP brush's
    header); ValueError where it is not a Sun raster's."""
    read_header(head)
    if cvread.reader(path, True) == "pillow":
        _refuse_gimp_brush(bytes(head))


def _rle(src, total):
    """Byte-encoded data through csrc/raster_decode.cpp's sun_rle (the
    library data/tiff.py builds and binds): `total` bytes."""
    from terrain_tpu_torch.data.tiff import _lib

    src = np.frombuffer(src, np.uint8)
    out = np.empty(total, np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().sun_rle(src.ctypes.data, src.size, out.ctypes.data, total,
                      msg, _MSG):
        _bad(msg.value.decode(errors="replace"))
    return out


def _rows(buf, at, h, row, stride, last):
    """The rows as stored, each `stride` bytes; the last needs `last`."""
    if len(buf) - at < stride * (h - 1) + last:
        _bad("the pixel data is cut short")
    flat = np.zeros(stride * h, np.uint8)
    got = np.frombuffer(buf, np.uint8, min(stride * h, len(buf) - at), at)
    flat[:got.size] = got
    return flat.reshape(h, stride)[:, :row]


def decode_sun(buf):
    """Sun raster bytes -> the array imageio.v3.imread returns (through
    Pillow)."""
    buf = bytes(buf)
    w, h, depth, ftype, maptype, maplen = read_header(buf)
    _refuse_gimp_brush(buf)
    if not w or not h:
        _bad(f"a {w}x{h} image")
    if depth not in (1, 4, 8, 24, 32):
        _bad(f"depth {depth}")
    if maplen > 1024 or (maplen and maptype != 1):
        _bad(f"a colour map of type {maptype} and {maplen} bytes")
    if ftype > 5:
        _bad(f"file type {ftype}")
    if depth == 1 and maplen:
        _bad("a depth-1 image with a colour map (Pillow cannot load one)")
    at = 32 + maplen
    row = (w * depth + 7) // 8
    if ftype == 2:
        px = _rle(buf[at:], row * h).reshape(h, row)
    else:
        # Pillow's raw decoder needs no padding after the last row
        px = _rows(buf, at, h, row, ((w * depth + 15) // 16) * 2, row)
    if depth == 1:
        return pillow_bool(np.unpackbits(px, axis=1)[:, :w] == 0)
    if depth == 4:
        px = np.stack([px >> 4, px & 15], -1).reshape(h, -1)[:, :w]
    if depth <= 8:
        if not maplen:
            return np.ascontiguousarray(px * np.uint8(17) if depth == 4
                                        else px)
        n = maplen // 3
        cmap = np.frombuffer(buf, np.uint8, 3 * n, 32).reshape(3, n).T
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = cmap[:256]
        return pal[px]
    px = px.reshape(h, w, depth // 8)[..., :3]
    return np.ascontiguousarray(px if ftype == 3 else px[..., ::-1])


def decode_sun_cv(buf):
    """Sun raster bytes -> the array imageio gives through OpenCV's reader:
    uint8 (H, W, 3)."""
    buf = bytes(buf)
    w, h, depth, ftype, maptype, maplen = read_header(buf)
    if depth not in (1, 8, 24, 32):
        _bad(f"depth {depth} (OpenCV reads 1, 8, 24 and 32)")
    if ftype not in (0, 1):
        _bad(f"file type {ftype} (OpenCV reads types 0 and 1)")
    if not ((maptype == 0 and maplen == 0) or (
            maptype == 1 and 0 < maplen <= 3 << depth and depth <= 8)):
        _bad(f"a colour map of type {maptype} and {maplen} bytes")
    if len(buf) < 32 + maplen:
        _bad("the colour map is cut short")
    cvread.check_size(w, h, "Sun raster")
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    px = _rows(buf, 32 + maplen, h, (w * depth + 7) // 8, pitch, pitch)
    if depth > 8:  # BGR, or a pad byte then BGR
        bgr = px.reshape(h, w, depth // 8)[..., -3:]
        return cvread.colour(bgr)
    if depth == 1:
        px = np.unpackbits(px, axis=1)[:, :w]
    pal = np.zeros((256, 3), np.uint8)
    if maplen:
        n = maplen // 3
        pal[:n] = np.frombuffer(buf, np.uint8, 3 * n, 32).reshape(3, n).T
    else:
        pal[:1 << depth] = np.linspace(0, 255, 1 << depth).astype(
            np.uint8)[:, None]
    return pal[px]


def read_sun(path):
    """A Sun raster decoded as imageio.v3.imread(path) gives it: a *.sr path
    through OpenCV, any other through Pillow."""
    with open(path, "rb") as f:
        buf = f.read()
    if cvread.reader(path, True) == "opencv":
        return decode_sun_cv(buf)
    return decode_sun(buf)

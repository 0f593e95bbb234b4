"""Windows icon (ICO) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes an ICO
(*.ico; magic 00 00 01 00) through Pillow (IcoImagePlugin.py).  The port
depends on no image library: `decode_ico` reads the directory here and
gives `imageio.v3.imread`'s array (Pillow 12.1.0, imageio 2.37.4) of the
entry Pillow loads:
  * the entries sorted by colour depth (the bit count, else the log2 of
    the colour count rounded up, else 256), then, stably, by area, largest
    first; a width or height of 0 means 256; the first entry is read;
  * a PNG entry through serve/png.py, as imageio reads that PNG (any
    colour type and depth; its own size where it differs from the
    directory's);
  * a DIB entry (a BMP without its 14-byte file header) through
    data/bmp.py at half the stored height, then RGBA: alpha from the
    fourth byte of each 4-byte pixel where the directory names 32 bits,
    else from the 1-bit AND mask (rows padded to 32 bits, bottom-up,
    transparent where set), which Pillow finds at the entry's end by the
    directory's size field.
What imageio fails on raises what it raises there: SyntaxError where
Pillow does not identify the file (a cut directory, no entries, an entry
that is neither a PNG nor a DIB header, a PNG entry cut in a chunk header
or checksum before its first IDAT), OSError for a DIB header Pillow does
not read or cut pixel data or a PNG entry cut elsewhere, ValueError for a
cut alpha or AND mask.
A DIB with run-length or BI_BITFIELDS pixels, a top-down DIB or one of
fewer than 2 stored rows are refused by name (no fixture holds them).
"""

import math
import struct

import numpy as np

from terrain_tpu_torch.data.bmp import decode_bmp
from terrain_tpu_torch.data import pillow_open
from terrain_tpu_torch.serve.png import check_open as check_png_open
from terrain_tpu_torch.serve.png import read_png

MAGIC = b"\x00\x00\x01\x00"
EXTENSIONS = (".ico",)
_PNG = b"\x89PNG\r\n\x1a\n"
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _unidentified(what):
    raise SyntaxError(f"ICO: Pillow does not identify the file ({what})")


def entries(buf):
    """The directory as Pillow sorts it: [(width, height, bpp, size,
    offset)], the entry it loads first."""
    buf = bytes(buf)
    if buf[:4] != MAGIC:
        _unidentified("no ICO magic")
    if len(buf) < 6:
        _unidentified("the header is cut short")
    (n,) = struct.unpack("<H", buf[4:6])
    if len(buf) < 6 + 16 * n:
        _unidentified(f"a directory of {n} entries cut short")
    out = []
    for i in range(n):
        e = buf[6 + 16 * i:22 + 16 * i]
        w, h, ncolor = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack("<HII", e[6:16])
        depth = bpp or (ncolor and math.ceil(math.log(ncolor, 2))) or 256
        out.append((depth, w * h, (w, h, bpp, size, offset)))
    out.sort(key=lambda x: x[0])
    out.sort(key=lambda x: x[1], reverse=True)
    if not out:
        _unidentified("no entries")
    return [x[2] for x in out]


def _dib(buf, offset):
    """(the DIB at `offset` as a BMP file at half its stored height, the
    pixel data's offset in `buf`, width, height)."""
    head = buf[offset:offset + 4]
    if len(head) < 4:
        _unidentified("a DIB header cut short")
    (hsize,) = struct.unpack("<I", head)
    if len(buf) - offset - 4 < hsize - 4:
        raise OSError("ICO: the DIB header is cut short (Truncated File "
                      "Read)")
    if hsize not in _DIB_HEADERS:
        raise OSError(f"ICO: a DIB header of {hsize} bytes (Unsupported BMP "
                      f"header type)")
    d = bytearray(buf[offset:])
    if hsize == 12:
        w, h, _, bits = struct.unpack("<4H", d[4:12])
        comp, colors, pad, top_down = 0, 0, 3, False
    else:
        w, h, _, bits, comp = struct.unpack("<iIHHI", d[4:20])
        (colors,) = struct.unpack("<I", d[32:36])
        pad, top_down = 4, d[11] == 0xFF
        h = 2 ** 32 - h if top_down else h  # Pillow's reading of the sign
    if w <= 0 or h <= 0:
        _unidentified(f"a {w}x{h} DIB")
    if comp not in (0,) or top_down or h < 2:
        raise NotImplementedError(
            f"ICO: a DIB entry of compression {comp}"
            f"{', top-down' if top_down else ''}, {h} stored rows; the port "
            f"reads bottom-up, uncompressed DIBs of 2 or more rows")
    colors = colors or 1 << bits
    at = hsize + (pad * colors if bits in (1, 4, 8) else 0)
    if hsize == 12:
        d[6:8] = struct.pack("<H", h // 2)
    else:
        d[8:12] = struct.pack("<i", h // 2)
    fake = b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + at) + bytes(d)
    return fake, offset + at, w, h // 2


def check_header(buf):
    """Raise as `decode_ico` does for the directory and the header of the
    entry Pillow loads, before any pixel is decoded."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    w, h, bpp, size, offset = entries(buf)[0]
    if buf[offset:offset + 8] == _PNG:
        check_png_open(buf[offset:])
    else:
        _dib(buf, offset)


def _rgba(px):
    """Pillow's convert("RGBA") of a decoded DIB."""
    if px.ndim == 2:
        px = px.view(np.uint8) if px.dtype == bool else px
        px = np.repeat(px[..., None], 3, -1)
    if px.shape[-1] == 4:
        return px.copy()
    return np.concatenate([px, np.full(px.shape[:2] + (1,), 255, np.uint8)],
                          -1)


def decode_ico(buf, from_path=False):
    """ICO bytes -> the array imageio.v3.imread returns (through Pillow);
    `from_path`: read from a file, where an AND mask before the file's
    start fails as a file's seek fails."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    w, h, bpp, size, offset = entries(buf)[0]
    if buf[offset:offset + 8] == _PNG:
        check_png_open(buf[offset:])
        return read_png(buf[offset:])
    fake, at, w, h = _dib(buf, offset)
    if bpp == 32:
        alpha = np.frombuffer(buf[at:at + 4 * w * h], np.uint8)[3::4]
        if alpha.size < w * h:
            raise ValueError("ICO: the alpha bytes are cut short (buffer is "
                             "not large enough)")
        alpha = alpha[:w * h].reshape(h, w)[::-1]
    else:
        stride = (w + 31) // 32 * 4
        start = offset + size - stride * h
        if start < 0:
            if from_path:
                raise OSError(22, "ICO: the AND mask lies before the file's "
                                  "start")
            raise ValueError("ICO: the AND mask lies before the file's start "
                             "(negative seek value)")
        mask = np.zeros(stride * h, np.uint8)
        got = np.frombuffer(buf[start:start + stride * h], np.uint8)
        if got.size < stride * (h - 1) + (w + 7) // 8:  # the last row's
            raise ValueError("ICO: the AND mask is cut short (not enough "
                             "image data)")  # padding is not needed
        mask[:got.size] = got
        bits = np.unpackbits(mask.reshape(h, stride), axis=1)[::-1, :w]
        alpha = np.where(bits, 0, 255).astype(np.uint8)
    try:
        px = decode_bmp(fake)
    except ValueError as e:
        raise OSError(f"ICO: image file is truncated ({e})") from e
    px = _rgba(px)
    px[..., 3] = alpha
    return px

"""Radiance HDR (RGBE) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a Radiance
file (*.hdr, *.pic, or its bytes) through OpenCV (grfmt_hdr.cpp and
rgbe.cpp).  The port depends on no image library: `decode_hdr` reads the
header here as OpenCV's RGBE_ReadHeader does, the scanlines with the
port's host C++ (csrc/raster_decode.cpp's hdr_pixels, RGBE_ReadPixels_RLE),
and gives `imageio.v3.imread`'s array (OpenCV 5.0.0, imageio 2.37.4):
uint8 (H, W, 3), the channels as stored, each m * 2^(e - 136) in float32
(0 where e is 0) times 255 in float32, rounded half to even and saturated
(data/cvread.py).  The header: lines of at most 127 bytes (fgets into 128);
"FORMAT=32-bit_rle_rgbe" must come before the first blank line, other
lines (comments, EXPOSURE, which is not applied) are skipped; then the
resolution line, "-Y <height> +X <width>" (any other orientation fails in
OpenCV, so it raises ValueError here).  A scanline of width 8-32767 that
starts 2 2 <width> holds four run-length channels; the first that does not
makes the rest of the image flat RGBE, old-style runs included, as in
rgbe.cpp.  A damaged or truncated file raises ValueError.
"""

import ctypes
import re

import numpy as np

from terrain_tpu_torch.data import cvread

MAGICS = (b"#?RADIANCE", b"#?RGBE")
EXTENSIONS = (".hdr", ".pic")
_MSG = 256
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y\s*([+-]?[0-9]+)\s*\+X\s*([+-]?[0-9]+)")


def _bad(what):
    raise ValueError(f"HDR: {what}")


def _line(buf, pos):
    """fgets(128): up to 127 bytes, or through a newline; None at the end."""
    if pos >= len(buf):
        _bad("the header ends early")
    nl = buf.find(b"\n", pos, pos + 127)
    end = nl + 1 if nl >= 0 else min(pos + 127, len(buf))
    return buf[pos:end], end


def read_header(buf):
    """(height, width, offset of the pixels) of Radiance bytes, read as
    OpenCV reads them; ValueError where OpenCV fails."""
    buf = bytes(buf)
    if not buf.startswith(MAGICS):
        _bad("not a Radiance file (#?RADIANCE or #?RGBE)")
    pos, found = 0, False
    while True:
        line, pos = _line(buf, pos)
        text = line.split(b"\0")[0]
        if line == b"\n":  # a blank line ends the header
            if not found:
                _bad("no FORMAT=32-bit_rle_rgbe line before the blank one")
            break
        found = found or text == _FORMAT
    line, pos = _line(buf, pos)
    m = _SIZE.match(line.split(b"\0")[0])
    if not m:
        _bad(f"the resolution line {line[:40]!r} is not -Y <h> +X <w>")
    h, w = int(m.group(1)), int(m.group(2))
    cvread.check_size(w, h, "HDR")
    return h, w, pos


def decode_hdr(buf):
    """Radiance bytes -> the array imageio.v3.imread returns (through
    OpenCV)."""
    from terrain_tpu_torch.data.tiff import _lib

    buf = bytes(buf)
    h, w, pos = read_header(buf)
    src = np.frombuffer(buf, np.uint8, len(buf) - pos, pos)
    rgbe = np.empty((h, w, 4), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().hdr_pixels(src.ctypes.data, src.size, w, h, rgbe.ctypes.data,
                         msg, _MSG):
        raise ValueError(msg.value.decode(errors="replace"))
    e = rgbe[..., 3:].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), np.float32(0))
    v = rgbe[..., :3].astype(np.float32) * f.astype(np.float32)
    return cvread.to_u8(v, 255.0)

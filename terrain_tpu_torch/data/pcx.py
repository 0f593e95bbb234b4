"""PCX decoding for the trainer's raster pairs (TERRAIN_RASTER) and the
port's dataset tools.

The JAX package reads its rasters with imageio, which has no plugin of its
own for a *.pcx path here (it lists only pyav) and so tries every plugin,
Pillow first (PcxImagePlugin.py, PcxDecode.c).  The port depends on no
image library: `decode_pcx` reads the 128-byte header here, the scan lines
with the port's host C++ (csrc/raster_decode.cpp's pcx_rle) and unpacks
them with numpy, giving `imageio.v3.imread`'s array (Pillow 12.1.0,
imageio 2.37.4) for the four kinds Pillow opens:
  * 1 bit in 1 plane: bool (H, W);
  * 1 bit in 2 or 4 planes: indices into the header's 16-colour palette,
    (H, W, 3) RGB;
  * version 5, 8 bits in 1 plane: gray (H, W), or (H, W, 3) through the
    256-colour palette of a 769-byte trailer that starts with 12 and is
    not the gray ramp;
  * version 5, 8 bits in 3 planes: (H, W, 3) RGB, the planes of each line
    one after the other.
The scan line is Pillow's: (width x bits + 7) // 8 bytes a plane, one more
where that is odd and the header's stride differs; Pillow's decoder moves
the padded planes of a line together, except where its test of the
padding misses (a 3-pixel RGB line), and its unpacker reads them there.  A run may not cross the end of
a line.  What imageio fails on raises what it raises there: SyntaxError
for a header cut short or an empty box, OSError for
another kind, a truncated file or a run that crosses a line, and, at a
path, for an 8-bit file shorter than its 769-byte trailer (a seek before
the file's start; from bytes the seek stops at 0 and the file is gray).
"""

import ctypes
import struct

import numpy as np

from terrain_tpu_torch.data import pillow_open

from terrain_tpu_torch.serve.png import pillow_bool

EXTENSIONS = (".pcx",)
_MSG = 256


def read_header(buf):
    """(version, bits, planes, width, height, stride) of a PCX header as
    Pillow reads it; SyntaxError where Pillow does not identify the file
    (imageio's legacy PCX reader then raises that), OSError for a kind it
    does not read."""
    buf = bytes(buf[:128])
    if len(buf) < 2 or buf[0] != 10 or buf[1] not in (0, 2, 3, 5):
        raise SyntaxError("PCX: not a PCX file")
    if len(buf) < 68:
        raise SyntaxError("PCX: the header is cut short")
    x0, y0, x1, y1 = struct.unpack("<4H", buf[4:12])
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise SyntaxError("PCX: bad PCX image size")
    version, bits, planes = buf[1], buf[3], buf[65]
    if not ((bits == 1 and planes in (1, 2, 4))
            or (version == 5 and bits == 8 and planes in (1, 3))):
        raise OSError(f"PCX: unknown PCX mode (version {version}, {bits} "
                       f"bits, {planes} planes)")
    stride = (w * bits + 7) // 8
    if struct.unpack("<H", buf[66:68])[0] != stride:
        stride += stride % 2
    return version, bits, planes, w, h, stride


def _lines(buf, h, nbytes, w, bits):
    from terrain_tpu_torch.data.tiff import _lib

    src = np.frombuffer(buf, np.uint8, offset=128) if len(buf) > 128 \
        else np.zeros(0, np.uint8)
    out = np.empty((h, nbytes), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().pcx_rle(src.ctypes.data, src.size, nbytes, w, bits, h,
                      out.ctypes.data, msg, _MSG):
        raise OSError(f"PCX: {msg.value.decode(errors='replace')}")
    return out


def _bits(lines, at, w):
    return np.unpackbits(lines[:, at:at + (w + 7) // 8], axis=1)[:, :w]


def decode_pcx(buf, from_path=False):
    """PCX bytes -> the array imageio.v3.imread returns (through Pillow);
    `from_path`: the bytes were read from a file, where an 8-bit file
    too short for its trailer fails as a file's seek fails."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    version, bits, planes, w, h, stride = read_header(buf)
    palette = None
    if bits == 8 and planes == 1:
        if len(buf) < 769 and from_path:
            raise OSError(22, "PCX: seek to the trailer before the file's "
                              "start")
        tail = np.frombuffer(buf, np.uint8, min(769, len(buf)),
                             max(0, len(buf) - 769))
        ramp = np.repeat(np.arange(256, dtype=np.uint8), 3)
        if tail.size == 769 and tail[0] == 12 and not np.array_equal(
                tail[1:], ramp):
            palette = tail[1:].reshape(256, 3)
    # the unpacker's sample size: P;2L and P;4L take 2 and 4 bits
    lines = _lines(buf, h, planes * stride, w, bits * planes)
    if bits == 1:
        s = (w + 7) // 8  # Pillow's decoder moved the planes together
        px = sum(_bits(lines, k * s, w) << k for k in range(planes))
        if planes == 1:
            return pillow_bool(px.astype(bool))
        pal = np.frombuffer(buf, np.uint8, 48, 16).reshape(16, 3)
        return pal[px]
    if planes == 3:
        return np.ascontiguousarray(
            lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    px = np.ascontiguousarray(lines[:, :w])
    return px if palette is None else palette[px]

"""JPEG decoding for the trainer's raster pairs (TERRAIN_RASTER) and the
port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a JPEG
through Pillow and libjpeg-turbo.  The port depends on no image library:
`decode_jpeg` runs the port's own decoder in host C++
(csrc/jpeg_decode.cpp, built at first use with the host compiler; without
one decoding raises), which reproduces libjpeg-turbo's default integer
routines and so gives `imageio.v3.imread`'s bytes: (H, W) for a grayscale
file, (H, W, 3) RGB for a YCbCr one.

It takes Huffman JPEGs of 8-bit samples, sampling factors up to 2x2 and
restart intervals: sequential ones (SOF0, SOF1) of one interleaved scan,
and progressive ones (SOF2), with libjpeg-turbo's block smoothing where a
file leaves coefficients unrefined (one cut after an early scan).  Held
byte-equal to imageio under Pillow 12.1.0 with libjpeg-turbo 3.1.3.  A
progressive image holds all its coefficients while it decodes (128 bytes a
block: ~700 MB for a 21600x10800 4:2:0 texture, beside the output).  Any
other kind (lossless, arithmetic-coded, 12-bit, CMYK or RGB-coded, or
sequential of several scans) raises NotImplementedError naming it; a
damaged file raises ValueError, and one cut short where imageio raises
OSError (in a segment's data, or anywhere after the first scan begins)
raises `Truncated`, both an OSError and a ValueError.  A file of fewer
than 3 bytes fails as imageio fails on it (data/pillow_open.py).
"""

import ctypes
import functools
import os

import numpy as np

from terrain_tpu_torch.data import pillow_open

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "jpeg_decode.cpp")
_MSG = 256


@functools.lru_cache(maxsize=None)
def _lib():
    from terrain_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(_build.build_host(_SRC))
    for fn, out in ((lib.jpeg_header, ctypes.c_void_p),
                    (lib.jpeg_decode, ctypes.c_void_p)):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, out,
                       ctypes.c_char_p, ctypes.c_int64]
        fn.restype = ctypes.c_int
    return lib


class Truncated(OSError, ValueError):
    """A JPEG cut short: Pillow's OSError there, and a damaged file."""


def _raise(rc, msg):
    text = msg.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(f"JPEG: {text}")
    raise (Truncated if rc == 3 else ValueError)(f"JPEG: {text}")


def read_header(buf):
    """(height, width, components) of a JPEG the decoder takes; raises
    as `decode_jpeg` does for any other."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf, 3)
    hwc = np.zeros(3, np.int64)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().jpeg_header(buf, len(buf), hwc.ctypes.data, msg, _MSG)
    if rc:
        _raise(rc, msg)
    return tuple(int(v) for v in hwc)


def decode_jpeg(buf):
    """JPEG bytes -> uint8 (H, W) (one component) or (H, W, 3) (YCbCr,
    converted to RGB), the bytes imageio.v3.imread returns."""
    buf = bytes(buf)
    h, w, c = read_header(buf)
    out = np.empty((h, w, c), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().jpeg_decode(buf, len(buf), out.ctypes.data, msg, _MSG)
    if rc:
        _raise(rc, msg)
    return out[..., 0] if c == 1 else out

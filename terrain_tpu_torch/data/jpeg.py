"""Baseline JPEG decoding for the trainer's raster pairs (TERRAIN_RASTER).

The JAX package reads its rasters with imageio, which decodes a JPEG
through Pillow and libjpeg-turbo.  The port depends on no image library:
`decode_jpeg` runs the port's own decoder in host C++
(csrc/jpeg_decode.cpp, built at first use with the host compiler; without
one decoding raises), which reproduces libjpeg-turbo's default integer
routines and so gives `imageio.v3.imread`'s bytes: (H, W) for a grayscale
file, (H, W, 3) RGB for a YCbCr one.

It takes sequential Huffman JPEGs (SOF0, SOF1) of 8-bit samples, one
interleaved scan, sampling factors up to 2x2 and restart intervals.  Any
other kind (progressive, lossless, arithmetic-coded, 12-bit, CMYK or
RGB-coded) raises NotImplementedError naming it; a damaged file raises
ValueError.
"""

import ctypes
import functools
import os

import numpy as np

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


def _raise(rc, msg):
    text = msg.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(f"JPEG: {text}")
    raise ValueError(f"JPEG: {text}")


def read_header(buf):
    """(height, width, components) of a JPEG the decoder takes; raises
    as `decode_jpeg` does for any other."""
    buf = bytes(buf)
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

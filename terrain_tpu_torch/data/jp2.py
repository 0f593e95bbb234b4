"""JPEG 2000 decoding for the trainer's raster pairs (TERRAIN_RASTER) and
the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a JP2 file or
a bare codestream (*.j2k, *.j2c, *.jpc) through Pillow's Jpeg2KImagePlugin
and openjpeg, tile by tile, every layer and resolution.  The port depends on
no image library: `decode_jp2` runs the port's own decoder in host C++
(csrc/jp2_decode.cpp, built at first use with the host compiler; without
one decoding raises), which follows openjpeg 2.5's decoder and Pillow's
unpacking and so gives `imageio.v3.imread`'s array:
  1 component    uint8 (H, W), or uint16 (H, W) where Pillow's header
                 reading says "I;16" (a codestream's precision over 8 bits,
                 a JP2 ihdr's over 9), each sample shifted to 8 or 16 bits
                 with Pillow's rounding offset
  2 components   uint8 (H, W, 2), gray and alpha
  3 components   uint8 (H, W, 3); Pillow takes samples of more than 8 bits
                 to 8 as (x + 128) >> 8, wrapping at 256
  4 components   uint8 (H, W, 4), RGBA (or CMYK by a JP2's colr box)
Both wavelets (the 5/3 exactly, the 9/7 in openjpeg's float arithmetic),
the RCT and ICT, every progression order, precincts, layers, tiles and
image offsets are taken; so is a file cut where openjpeg still decodes it
(right after a tile-part's SOT marker code: the tiles read by then, the
rest zero).  Refused by name with NotImplementedError, before any pixel
is decoded: POC, PPM/PPT, RGN, SOP/EPH, code-block styles other than 0,
subsampled components, palettes, sYCC and samples of more than 16 bits.
A damaged file, or one imageio's Pillow plugin fails on, raises
ValueError.  Held bit-equal to imageio under Pillow 12.1.0 with openjpeg
2.5.4 (tests/data/jp2/digests.json).  Tiles are decoded on `threads` host
threads (code-blocks and wavelet rows where there are fewer tiles); the
bits do not depend on the count.
"""

import ctypes
import functools
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "jp2_decode.cpp")
_MSG = 256
THREADS = 8
MAGICS = (b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xffO\xffQ")


@functools.lru_cache(maxsize=None)
def _lib():
    from terrain_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(_build.build_host(_SRC))
    lib.jp2_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int64]
    lib.jp2_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int64]
    lib.jp2_header.restype = lib.jp2_decode.restype = ctypes.c_int
    return lib


def _raise(rc, msg):
    text = msg.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(
            f"{text}; the port decodes JP2 and J2K files without these "
            f"(convert it to PNG)")
    raise ValueError(text)


def read_header(buf):
    """(shape, dtype) of imageio's array for JPEG 2000 bytes the decoder
    takes (the boxes and the codestream's main header are read); raises as
    `decode_jp2` does for any other."""
    buf = bytes(buf)
    info = np.zeros(4, np.int64)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().jp2_header(buf, len(buf), info.ctypes.data, msg, _MSG)
    if rc:
        _raise(rc, msg)
    h, w, c, size = (int(v) for v in info)
    return ((h, w, c) if c else (h, w)), np.dtype(np.uint16 if size == 2
                                                  else np.uint8)


def decode_jp2(buf, threads=THREADS):
    """JP2 or J2K bytes -> the array imageio.v3.imread returns."""
    buf = bytes(buf)
    shape, dtype = read_header(buf)
    out = np.empty(shape, dtype)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().jp2_decode(buf, len(buf), out.ctypes.data, int(threads), msg,
                           _MSG)
    if rc:
        _raise(rc, msg)
    return out

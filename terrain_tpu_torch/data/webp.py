"""WebP decoding for the trainer's raster pairs (TERRAIN_RASTER) and the
port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a WebP
through Pillow's WebPAnimDecoder and libwebp.  The port depends on no image
library: `decode_webp` runs the port's own decoder in host C++
(csrc/webp_decode.cpp, built at first use with the host compiler; without
one decoding raises), which follows libwebp's decoder and so gives
`imageio.v3.imread`'s array: uint8 (H, W, 3), or (H, W, 4) where libwebp
reports alpha (a VP8L header's alpha bit; for VP8, VP8X's alpha flag or an
ALPH chunk -- whose values count only under the flag, else 255).  WebP has
no gray kind: a gray image comes back as three equal channels.

It takes simple files (one VP8 or VP8L chunk) and extended ones (VP8X with
ICCP, EXIF, XMP or unknown chunks, and ALPH before a VP8 image, raw or
VP8L-coded, with any of the four filters): VP8L with every transform, meta
prefix codes and the colour cache; VP8 with segments, either loop filter,
one to eight token partitions, and libwebp's fancy upsampling to RGB.
An animated file (VP8X's animation flag, ANIM, ANMF frames) gives what
imageio gives, its first frame as WebPAnimDecoder composes it: a zeroed
(transparent) canvas of VP8X's size with the frame at its offset, (H, W, 4)
under VP8X's alpha flag, else (H, W, 3).  Held bit-equal to imageio under
Pillow 12.1.0 with libwebp 1.6.0 (tests/data/webp/digests.json).  A
damaged or truncated file raises ValueError, as does a layout libwebp's
demuxer rejects (two ALPH chunks, a chunk between ALPH and the image,
ALPH before a VP8L image, ANMF before ANIM, a frame outside its canvas).  A block's inverse DCT is libwebp's on x86
(its SSE2 routine's 16-bit steps), so even a damaged file that libwebp
decodes comes back with imageio's bytes.
"""

import ctypes
import functools
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "webp_decode.cpp")
_MSG = 256


@functools.lru_cache(maxsize=None)
def _lib():
    from terrain_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(_build.build_host(_SRC))
    for fn in (lib.webp_header, lib.webp_decode):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_int64]
        fn.restype = ctypes.c_int
    return lib


def _raise(rc, msg):
    text = msg.value.decode(errors="replace")
    raise ValueError(text)


def read_header(buf):
    """(height, width, channels) of WebP bytes the decoder takes (the RIFF
    chunks and the image's header are read; an animation's canvas); raises
    as `decode_webp` does for any other."""
    buf = bytes(buf)
    hwc = np.zeros(3, np.int64)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().webp_header(buf, len(buf), hwc.ctypes.data, msg, _MSG)
    if rc:
        _raise(rc, msg)
    return tuple(int(v) for v in hwc)


def decode_webp(buf):
    """WebP bytes -> uint8 (H, W, 3) or (H, W, 4), the array
    imageio.v3.imread returns."""
    buf = bytes(buf)
    h, w, c = read_header(buf)
    out = np.empty((h, w, c), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().webp_decode(buf, len(buf), out.ctypes.data, msg, _MSG)
    if rc:
        _raise(rc, msg)
    return out

"""QOI ("Quite OK Image") decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which knows no *.qoi
extension and so tries every plugin, Pillow first (QoiImagePlugin.py, a
decoder in Python).  The port depends on no image library: `decode_qoi`
reads the 14-byte header here and the ops with the port's host C++
(csrc/raster_decode.cpp's qoi_decode, one thread: each op depends on the
one before), and gives `imageio.v3.imread`'s array (Pillow 12.1.0,
imageio 2.37.4): (H, W, 3) where the header names 3 channels, else
(H, W, 4), uint8.  Pillow's decoder, not the format's specification, is
followed: a run enters nothing in the index, an index entry never set is
(0, 0, 0, 0), the colour space and the 8-byte end marker are not read.
What imageio fails on raises what Pillow raises there: IndexError where
the ops end at an op byte or inside QOI_OP_LUMA, ValueError inside
QOI_OP_RGB or QOI_OP_RGBA, OSError where Pillow does not identify the
file (a header cut short, a zero side).  A width of 1 or 2 is refused by
name: Pillow's GIMP brush reader, tried first, takes such a header.
"""

import ctypes
import struct

import numpy as np

from terrain_tpu_torch.data import pillow_open

MAGIC = b"qoif"
EXTENSIONS = (".qoi",)
_MSG = 256


def read_header(buf):
    """(width, height, channels out: 3 or 4) of a QOI header, as Pillow
    reads it; OSError where Pillow does not identify it (a cut header, a
    zero side): imageio has no other reader of QOI and raises that."""
    buf = bytes(buf[:14])
    if buf[:4] == MAGIC and len(buf) >= 8 and \
            struct.unpack(">I", buf[4:8])[0] in (1, 2):
        raise NotImplementedError(
            "QOI: a width of 1 or 2 makes Pillow try the file as a GIMP brush "
            "(GbrImagePlugin) first, whose reading the port does not "
            "reproduce")
    if buf[:4] != MAGIC or len(buf) < 13:
        raise OSError("QOI: Pillow does not identify the file (no magic, or "
                      "a header cut short)")
    w, h = struct.unpack(">II", buf[4:12])
    if not w or not h:
        raise OSError(f"QOI: Pillow does not identify a {w}x{h} image")
    return w, h, 3 if buf[12] == 3 else 4


def decode_qoi(buf):
    """QOI bytes -> the array imageio.v3.imread returns (through Pillow)."""
    from terrain_tpu_torch.data.tiff import _lib

    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    w, h, bands = read_header(buf)
    src = np.frombuffer(buf, np.uint8, offset=14) if len(buf) > 14 \
        else np.zeros(0, np.uint8)
    out = np.empty((h, w, bands), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().qoi_decode(src.ctypes.data, src.size, w * h, bands,
                           out.ctypes.data, msg, _MSG)
    if rc:
        text = f"QOI: {msg.value.decode(errors='replace')}"
        raise IndexError(text) if rc == 3 else ValueError(text)
    return out

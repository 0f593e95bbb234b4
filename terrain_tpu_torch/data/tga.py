"""TGA decoding for the trainer's raster pairs (TERRAIN_RASTER) and the
port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a TGA
(*.tga, *.icb, *.vda, *.vst) through Pillow (TgaImagePlugin.py).  The port
depends on no image library: `decode_tga` reads the header here, the pixels
with numpy, and run-length packets with the port's host C++
(csrc/raster_decode.cpp's tga_rle, Pillow's TgaRleDecode.c), and gives
`imageio.v3.imread`'s array (Pillow 12.1.0, imageio 2.37.4):
  * image types 1, 2 and 3 and their run-length forms 9, 10 and 11;
  * gray: 1 bit (bool), 8 bits (uint8), 16 bits (gray and alpha, (H, W, 2));
  * true colour: 16 bits (5-5-5, scaled as Pillow scales, alpha 0 where the
    top bit is set, else 255: (H, W, 4)), 24 bits (RGB), 32 (RGBA);
  * a colour map of 24 bits (RGB) or 16 bits (RGBA, as above), its first
    index and length as given up to 256 entries, indices past it black
    (alpha 255);
  * the four origins of the 0x30 flags, as Pillow flips them.
What Pillow cannot read (a 15- or 32-bit colour map, a colour-mapped type
without a map, other depths, run-length 1-bit images) raises ValueError,
as does a damaged or truncated file.  TGA has no magic number: it is known
by its name (data/raster.py).
"""

import ctypes
import struct

import numpy as np

from terrain_tpu_torch.data.bmp import _scale
from terrain_tpu_torch.serve.png import pillow_bool

EXTENSIONS = (".tga", ".icb", ".vda", ".vst")
_MSG = 256
# (image type & 7, depth) -> bytes a pixel, as Pillow's table of raw modes
_MODES = {(1, 8): 1, (3, 1): 0, (3, 8): 1, (3, 16): 2, (2, 16): 2,
          (2, 24): 3, (2, 32): 4}


def _bad(what):
    raise ValueError(f"TGA: {what}")


def _rgba15(v):
    """Pillow's BGRA;15Z: 5-5-5 scaled, alpha 0 where bit 15 is set."""
    v = v.astype(np.uint32)
    return np.stack([_scale(v >> 10 & 31, 5), _scale(v >> 5 & 31, 5),
                     _scale(v & 31, 5),
                     np.where(v & 0x8000, 0, 255).astype(np.uint8)], -1)


def _palette(buf, at, start, size, depth):
    """The 256 entries Pillow's palette holds: `start` zero entries, then
    the map (at most 256 entries in all, as Pillow takes); entries past it
    black (alpha 255 in an RGBA map)."""
    n = 2 if depth == 16 else 3
    raw = np.frombuffer(bytes(n * start) + buf[at:at + n * size], np.uint8)
    raw = raw[:raw.size // n * n].reshape(-1, n)
    if len(raw) > 256:
        _bad(f"a colour map reaching entry {len(raw)} (Pillow's palettes "
             f"hold 256)")
    if n == 2:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(raw)] = _rgba15(raw.copy().view("<u2")[:, 0])
    else:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(raw)] = raw[:, ::-1]
    return pal, at + n * size


def _rle(src, bpp, width, height):
    """Run-length packets through csrc/raster_decode.cpp's tga_rle (the
    library data/tiff.py builds and binds)."""
    from terrain_tpu_torch.data.tiff import _lib

    src = np.frombuffer(src, np.uint8)
    out = np.empty(width * height * bpp, np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().tga_rle(src.ctypes.data, src.size, bpp, width, height,
                      out.ctypes.data, msg, _MSG):
        raise ValueError(msg.value.decode(errors="replace"))
    return out


def read_header(buf):
    """(height, width, image type, depth, flags) of a TGA's 18-byte header;
    raises ValueError where Pillow cannot read the file."""
    buf = bytes(buf)
    if len(buf) < 18:
        _bad("the header is cut short")
    cmap_type, img_type = buf[1], buf[2]
    width, height = struct.unpack("<HH", buf[12:16])
    depth = buf[16]
    if (cmap_type not in (0, 1) or not width or not height
            or depth not in (1, 8, 16, 24, 32)):
        _bad(f"not a TGA file (colour map type {cmap_type}, {width}x"
             f"{height}, depth {depth})")
    if img_type not in (1, 2, 3, 9, 10, 11):
        _bad(f"image type {img_type}")
    if img_type & 7 == 1 and not cmap_type:
        _bad("a colour-mapped image without a colour map")
    if (img_type & 7, depth) not in _MODES:
        _bad(f"image type {img_type} at {depth} bits")
    if cmap_type and buf[7] not in (16, 24):
        _bad(f"a colour map of {buf[7]} bits (Pillow reads 16 and 24)")
    if img_type & 8 and depth == 1:
        _bad("a run-length 1-bit image (Pillow cannot read one)")
    return height, width, img_type, depth, buf[17]


def decode_tga(buf):
    """TGA bytes -> the array imageio.v3.imread returns."""
    buf = bytes(buf)
    height, width, img_type, depth, flags = read_header(buf)
    bpp = _MODES[(img_type & 7, depth)]
    id_len, cmap_type = buf[0], buf[1]
    at = 18 + id_len
    pal = None
    if cmap_type:
        start, size = struct.unpack("<HH", buf[3:7])
        pal, at = _palette(buf, at, start, size, buf[7])
    if img_type & 8:
        px = _rle(buf[at:], bpp, width, height)
    else:
        need = ((width + 7) // 8 if bpp == 0 else width * bpp) * height
        if len(buf) - at < need:
            _bad("the pixel data is cut short")
        px = np.frombuffer(buf, np.uint8, need, at)
    if bpp == 0:
        img = pillow_bool(
            np.unpackbits(px.reshape(height, -1), axis=1)[:, :width])
    else:
        px = px.reshape(height, width, bpp)
        if img_type & 7 == 3:
            img = px[..., 0] if bpp == 1 else px
        elif img_type & 7 == 1:
            img = pal[px[..., 0]]
        elif bpp == 2:
            img = _rgba15(px.copy().view("<u2")[..., 0])
        else:
            img = px[..., [2, 1, 0, 3][:bpp]]
    if not flags & 0x20:  # bottom-up rows
        img = img[::-1]
    if flags & 0x10:  # right-to-left columns
        img = img[:, ::-1]
    return np.ascontiguousarray(img)

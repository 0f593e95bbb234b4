"""BMP decoding for the trainer's raster pairs (TERRAIN_RASTER) and the
port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a BMP through
Pillow (BmpImagePlugin.py).  The port depends on no image library:
`decode_bmp` reads the headers here, the pixels with numpy, and BI_RLE8 /
BI_RLE4 runs with the port's host C++ (csrc/raster_decode.cpp's bmp_rle,
which follows Pillow's decoder, quirks included), and gives
`imageio.v3.imread`'s array (Pillow 12.1.0):
  * headers: BITMAPCOREHEADER (12 bytes), BITMAPINFOHEADER (40) and its
    successors (52, 56, 64, v4 108, v5 124);
  * 1, 4 and 8 bits through a palette: bool (H, W) where the palette is
    black and white, uint8 (H, W) where it is the gray ramp 0, 1, 2, ...,
    else (H, W, 3) RGB; BI_RLE8 and BI_RLE4;
  * 16 bits (5-5-5, or 5-6-5 by BI_BITFIELDS), 24, and 32 (BI_RGB: RGB,
    the fourth byte dropped; BI_BITFIELDS with Pillow's masks: RGB or
    RGBA);
  * rows bottom-up (a positive height) or top-down (negative).
Anything else (BI_JPEG, BI_PNG, other masks or depths) raises
NotImplementedError naming it; a damaged file raises ValueError.
"""

import ctypes
import struct

import numpy as np

from terrain_tpu_torch.serve.png import pillow_bool, unpack_samples

_HEADERS = {12: "BITMAPCOREHEADER", 40: "BITMAPINFOHEADER",
            52: "BITMAPV2INFOHEADER", 56: "BITMAPV3INFOHEADER",
            64: "OS22XBITMAPHEADER", 108: "BITMAPV4HEADER",
            124: "BITMAPV5HEADER"}
_COMPRESSIONS = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4",
                 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG"}
# Pillow's BI_BITFIELDS masks -> its raw mode (BmpImagePlugin.MASK_MODES)
_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_DEFAULT = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
            32: "BGRX"}
_MSG = 256


def _refuse(what):
    raise NotImplementedError(f"BMP: {what}; the port decodes "
                              f"uncompressed, BI_BITFIELDS and RLE BMPs")


class _Header:
    def __init__(self, buf):
        if buf[:2] != b"BM" or len(buf) < 26:
            raise ValueError("BMP: not a BMP (no BM header)")
        (offset,) = struct.unpack("<I", buf[10:14])
        (size,) = struct.unpack("<I", buf[14:18])
        if size not in _HEADERS:
            _refuse(f"a header of {size} bytes")
        if len(buf) < 14 + size:
            raise ValueError("BMP: the header is cut short")
        d = buf[18:14 + size]
        self.masks = None
        if size == 12:
            self.width, self.height, _, self.bits = struct.unpack(
                "<HHHH", d[:8])
            self.comp, colors, pad = 0, 0, 3
            self.top_down = False
        else:
            w, h, _, self.bits, self.comp = struct.unpack("<iiHHI", d[:16])
            (colors,) = struct.unpack("<I", d[28:32])
            pad = 4
            self.top_down = d[7] == 0xFF  # Pillow's test of the sign
            self.width = w
            self.height = (2**32 - (h & 0xFFFFFFFF)) if self.top_down else h
            if self.comp == 3:
                if len(d) >= 48:
                    n = 4 if len(d) >= 52 else 3
                    m = struct.unpack(f"<{n}I", d[36:36 + 4 * n])
                    self.masks = m if n == 4 else m + (0,)
                else:  # BITMAPINFOHEADER: three masks after it
                    m = struct.unpack("<3I", buf[14 + size:26 + size])
                    self.masks = m + (0,)
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"BMP: a {self.width}x{self.height} image")
        self.colors = colors or (1 << self.bits if self.bits <= 24 else 0)
        if offset == 14 + size and self.bits <= 8:
            offset += 4 * self.colors  # Pillow's own correction
        self.offset = offset
        if self.comp in (4, 5) or self.comp not in _COMPRESSIONS:
            _refuse(f"compression {self.comp} "
                    f"({_COMPRESSIONS.get(self.comp, 'unknown')})")
        if self.bits not in _DEFAULT:
            _refuse(f"{self.bits} bits a pixel")
        self.mode, self.raw = "P" if self.bits <= 8 else "RGB", \
            _DEFAULT[self.bits]
        if self.comp == 3:
            if self.bits == 32 and (32, self.masks) in _MASKS:
                self.raw = _MASKS[(32, self.masks)]
                self.mode = "RGBA" if "A" in self.raw else "RGB"
            elif self.bits in (24, 16) and (self.bits,
                                            self.masks[:3]) in _MASKS:
                self.raw = _MASKS[(self.bits, self.masks[:3])]
            else:
                _refuse(f"the BI_BITFIELDS masks {self.masks} at "
                        f"{self.bits} bits")
        elif self.comp in (1, 2) and self.bits != (8 if self.comp == 1
                                                   else 4):
            _refuse(f"{_COMPRESSIONS[self.comp]} at {self.bits} bits")
        self.palette = None
        if self.mode == "P":
            if not 0 < self.colors <= 65536:
                raise ValueError(f"BMP: a palette of {self.colors} colours")
            n = pad * self.colors
            at = 14 + size
            if self.comp == 3 and size == 40:
                at += 12
            pal = np.frombuffer(buf[at:at + n], np.uint8)
            if pal.size != n:
                raise ValueError("BMP: the palette is cut short")
            pal = pal.reshape(self.colors, pad)[:, 2::-1]  # BGR(X) -> RGB
            ramp = (np.array([0, 255]) if self.colors == 2
                    else np.arange(self.colors))
            if np.array_equal(pal, np.repeat(ramp[:, None], 3, 1)):
                self.mode = "1" if self.colors == 2 else "L"
            else:
                self.palette = np.zeros((256, 3), np.uint8)
                k = min(self.colors, 256)
                self.palette[:k] = pal[:k]


def _rle(buf, hd):
    """BI_RLE8 / BI_RLE4 runs through csrc/raster_decode.cpp's bmp_rle (the
    library data/tiff.py builds and binds)."""
    from terrain_tpu_torch.data.tiff import _lib, _raise

    src = np.frombuffer(buf, np.uint8)[hd.offset:]
    out = np.empty(hd.width * hd.height, np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().bmp_rle(src.ctypes.data, src.size, int(hd.comp == 2),
                        hd.offset & 1, hd.width, hd.height, out.ctypes.data,
                        msg, _MSG)
    if rc:
        _raise(rc, msg)
    return out.reshape(hd.height, hd.width)


def _rows(buf, hd):
    """The pixel rows as stored: (H, W * bits / 8 rounded up) uint8."""
    stride = ((hd.width * hd.bits + 31) >> 3) & ~3
    data = np.frombuffer(buf, np.uint8)[hd.offset:hd.offset
                                        + stride * hd.height]
    if data.size != stride * hd.height:
        raise ValueError("BMP: the pixel data is cut short")
    return data.reshape(hd.height, stride)


def _scale(v, bits):
    """Pillow's x * 255 / (2^bits - 1), integer division."""
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def read_header(buf):
    """(height, width, Pillow's mode) of BMP bytes (the headers suffice);
    raises as `decode_bmp` does for a kind it does not take."""
    hd = _Header(bytes(buf))
    return hd.height, hd.width, hd.mode


def decode_bmp(buf):
    """BMP bytes -> the array imageio.v3.imread returns."""
    buf = bytes(buf)
    hd = _Header(buf)
    w = hd.width
    if hd.comp in (1, 2):
        px = _rle(buf, hd)
    else:
        rows = _rows(buf, hd)
        if hd.bits < 8:
            px = unpack_samples(rows, w, hd.bits)
        elif hd.bits == 8:
            px = rows[:, :w]
        elif hd.bits == 16:
            v = rows[:, :2 * w].copy().view("<u2").astype(np.uint32)
            if hd.raw == "BGR;16":
                px = np.stack([_scale(v >> 11 & 31, 5), _scale(v >> 5 & 63, 6),
                               _scale(v & 31, 5)], -1)
            else:
                px = np.stack([_scale(v >> 10 & 31, 5), _scale(v >> 5 & 31, 5),
                               _scale(v & 31, 5)], -1)
        else:
            n = hd.bits // 8
            b = rows[:, :n * w].reshape(hd.height, w, n)
            px = np.stack([b[..., hd.raw.index(ch)] for ch in
                           ("RGBA" if hd.mode == "RGBA" else "RGB")], -1)
    if not hd.top_down:
        px = px[::-1]
    if hd.mode == "1":
        px = pillow_bool(px)
    elif hd.mode == "P":
        px = hd.palette[px]
    return np.ascontiguousarray(px)

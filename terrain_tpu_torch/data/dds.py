"""DDS (DirectDraw Surface) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a DDS, by its
bytes or by its path, through Pillow (DdsImagePlugin.py, BcnDecode.c).
The port depends on no image library: `decode_dds` reads the header and
the DX10 extension here, uncompressed surfaces with numpy, and block-
compressed ones with the port's host C++ (csrc/raster_decode.cpp's
bcn_decode, block rows split over host threads; the bytes do not depend
on the thread count), and gives `imageio.v3.imread`'s array (Pillow
12.1.0, imageio 2.37.4).  Only the first surface is read: mipmaps, array
slices and cube faces after it are ignored, as Pillow ignores them.
  * DDPF_RGB: RGB, or RGBA with DDPF_ALPHAPIXELS, each channel by its mask
    as Pillow's DdsRgbDecoder takes it, int(v / (mask >> shift) * 255) in
    double precision, and a surface cut short read as zeros (Pillow reads
    the bytes it can and raises nothing);
  * DDPF_LUMINANCE: L at 8 bits, LA at 16 with alpha; DDPF_PALETTEINDEXED8:
    256 RGBA entries, then (H, W, 4) through them;
  * fourCC DXT1 (BC1: RGBA, punch-through alpha), DXT3 (BC2), DXT5 (BC3),
    ATI1 / BC4U (BC4: gray), ATI2 / BC5U (BC5: RGB, blue 0), BC5S (each
    signed endpoint plus 128, blue 128);
  * DX10 with DXGI BC1-BC5 (typeless, UNORM; BC5 SNORM), BC6H (UF16,
    SF16: half floats to 8 bits as Pillow takes them), BC7 (typeless,
    UNORM, UNORM_SRGB, no gamma applied), R8G8B8A8 (typeless, UNORM,
    UNORM_SRGB).
What Pillow cannot read (another header size, pixel format or DXGI
format, a 16-bit luminance without alpha) and a truncated file raise
ValueError, as imageio raises.
"""

import concurrent.futures
import ctypes
import os
import struct

import numpy as np

MAGIC = b"DDS "
EXTENSIONS = (".dds",)
_MSG = 256
_THREADS = min(8, os.cpu_count() or 1)
# DDS_PIXELFORMAT flags
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8, _RGB, _LUMINANCE = \
    0x1, 0x4, 0x20, 0x40, 0x20000
# fourCC / DXGI format -> (Pillow's mode, bcn_decode's format)
_FOURCCS = {b"DXT1": ("RGBA", 1), b"DXT3": ("RGBA", 2), b"DXT5": ("RGBA", 3),
            b"BC4U": ("L", 4), b"ATI1": ("L", 4), b"BC5S": ("RGB", 51),
            b"BC5U": ("RGB", 5), b"ATI2": ("RGB", 5)}
_DXGI = {70: ("RGBA", 1), 71: ("RGBA", 1), 73: ("RGBA", 2), 74: ("RGBA", 2),
         76: ("RGBA", 3), 77: ("RGBA", 3), 79: ("L", 4), 80: ("L", 4),
         82: ("RGB", 5), 83: ("RGB", 5), 84: ("RGB", 51), 95: ("RGB", 6),
         96: ("RGB", 61), 97: ("RGBA", 7), 98: ("RGBA", 7), 99: ("RGBA", 7),
         27: ("RGBA", 0), 28: ("RGBA", 0), 29: ("RGBA", 0)}
_BLOCK_BYTES = {1: 8, 4: 8}


def _bad(what):
    raise ValueError(f"DDS: {what}")


class _Header:
    """What Pillow's DdsImageFile._open reads: size, mode, and how the
    first surface is stored (`kind`: "bcn", "rgb" with bit count and
    masks, "raw" with Pillow's raw mode), its data offset, a palette."""

    def __init__(self, buf):
        if buf[:4] != MAGIC:
            _bad("not a DDS file")
        if len(buf) < 8:
            _bad("the header is cut short")
        (size,) = struct.unpack("<I", buf[4:8])
        if size != 124:
            _bad(f"a header of {size} bytes (Pillow reads 124)")
        if len(buf) < 128:
            _bad("the header is cut short")
        hd = buf[8:128]
        _, self.height, self.width = struct.unpack("<3I", hd[:12])
        if not self.width or not self.height:
            _bad(f"a {self.width}x{self.height} surface")
        pfflags, fourcc, bitcount = struct.unpack("<I4sI", hd[72:84])
        self.at, self.palette, self.fmt = 128, None, 0
        if pfflags & _RGB:
            self.mode = "RGBA" if pfflags & _ALPHAPIXELS else "RGB"
            n = len(self.mode)
            self.kind = "rgb"
            self.bitcount = bitcount
            self.masks = struct.unpack(f"<{n}I", hd[84:84 + 4 * n])
            return
        self.kind = "raw"
        if pfflags & _LUMINANCE:
            if bitcount == 8:
                self.mode = "L"
            elif bitcount == 16 and pfflags & _ALPHAPIXELS:
                self.mode = "LA"
            else:
                _bad(f"a luminance surface of {bitcount} bits (flags "
                     f"{pfflags:#x})")
        elif pfflags & _PALETTEINDEXED8:
            self.mode = "P"
            pal = np.frombuffer(buf[128:128 + 1024], np.uint8)
            self.palette = np.zeros((256, 4), np.uint8)
            self.palette.reshape(-1)[:pal.size] = pal
            self.at += 1024
        elif pfflags & _FOURCC:
            if fourcc == b"DX10":
                if len(buf) < 148:
                    _bad("the DX10 header is cut short")
                (dxgi,) = struct.unpack("<I", buf[128:132])
                self.at += 20
                if dxgi not in _DXGI:
                    _bad(f"DXGI format {dxgi} (Pillow does not read it)")
                self.mode, self.fmt = _DXGI[dxgi]
            elif fourcc in _FOURCCS:
                self.mode, self.fmt = _FOURCCS[fourcc]
            else:
                _bad(f"the pixel format {fourcc!r} (Pillow does not read "
                     f"it)")
            if self.fmt:
                self.kind = "bcn"
        else:
            _bad(f"the pixel format flags {pfflags:#x}")


def read_header(buf):
    """(height, width, Pillow's mode) of DDS bytes (the first 148 bytes
    suffice); ValueError where Pillow cannot read the file."""
    hd = _Header(bytes(buf[:148]))
    return hd.height, hd.width, hd.mode


def _bcn(buf, hd):
    """The blocks through csrc/raster_decode.cpp's bcn_decode (the library
    data/tiff.py builds and binds), block rows on host threads."""
    from terrain_tpu_torch.data.tiff import _lib

    ch = {"L": 1, "RGB": 3, "RGBA": 4}[hd.mode]
    rows = (hd.height + 3) // 4
    need = rows * ((hd.width + 3) // 4) * _BLOCK_BYTES.get(hd.fmt, 16)
    src = np.frombuffer(buf, np.uint8, min(need, max(len(buf) - hd.at, 0)),
                        hd.at)
    if src.size < need:
        _bad("the blocks are cut short")
    out = np.empty((hd.height, hd.width, ch), np.uint8)
    lib = _lib()

    def band(r0, r1):
        msg = ctypes.create_string_buffer(_MSG)
        if lib.bcn_decode(src.ctypes.data, src.size, hd.fmt, hd.width,
                          hd.height, r0, r1, out.ctypes.data, msg, _MSG):
            _bad(msg.value.decode(errors="replace"))

    step = max(1, -(-rows // (4 * _THREADS)))
    bands = [(r, min(r + step, rows)) for r in range(0, rows, step)]
    if len(bands) == 1:
        band(*bands[0])
    else:
        with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
            for f in [pool.submit(band, *b) for b in bands]:
                f.result()
    return out[..., 0] if ch == 1 else out


def _rgb(buf, hd):
    """Pillow's DdsRgbDecoder: each pixel `bitcount // 8` bytes, little
    endian, each channel by its mask; bytes past the file's end read as
    zeros."""
    nb = hd.bitcount // 8
    n = hd.width * hd.height
    raw = np.zeros(n * nb, np.uint8)
    have = np.frombuffer(buf, np.uint8, max(0, min(n * nb,
                                                   len(buf) - hd.at)), hd.at)
    raw[:have.size] = have
    v = np.zeros(n, np.uint64)
    for k in range(nb):
        v |= raw[k::nb].astype(np.uint64) << np.uint64(8 * k)
    chans = []
    for mask in hd.masks:
        shift = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> shift
        if not total:
            chans.append(np.zeros(n, np.uint8))
            continue
        x = ((v & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        chans.append((x / total * 255).astype(np.uint8))
    return np.stack(chans, -1).reshape(hd.height, hd.width, len(chans))


def decode_dds(buf):
    """DDS bytes -> the array imageio.v3.imread returns (through Pillow)."""
    buf = bytes(buf)
    hd = _Header(buf)
    if hd.kind == "bcn":
        return _bcn(buf, hd)
    if hd.kind == "rgb":
        return _rgb(buf, hd)
    bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[hd.mode]
    need = hd.width * hd.height * bands
    if len(buf) - hd.at < need:
        _bad("the pixel data is cut short")
    px = np.frombuffer(buf, np.uint8, need, hd.at).reshape(
        hd.height, hd.width, bands)
    if hd.mode == "P":
        return hd.palette[px[..., 0]]
    return px[..., 0].copy() if bands == 1 else px.copy()

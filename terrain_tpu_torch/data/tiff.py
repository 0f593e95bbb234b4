"""Baseline TIFF decoding for the trainer's raster pairs (TERRAIN_RASTER)
and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes a TIFF
through Pillow (and libtiff for a compressed one).  The port depends on no
image library: `decode_tiff` parses the first IFD here and decodes each
strip or tile with the port's host C++ (csrc/raster_decode.cpp: LZW,
PackBits, the predictors; built at first use with the host compiler,
without one decoding raises; deflate through zlib), straight into the
output array, several strips or tiles at once on host threads.  It gives
`imageio.v3.imread`'s array: its shape, dtype and bytes (Pillow 12.1.0,
libtiff 4.7.1, imageio 2.37.4).  imageio decodes TIFF bytes, and a path of
any other name, through Pillow (`decode_tiff`'s default), but a path named
*.tif or *.tiff through its vendored tifffile plugin, which returns the
samples as stored (`imread_like`, what TERRAIN_RASTER reads, as the JAX
package's `imread(path)` does): there a palette stays indices, 2- and
4-bit gray unscaled, min-is-white uninverted, 8-bit signed int8, 16-bit
colour uint16, associated alpha undivided, unspecified extra samples kept,
and a planar file comes back as (S, H, W).

Covered: classic TIFF and BigTIFF (magic 43: 20-byte IFD entries, 8-byte
counts and offsets, types 16-18), either byte order; strips and tiles
(ragged edge tiles too); compression 1, 5 (LZW), 8 and 32946 (deflate),
32773 (PackBits); predictors 1, 2 and 3 (floating point); planar
configurations 1 and 2; FillOrder 2; photometric 0 (min-is-white:
inverted, as Pillow inverts it), 1, 2, 3 (a palette, expanded to RGB as
imageio expands it), 5 (CMYK, 8 or 16 bits, with up to two unspecified
extra samples), 6 (YCbCr) and 8 (CIELab); alpha through ExtraSamples
(unassociated kept, associated divided out as Pillow does, unspecified
dropped); 1, 2, 4, 8, 16 and 32 bits in Pillow's table of modes: bool for
1 bit, uint8 for 2-8 (2 and 4 scaled to 0-255), uint16 (big-endian '>u2'
for a big-endian gray file, as Pillow keeps it), int32 for 16- and 32-bit
signed gray, float32; 16-bit colour comes back as the high bytes, uint8.
Only the first IFD is read, as imageio reads it.  Through Pillow (bytes,
or any name but *.tif): CMYK and CIELab as stored; compressed YCbCr of
subsampling 1x1 converted to RGB by libtiff's tables (TIFFYCbCrtoRGB);
uncompressed YCbCr read 4 bytes a pixel as Pillow's RGBX raw mode reads
it (OSError "image file is truncated" where that runs past the file's
end); the Orientation tag applied (exif_transpose: 5-8 swap the axes); a
big-endian BigTIFF raises OSError, as Pillow cannot open one.  Through
tifffile (a *.tif path): every kind as stored, Orientation ignored.
Refused by name (NotImplementedError): JPEG (6, 7), JPEG 2000 (34712) and
every compression but the ones above -- imageio's tifffile plugin cannot
decompress them at a *.tif path either (it needs imagecodecs; LZMA, which
it reads through Python's lzma, the port does not decode) --, YCbCr with
subsampled chroma at a *.tif path (tifffile: "chroma subsampling not
supported") and compressed through Pillow, YCbCr in tiles or planes
through Pillow, photometric 4, 9, 10 and the LogLuv kinds, and any sample
layout outside Pillow's table.  A damaged file raises ValueError.
"""

import concurrent.futures
import ctypes
import functools
import mmap
import os
import struct
import zlib

import numpy as np

from terrain_tpu_torch.serve.png import pillow_bool, unpack_samples

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "raster_decode.cpp")
_MSG = 256
_COMPRESSION = {1: "none", 5: "LZW", 8: "deflate", 32946: "deflate",
                32773: "PackBits"}
_REFUSED_COMPRESSION = {2: "CCITT RLE", 3: "CCITT Group 3",
                        4: "CCITT Group 4", 6: "old-style JPEG",
                        7: "JPEG", 34712: "JPEG 2000", 34925: "LZMA",
                        50000: "Zstandard", 50001: "WebP", 32771: "RAW16",
                        32809: "ThunderScan", 34676: "SGILog",
                        34677: "SGILog24"}
# why a compression is refused: imageio's tifffile plugin (the JAX
# package's reader of a *.tif TERRAIN_RASTER) decompresses none, LZW,
# deflate, PackBits and, through Python's lzma, LZMA; every other needs
# the imagecodecs package, which it does not have ("cannot decompress")
_NO_TIFFFILE = ("imageio's tifffile plugin, which reads a *.tif "
                "TERRAIN_RASTER in the JAX package, cannot decompress it "
                "either (ValueError: cannot decompress ...; it needs "
                "imagecodecs), so neither package trains from one")
_LZMA = ("the port does not decode LZMA (imageio's tifffile plugin reads "
         "it through Python's lzma)")
_PHOTOMETRIC = {0: "min-is-white", 1: "min-is-black", 2: "RGB",
                3: "palette", 4: "transparency mask", 5: "CMYK",
                6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                32844: "LogL", 32845: "LogLuv"}
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4),
          5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}  # BigTIFF's 8-byte ints
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_THREADS = min(8, os.cpu_count() or 1)


@functools.lru_cache(maxsize=None)
def _lib():
    from terrain_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(_build.build_host(_SRC))
    lib.tiff_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64]
    lib.tiff_chunk.restype = ctypes.c_int
    lib.bmp_rle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int64]
    lib.bmp_rle.restype = ctypes.c_int
    lib.tga_rle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.tga_rle.restype = ctypes.c_int
    lib.sun_rle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.sun_rle.restype = ctypes.c_int
    lib.hdr_pixels.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.hdr_pixels.restype = ctypes.c_int
    lib.bcn_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64]
    lib.bcn_decode.restype = ctypes.c_int
    lib.sgi_rle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.sgi_rle.restype = ctypes.c_int
    lib.pcx_rle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int64]
    lib.pcx_rle.restype = ctypes.c_int
    lib.qoi_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.qoi_decode.restype = ctypes.c_int
    return lib


def _refuse(what):
    raise NotImplementedError(f"TIFF: {what}; the port decodes baseline "
                              f"TIFF and BigTIFF (see data/tiff.py)")


def _ifd(buf):
    """(byte order '<' or '>', {tag: tuple of values}) of the first IFD, of
    a classic TIFF (12-byte entries, 4-byte counts and offsets) or a
    BigTIFF (magic 43: 20-byte entries, 8-byte counts and offsets)."""
    head = bytes(buf[:16])
    if head[:4] not in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        raise ValueError("TIFF: not a TIFF (no II*/MM* header)")
    bo = "<" if head[:2] == b"II" else ">"
    big = head[2:4] in (b"+\x00", b"\x00+")
    if big:
        size, zero, at = struct.unpack(bo + "HHQ", head[4:16])
        if (size, zero) != (8, 0):
            raise ValueError(f"TIFF: a BigTIFF whose offsets are {size} "
                             f"bytes")
        count_code, entry, word = "Q", 20, ("Q", 8)
    else:
        (at,) = struct.unpack(bo + "I", head[4:8])
        count_code, entry, word = "H", 12, ("I", 4)
    cbytes = struct.calcsize(count_code)
    if at + cbytes > len(buf):
        raise ValueError("TIFF: the first IFD lies past the file's end")
    (n,) = struct.unpack(bo + count_code, buf[at:at + cbytes])
    if at + cbytes + entry * n > len(buf):
        raise ValueError("TIFF: the first IFD is cut short")
    tags = {}
    for i in range(n):
        e = at + cbytes + entry * i
        tag, typ = struct.unpack(bo + "HH", buf[e:e + 4])
        (count,) = struct.unpack(bo + word[0], buf[e + 4:e + 4 + word[1]])
        field = e + 4 + word[1]
        if typ not in _TYPES:
            continue  # a type this reader has no use for (as libtiff skips)
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= word[1]:
            data = bytes(buf[field:field + nbytes])
        else:
            (off,) = struct.unpack(bo + word[0],
                                   buf[field:field + word[1]])
            if off + nbytes > len(buf):
                raise ValueError(f"TIFF: tag {tag}'s values lie past the "
                                 f"file's end")
            data = bytes(buf[off:off + nbytes])
        if typ == 2:
            tags[tag] = (data,)
        else:
            tags[tag] = struct.unpack(bo + code * count, data)
    return bo, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


class _Layout:
    """What the first IFD says about the pixels, checked against Pillow's
    table of modes (TiffImagePlugin.OPEN_INFO)."""

    def __init__(self, bo, tags):
        self.bo = bo
        self.width = _one(tags, 256)
        self.height = _one(tags, 257)
        if self.width is None or self.height is None:
            raise ValueError("TIFF: no ImageWidth or ImageLength")
        comp = _one(tags, 259, 1)
        if comp not in _COMPRESSION:
            name = _REFUSED_COMPRESSION.get(comp, "unknown")
            _refuse(f"compression {comp} ({name}): "
                    f"{_LZMA if comp == 34925 else _NO_TIFFFILE}")
        self.comp = comp
        photo = _one(tags, 262, 0)
        if photo not in (0, 1, 2, 3, 5, 6, 8):
            _refuse(f"photometric {photo} "
                    f"({_PHOTOMETRIC.get(photo, 'unknown')})")
        self.photo = photo
        self.orientation = _one(tags, 274, 1)
        # YCbCr: the subsampling as tagged (None: no tag), the
        # ReferenceBlackWhite and the luma coefficients
        self.subsampling = tags.get(530)
        self.ref_bw = tags.get(532)
        self.luma = tags.get(529)
        self.fill_reversed = _one(tags, 266, 1) == 2
        self.planar = _one(tags, 284, 1)
        # Pillow reads an uncompressed file itself, with no predictor
        self.predictor = _one(tags, 317, 1) if comp != 1 else 1
        sf = tuple(tags.get(339, (1,)))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        bps = tuple(tags.get(258, (1,)))
        extra = tuple(tags.get(338, ()))
        spp = _one(tags, 277, 1)
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise ValueError("TIFF: BitsPerSample does not match "
                             "SamplesPerPixel")
        self.spp, self.bits = spp, bps[0]
        key = (photo, sf, bps, extra)
        self.mode = _mode(bo, key)
        if len(set(bps)) != 1:
            _refuse(f"samples of different sizes {bps}")
        if self.planar not in (1, 2) or (self.planar == 2 and spp > 1
                                         and self.bits < 8):
            _refuse(f"planar configuration {self.planar} of {self.bits}-bit "
                    f"samples")
        if self.predictor not in (1, 2, 3) or (
                self.predictor == 2 and self.bits not in (8, 16, 32)) or (
                self.predictor == 3 and sf != (3,)):
            _refuse(f"predictor {self.predictor} on {self.bits}-bit "
                    f"samples of format {sf}")
        self.sample_format = sf[0]
        self.colormap = tags.get(320)
        if photo == 3 and (self.colormap is None
                           or len(self.colormap) != 3 << self.bits):
            raise ValueError("TIFF: a palette image without its ColorMap")
        self.tiled = 322 in tags
        if self.tiled:
            self.tile_w, self.tile_h = _one(tags, 322), _one(tags, 323)
            offsets, counts = tags.get(324), tags.get(325)
        else:
            rps = _one(tags, 278, 2**32 - 1)
            self.tile_w, self.tile_h = self.width, min(rps, self.height)
            offsets, counts = tags.get(273), tags.get(279)
        if not offsets or not self.tile_w or not self.tile_h:
            raise ValueError("TIFF: no strip or tile offsets")
        if counts is None:
            if comp != 1:
                raise ValueError("TIFF: no StripByteCounts")
            counts = (self.tile_h * self._row_bytes(),) * len(offsets)
        self.across = -(-self.width // self.tile_w)
        self.down = -(-self.height // self.tile_h)
        planes = spp if self.planar == 2 else 1
        if len(offsets) != self.across * self.down * planes or \
                len(counts) != len(offsets):
            raise ValueError(f"TIFF: {len(offsets)} strip or tile offsets "
                             f"for {self.across}x{self.down}x{planes}")
        self.offsets, self.counts = offsets, counts

    def _row_bytes(self):
        """Bytes of one row of one chunk (a strip's or a tile's)."""
        spp = 1 if self.planar == 2 else self.spp
        return -(-self.tile_w * spp * self.bits // 8)


def _mode(bo, key):
    """The Pillow mode of an OPEN_INFO key (photometric, SampleFormat,
    BitsPerSample, ExtraSamples) the port takes, else NotImplementedError
    naming it."""
    photo, sf, bps, extra = key
    n = len(bps)
    b = bps[0]
    if photo in (0, 1) and n == 1 and sf == (1,) and b in (1, 2, 4, 8):
        return "1" if b == 1 else "L"
    if photo == 1 and n == 1 and sf == (2,) and b == 8:
        return "L"
    if photo == 0 and n == 1 and sf == (1,) and b == 16 and bo == "<":
        return "I;16"
    if photo == 1 and n == 1 and sf == (1,) and b == 16:
        return "I;16" if bo == "<" else "I;16B"
    if photo == 1 and n == 1 and b in (16, 32) and sf == (2,):
        return "I"
    if photo == 1 and n == 1 and b == 32 and sf == (1,) and bo == "<":
        return "I"
    if photo in (0, 1) and n == 1 and b == 32 and sf == (3,):
        return "F"
    if photo == 1 and bps == (8, 8) and extra == (2,) and sf == (1,):
        return "LA"
    if photo == 2 and sf == (1,) and b in (8, 16) and set(bps) == {b}:
        if n == 3 and not extra:
            return "RGB"
        if n == 4 and not extra:
            return "RGBA"
        if b == 8 and extra and n == 3 + len(extra) and \
                all(e == 0 for e in extra[1:]) and len(extra) <= 3:
            return {0: "RGBX", 1: "RGBa", 2: "RGBA", 999: "RGBA"}.get(
                extra[0]) or _refuse(f"ExtraSamples {extra}")
        if b == 16 and n == 4 and extra in ((0,), (1,), (2,)):
            return {0: "RGBX", 1: "RGBa", 2: "RGBA"}[extra[0]]
    if photo == 3 and n == 1 and sf == (1,) and b in (1, 2, 4, 8):
        return "P"
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)) and sf == (1,):
        return "P" if extra == (0,) else "PA"
    if photo == 5 and sf == (1,) and b in (8, 16) and set(bps) == {b}:
        if n == 4 and not extra or (b == 8 and extra in ((0,), (0, 0))
                                    and n == 4 + len(extra)):
            return "CMYK"
    if photo in (6, 8) and sf == (1,) and bps == (8, 8, 8) and not extra:
        return "YCbCr" if photo == 6 else "LAB"
    _refuse(f"{_PHOTOMETRIC.get(photo, photo)} samples {bps}, SampleFormat "
            f"{sf}, ExtraSamples {extra}")


def _raise(rc, msg):
    text = msg.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(f"TIFF: {text}")
    raise ValueError(f"TIFF: {text}")


def _decode_chunks(buf, lay):
    """Every strip or tile into one array: (H, W, spp) samples of the
    file's size (uint8 / uint16 / 4-byte) in the host's order, or for
    fewer than 8 bits (H, packed row bytes) uint8."""
    h, w = lay.height, lay.width
    if lay.bits < 8:
        out = np.empty((h, -(-w * lay.bits // 8)), np.uint8)
        sample_bytes = 0
    else:
        sample_bytes = lay.bits // 8
        dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
        out = np.empty((h, w, lay.spp), dtype[sample_bytes])
    row_bytes = lay._row_bytes()
    chunk_spp = 1 if lay.planar == 2 else lay.spp
    swap = int((lay.bo == ">") == (np.little_endian))
    per_plane = lay.across * lay.down
    lib = _lib()
    comp = 1 if lay.comp in (8, 32946) else lay.comp
    data = np.frombuffer(buf, np.uint8)

    def one(i):
        plane, t = divmod(i, per_plane)
        ty, tx = divmod(t, lay.across)
        y0, x0 = ty * lay.tile_h, tx * lay.tile_w
        # a strip holds only the rows left; a tile is always whole
        rows = lay.tile_h if lay.tiled else min(lay.tile_h, h - y0)
        off, n = lay.offsets[i], lay.counts[i]
        if off + n > len(buf):
            raise ValueError(f"TIFF: strip or tile {i} lies past the file's "
                             f"end")
        src = data[off:off + n]
        if lay.fill_reversed:
            src = np.frombuffer(src.tobytes().translate(_REVERSED), np.uint8)
        if lay.comp in (8, 32946):
            try:
                src = np.frombuffer(zlib.decompressobj().decompress(
                    src, rows * row_bytes), np.uint8)
            except zlib.error as e:
                raise ValueError(f"TIFF: strip or tile {i}: {e}") from None
        chunk = np.empty((rows, row_bytes), np.uint8)
        msg = ctypes.create_string_buffer(_MSG)
        rc = lib.tiff_chunk(src.ctypes.data, src.size, comp,
                            chunk.ctypes.data, rows, row_bytes,
                            lay.predictor, sample_bytes, chunk_spp, swap,
                            msg, _MSG)
        if rc:
            _raise(rc, msg)
        vr = min(rows, h - y0)
        if lay.bits < 8:
            nb = min(row_bytes, out.shape[1] - x0 * lay.bits // 8)
            out[y0:y0 + vr, x0 * lay.bits // 8:][:, :nb] = chunk[:vr, :nb]
            return
        vc = min(lay.tile_w, w - x0)
        block = chunk.view(out.dtype).reshape(rows, lay.tile_w, chunk_spp)
        if lay.planar == 2:
            out[y0:y0 + vr, x0:x0 + vc, plane] = block[:vr, :vc, 0]
        else:
            out[y0:y0 + vr, x0:x0 + vc] = block[:vr, :vc]

    n = len(lay.offsets)
    if n == 1 or _THREADS == 1:
        for i in range(n):
            one(i)
    else:
        with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
            for f in [pool.submit(one, i) for i in range(n)]:
                f.result()
    return out


def _unpremultiply(rgba):
    """Pillow's RGBa -> RGBA (Unpack.c unpackRGBa): each colour times 255
    over alpha, integer division, clipped; alpha 0 gives 0 everywhere."""
    a = rgba[..., 3:4].astype(np.int32)
    c = rgba[..., :3].astype(np.int32) * 255 // np.maximum(a, 1)
    out = np.concatenate([np.minimum(c, 255), a], -1).astype(np.uint8)
    out[rgba[..., 3] == 0] = 0
    return out


def _palette(lay):
    """The ColorMap's high bytes as a (2^bits, 3) uint8 table, as Pillow
    reads it."""
    cm = np.asarray(lay.colormap, np.uint32).reshape(3, -1) // 256
    return cm.T.astype(np.uint8)


def _to_imageio(raw, lay):
    """The decoded samples -> the array imageio gives for this layout."""
    mode, w = lay.mode, lay.width
    if lay.bits < 8:
        v = unpack_samples(raw, w, lay.bits)
        if mode == "P":
            return _palette(lay)[v]
        top = (1 << lay.bits) - 1
        if lay.photo == 0:
            v = top - v
        if mode == "1":
            return pillow_bool(v)
        return (v * (255 // top)).astype(np.uint8)
    if mode == "L":
        v = raw[..., 0]
        return (255 - v) if lay.photo == 0 else v
    if mode == "I;16":
        return raw[..., 0]
    if mode == "I;16B":
        return raw[..., 0].byteswap().view(">u2")
    if lay.bo == ">" and lay.comp != 1 and mode in ("I", "F"):
        # Pillow unpacks libtiff's output (in the host's order) with its
        # big-endian raw modes F;32BF, I;16BS and I;32BS, which swap the
        # bytes once more: imageio's array holds the swapped values
        raw = raw.byteswap()
    if mode == "I":
        v = raw[..., 0]
        if lay.bits == 16:
            return v.view(np.int16).astype(np.int32)
        return v.view(np.int32)
    if mode == "F":
        return raw[..., 0].view(np.float32)
    if mode == "LA":
        return raw
    if mode in ("P", "PA"):
        if mode == "PA":
            return raw
        return _palette(lay)[raw[..., 0]]
    if mode == "YCbCr":
        return _ycbcr_to_rgb(raw, lay)
    if lay.bits == 16:  # colour at 16 bits: the high bytes (Pillow's ;16N)
        raw = (raw >> 8).astype(np.uint8)
    if mode == "CMYK":
        return raw[..., :4]
    if mode in ("RGB", "LAB"):
        return raw
    if mode == "RGBX":
        return raw[..., :3]
    if mode == "RGBA":
        return raw[..., :4]
    if mode == "RGBa":
        return _unpremultiply(raw[..., :4])
    raise AssertionError(mode)


def _rationals(v, default):
    """A RATIONAL tag's (numerator, denominator) pairs as float32 values,
    as libtiff holds them; `default` where the tag is absent."""
    if v is None:
        return [np.float32(x) for x in default]
    return [np.float32(n / d if d else 0.0) for n, d in zip(v[::2], v[1::2])]


def _ycbcr_to_rgb(raw, lay):
    """libtiff's YCbCr -> RGB (tif_color.c TIFFYCbCrToRGBInit and
    TIFFYCbCrtoRGB, which Pillow's decoder reaches through
    TIFFRGBAImageGet for a compressed YCbCr file): tables of 16-bit fixed
    point built in float32 from the luma coefficients (default 0.299,
    0.587, 0.114) and ReferenceBlackWhite (default 0 255 128 255 128
    255)."""
    f32 = np.float32
    lr, lg, lb = _rationals(lay.luma, (0.299, 0.587, 0.114))[:3]
    ref = _rationals(lay.ref_bw, (0, 255, 128, 255, 128, 255))

    def fix(x):  # FIX(x): (int32)(x * 65536 + 0.5), x a float
        return int(np.float64(min(max(x, f32(0)), f32(2))) * 65536 + 0.5)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr):  # ((c - (int32)RB) * (float)CR) / (RW - RB)
        span = rw - rb if rw - rb != 0 else f32(1)
        v = (c - np.int32(np.trunc(rb))).astype(f32) * f32(cr) / f32(span)
        return np.clip(v, f32(-128 * 32), f32(128 * 32)).astype(np.int32)

    x = np.arange(-128, 128, dtype=np.int32)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127).astype(
        np.int64)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127).astype(
        np.int64)
    y_tab = code2v(x + 128, ref[0], ref[1], 255).astype(np.int64)
    half = 1 << 15
    cr_r = (d1 * cr + half) >> 16
    cb_b = (d3 * cb + half) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + half
    y, u, v = raw[..., 0], raw[..., 1], raw[..., 2]
    r = y_tab[y] + cr_r[v]
    g = y_tab[y] + ((cb_g[u] + cr_g[v]) >> 16)
    b = y_tab[y] + cb_b[u]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _pillow_ycbcr_raw(buf, lay):
    """Pillow reads an uncompressed YCbCr file itself, with the raw mode
    its table gives (RGBX): 4 bytes a pixel from each strip's offset where
    the file holds 3, so the pixels are the file's bytes 4 at a time, and a
    strip whose 4-byte rows reach past the file's end raises OSError
    ("image file is truncated"), as Pillow does."""
    h, w = lay.height, lay.width
    out = np.empty((h, w, 3), np.uint8)
    data = np.frombuffer(buf, np.uint8)
    for i, off in enumerate(lay.offsets):
        y0 = i * lay.tile_h
        rows = min(lay.tile_h, h - y0)
        need = rows * w * 4
        if off + need > len(buf):
            raise OSError(f"TIFF: image file is truncated: Pillow reads an "
                          f"uncompressed YCbCr strip as RGBX, {need} bytes "
                          f"from offset {off}, past the file's end")
        out[y0:y0 + rows] = data[off:off + need].reshape(rows, w, 4)[..., :3]
    return out


# Orientation -> Pillow's exif_transpose of the decoded image
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: a[::-1].swapaxes(0, 1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
           8: lambda a: a[:, ::-1].swapaxes(0, 1)}


def _check_route(buf, lay, like):
    """The refusals that depend on which of imageio's readers the file
    meets: a big-endian BigTIFF through Pillow, YCbCr whose chroma is
    subsampled, and the layouts of YCbCr that Pillow's decoder reads in a
    way the port does not follow."""
    if like != "tifffile" and bytes(buf[:4]) == b"MM\x00+":
        raise OSError("TIFF: Pillow cannot open a big-endian BigTIFF (its "
                      "IFD reader finds no ImageWidth: 'Missing "
                      "dimensions'), so neither can the port as bytes; "
                      "named *.tif it is read as imageio's tifffile plugin "
                      "reads it")
    if lay.mode != "YCbCr":
        return
    tagged = tuple(lay.subsampling) if lay.subsampling else None
    if like == "tifffile":
        if tagged not in (None, (1, 1)):
            _refuse(f"YCbCr subsampled {tagged}: imageio's tifffile plugin "
                    f"raises NotImplementedError (chroma subsampling not "
                    f"supported), so neither package trains from one")
        return
    if lay.tiled or lay.planar == 2:
        _refuse("YCbCr in tiles or planes, which Pillow reads through "
                "raw modes the port does not follow")
    sub = tagged or (2, 2)  # libtiff's default
    if lay.comp != 1 and sub != (1, 1):
        _refuse(f"compressed YCbCr subsampled {sub}: libtiff's upsampling "
                f"is not ported, and imageio's tifffile plugin does not "
                f"read one (chroma subsampling not supported), so neither "
                f"package trains from one")


def _to_tifffile(raw, lay):
    """The decoded samples -> the array imageio gives for a file whose name
    ends in .tif or .tiff, which it opens with its tifffile plugin: the
    samples as stored, in the host's order (no palette, inversion,
    scaling, or alpha division), a planar file as (S, H, W)."""
    if lay.bits < 8:
        v = unpack_samples(raw, lay.width, lay.bits)
        return v.astype(bool) if lay.bits == 1 else v
    kind = {1: "u", 2: "i", 3: "f"}[lay.sample_format]
    v = raw.view(np.dtype(f"{kind}{lay.bits // 8}"))
    if lay.planar == 2 and lay.spp > 1:
        v = v.transpose(2, 0, 1)
    return v


def _open(buf):
    """Bytes as they are, or a path mapped rather than read."""
    if isinstance(buf, (str, os.PathLike)):
        with open(buf, "rb") as f:
            if os.fstat(f.fileno()).st_size == 0:
                raise ValueError(f"TIFF: {buf} is empty")
            # closed when the last view of it goes (an error's traceback
            # may hold one)
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return buf


def route(path):
    """Which of imageio's readers meets the file at `path`: "tifffile"
    (its tifffile plugin) where the name ends in .tif or .tiff, else
    "pillow"."""
    tif = os.fspath(path).lower().endswith((".tif", ".tiff"))
    return "tifffile" if tif else "pillow"


def read_header(buf, like="pillow"):
    """(height, width, Pillow's mode) of TIFF bytes (or a path, mapped) the
    decoder takes along the route `like` (decode_tiff's); raises as
    `decode_tiff` does for any other.  Through Pillow an Orientation of 5-8
    swaps height and width, and YCbCr comes back as RGB."""
    buf = _open(buf)
    lay = _Layout(*_ifd(buf))
    _check_route(buf, lay, like)
    h, w = lay.height, lay.width
    if like != "tifffile" and lay.orientation in (5, 6, 7, 8):
        h, w = w, h
    return h, w, "RGB" if lay.mode == "YCbCr" else lay.mode


def decode_tiff(buf, like="pillow"):
    """TIFF bytes (or a path, mapped rather than read) -> the array
    imageio.v3.imread returns for the file's first image: decoded through
    Pillow (like="pillow"), as imageio decodes bytes and any name but
    *.tif / *.tiff, or through imageio's tifffile plugin (like="tifffile"),
    as it decodes a path with one of those names (`imread_like`).  Through
    Pillow the Orientation tag is applied (exif_transpose); through
    tifffile the samples come back as stored."""
    buf = _open(buf)
    lay = _Layout(*_ifd(buf))
    _check_route(buf, lay, like)
    if like == "tifffile":
        out = _to_tifffile(_decode_chunks(buf, lay), lay)
    elif lay.mode == "YCbCr" and lay.comp == 1:
        out = _pillow_ycbcr_raw(buf, lay)
    else:
        out = _to_imageio(_decode_chunks(buf, lay), lay)
    if out.ndim == 3 and out.shape[-1] == 1:
        out = out[..., 0]
    if like != "tifffile" and lay.orientation in _ORIENT:
        out = _ORIENT[lay.orientation](out)
    return np.ascontiguousarray(out)


def imread_like(path):
    """The TIFF at `path` as `imageio.v3.imread(path)` gives it (the JAX
    package's TERRAIN_RASTER reader): through its tifffile plugin where the
    name ends in .tif or .tiff, else through Pillow."""
    return decode_tiff(path, route(path))


def read_header_like(path):
    """read_header along the route imageio takes for `path`."""
    return read_header(path, route(path))

"""Raster files for the trainer's crops (TERRAIN_RASTER) and the dataset
tools: the format by name and by first bytes, and the decode by the port's
own codecs, each giving the array `imageio.v3.imread` gives (the JAX
package's reader):
  PNG   serve/png.py    every colour type and depth, Adam7, palettes
  JPEG  data/jpeg.py    baseline, extended and progressive Huffman
  TIFF  data/tiff.py    baseline and BigTIFF: strips or tiles, LZW,
                        deflate, PackBits; gray, RGB, palette, CMYK,
                        YCbCr, CIELab; Orientation 1-8
  BMP   data/bmp.py     uncompressed, BI_BITFIELDS, RLE8 and RLE4
GIF is refused by name: imageio gives it a frame axis that the JAX
package's crop iterator does not take, so terrain_tpu cannot train from
one either (serve/gif.py writes and reads the port's clips, not rasters).
WebP is refused by name until the port has a VP8 decoder; a TIFF that
imageio's tifffile plugin cannot read at a *.tif path (JPEG in TIFF,
subsampled YCbCr) is refused by name in data/tiff.py."""

import os

from terrain_tpu_torch.data.bmp import decode_bmp
from terrain_tpu_torch.data.bmp import read_header as bmp_header
from terrain_tpu_torch.data.jpeg import decode_jpeg
from terrain_tpu_torch.data.tiff import imread_like as read_tiff
from terrain_tpu_torch.data.tiff import read_header_like as tiff_header
from terrain_tpu_torch.serve.png import read_png

# raster formats by file extension and by magic
_EXT = {".png": "PNG", ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG",
        ".tif": "TIFF", ".tiff": "TIFF", ".bmp": "BMP", ".dib": "BMP",
        ".gif": "GIF", ".webp": "WebP"}
_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"RIFF", "WebP"))
_REFUSED = {
    "GIF": "imageio gives a GIF a frame axis, (1, H, W) or (1, H, W, 3), "
           "which terrain_tpu's crop iterator refuses, so neither package "
           "trains from one: convert it to PNG",
    "WebP": "a WebP decoder (VP8/VP8L) is queued, not yet written: convert "
            "it to PNG",
}
_DECODERS = {"JPEG": decode_jpeg, "BMP": decode_bmp, "PNG": read_png}


def _refuse_unless_decoded(path, fmt):
    if fmt in _REFUSED:
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} is {fmt}; {_REFUSED[fmt]}")
    if fmt not in ("PNG", "JPEG", "TIFF", "BMP"):
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} is {fmt}; the port decodes PNG, JPEG, "
            f"TIFF and BMP rasters, with its own codecs")


def format_by_name(path):
    """The raster format of `path` by its extension (PNG where it names
    none); NotImplementedError unless the port decodes it.  Opens nothing."""
    fmt = _EXT.get(os.path.splitext(path)[1].lower(), "PNG")
    _refuse_unless_decoded(path, fmt)
    return fmt


def format_of(path):
    """The raster format of `path` by its name, then by its first bytes;
    NotImplementedError unless the port decodes it."""
    format_by_name(path)
    with open(path, "rb") as f:
        head = f.read(8)
    fmt = next((name for magic, name in _MAGIC if head.startswith(magic)),
               "of an unknown format")
    _refuse_unless_decoded(path, fmt)
    return fmt


def check_header(path, fmt):
    """Raise NotImplementedError where the header of `path` (a TIFF's first
    IFD, a BMP's headers) names a variant the port does not decode, before
    any pixel is decoded."""
    if fmt == "TIFF":
        tiff_header(path)
    elif fmt == "BMP":
        with open(path, "rb") as f:
            bmp_header(f.read(1 << 19))  # the headers and any palette


def read_raster(path, fmt=None):
    """A PNG, JPEG, TIFF or BMP raster decoded by the port's codecs to the
    array imageio.v3.imread(path) gives: its shape, dtype and bytes (a TIFF
    named *.tif through imageio's tifffile plugin, data/tiff.py; mapped,
    not read, so a large one is never held twice)."""
    fmt = fmt or format_of(path)
    if fmt == "TIFF":
        return read_tiff(path)
    with open(path, "rb") as f:
        return _DECODERS[fmt](f.read())

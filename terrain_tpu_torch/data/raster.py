"""Raster files for the trainer's crops (TERRAIN_RASTER) and the dataset
tools: the format by name and by first bytes, and the decode by the port's
own codecs (serve/png.py for PNG, data/jpeg.py for JPEG).  Every other
format is refused by name."""

import os

from terrain_tpu_torch.data.jpeg import decode_jpeg
from terrain_tpu_torch.serve.png import decode_png

# raster formats by file extension and by magic; the port decodes PNG and
# JPEG with its own codecs and refuses the others by name
_EXT = {".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG",
        ".tif": "TIFF", ".tiff": "TIFF", ".gif": "GIF", ".bmp": "BMP",
        ".webp": "WebP"}
_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"GIF8", "GIF"),
          (b"BM", "BMP"), (b"RIFF", "WebP"))


def _refuse_unless_decoded(path, fmt):
    if fmt not in ("PNG", "JPEG"):
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} is {fmt}; the port decodes PNG and "
            f"JPEG rasters only, with its own codecs (it depends on no image "
            f"library): convert the file to PNG")


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


def read_raster(path, fmt=None):
    """A PNG or JPEG raster decoded by the port's codecs, as
    imageio.v3.imread gives it but for a PNG of one channel, which keeps
    its channel axis: (H, W, C) from a PNG, (H, W) or (H, W, 3) from a
    JPEG (uint8; a 16-bit PNG uint16)."""
    fmt = fmt or format_of(path)
    with open(path, "rb") as f:
        return (decode_png if fmt == "PNG" else decode_jpeg)(f.read())

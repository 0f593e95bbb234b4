"""Raster files for the trainer's crops (TERRAIN_RASTER) and the dataset
tools: the format by name and by first bytes, and the decode by the port's
own codecs, each giving the array `imageio.v3.imread` gives (the JAX
package's reader), through the plugin imageio takes for the file
(data/cvread.py's `reader`: by the extension's plugin order, then Pillow,
then OpenCV; bytes through Pillow where it opens them, else OpenCV):
  PNG   serve/png.py    every colour type and depth, Adam7, palettes
  JPEG  data/jpeg.py    baseline, extended and progressive Huffman
  TIFF  data/tiff.py    baseline and BigTIFF: strips or tiles, LZW,
                        deflate, PackBits; gray, RGB, palette, CMYK,
                        YCbCr, CIELab; Orientation 1-8
  BMP   data/bmp.py     uncompressed, BI_BITFIELDS, RLE8 and RLE4
  WebP  data/webp.py    VP8L (lossless), VP8 (lossy), ALPH alpha; an
                        animation's first frame on its canvas
  JPEG 2000 data/jp2.py JP2 and bare codestreams (*.j2k, *.j2c, *.jpc):
                        the 5/3 and 9/7 wavelets, layers, precincts,
                        tiles, every progression order
  PNM   data/pnm.py     P1-P6 plain and binary, maxval 1-65535, Pf floats
                        (Pillow); PF and a *.pfm path (OpenCV's PFM
                        reader), P7 (OpenCV's PAM reader: BLACKANDWHITE,
                        GRAYSCALE, RGB), a bitmap at a *.pbm path
  TGA   data/tga.py     types 1-3 and their run-length forms, by name only
                        (*.tga, *.icb, *.vda, *.vst: TGA has no magic)
  HDR   data/hdr.py     Radiance RGBE (*.hdr, *.pic), flat and run-length
                        scanlines, through OpenCV's reader
  Sun   data/sun.py     Sun raster (*.ras, *.sr), depths 1-32, colour
                        maps, byte-encoded runs (Pillow; OpenCV's reader at
                        a *.sr path)
  DDS   data/dds.py     uncompressed, luminance, palette, BC1-BC7 (DXT1/3/5,
                        ATI1/2, BC5S, BC6H UF16 and SF16), the DX10 header
  SGI   data/sgi.py     *.sgi, *.rgb, *.rgba, *.bw: raw and run-length, 8-
                        and 16-bit samples (the high byte), 1, 3, 4 channels
  PCX   data/pcx.py     1-bit in 1, 2 or 4 planes, 8-bit gray or palette, RGB
  QOI   data/qoi.py     3 and 4 channels, every op (Pillow's decoder)
  IM    data/im.py      IFUNC Image Memory: Pillow's table of image types, Lut
                        palettes, the first frame; no magic (sniffed last)
  ICO   data/ico.py     the entry Pillow picks: PNG, or a DIB with its alpha
                        or AND mask
  ICNS  data/icns.py    the largest entry: PNG, JPEG 2000, it32/ih32/il32/
                        is32 runs with their 8-bit masks
  MPO   data/jpeg.py    its first frame, a JPEG
GIF is refused by name: imageio gives it a frame axis that the JAX
package's crop iterator does not take, so terrain_tpu cannot train from
one either (serve/gif.py writes and reads the port's clips, not rasters).
What a decoder does not take is refused by name there: a TIFF that
imageio's tifffile plugin cannot read at a *.tif path (JPEG in TIFF,
subsampled YCbCr), a PAM whose tuple type has alpha (OpenCV leaves its
rows partly unwritten), a *.pbm or *.pfm path holding another PNM kind, a
JPEG 2000 feature no fixture holds (POC, PPM/PPT, RGN, SOP/EPH, code-block
styles, subsampling, palettes, sYCC)."""

import os

from terrain_tpu_torch.data import (cvread, dds, hdr, icns, ico, im, jp2,
                                    pcx, pnm, qoi, sgi, sun, tga)
from terrain_tpu_torch.data.bmp import decode_bmp
from terrain_tpu_torch.data.bmp import read_header as bmp_header
from terrain_tpu_torch.data.jpeg import decode_jpeg
from terrain_tpu_torch.data.tiff import imread_like as read_tiff
from terrain_tpu_torch.data.tiff import read_header_like as tiff_header
from terrain_tpu_torch.data.webp import decode_webp
from terrain_tpu_torch.data.webp import read_header as webp_header
from terrain_tpu_torch.serve.png import read_png

# raster formats by file extension and by magic
_PNM = dict.fromkeys(m[:2] for m in pnm.MAGICS)  # P1-P6, Pf, P0, Py, PF, P7
_EXT = {".png": "PNG", ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG",
        ".tif": "TIFF", ".tiff": "TIFF", ".bmp": "BMP", ".dib": "BMP",
        ".gif": "GIF", ".webp": "WebP", ".pbm": "PNM", ".pgm": "PNM",
        ".ppm": "PNM", ".pnm": "PNM", ".pfm": "PNM", ".pam": "PNM",
        ".jp2": "JPEG 2000",
        ".j2k": "JPEG 2000", ".jpx": "JPEG 2000", ".j2c": "JPEG 2000",
        ".jpc": "JPEG 2000", ".jpf": "JPEG 2000",
        **{ext: "TGA" for ext in tga.EXTENSIONS},
        **{ext: "HDR" for ext in hdr.EXTENSIONS},
        **{ext: "Sun raster" for ext in sun.EXTENSIONS},
        **{ext: "DDS" for ext in dds.EXTENSIONS},
        **{ext: "SGI" for ext in sgi.EXTENSIONS},
        **{ext: "PCX" for ext in pcx.EXTENSIONS},
        **{ext: "QOI" for ext in qoi.EXTENSIONS},
        **{ext: "IM" for ext in im.EXTENSIONS},
        **{ext: "ICO" for ext in ico.EXTENSIONS},
        **{ext: "ICNS" for ext in icns.EXTENSIONS},
        ".mpo": "JPEG"}  # an MPO's first frame is a JPEG
_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          *((m, "JPEG 2000") for m in jp2.MAGICS),
          *((m, "HDR") for m in hdr.MAGICS), (sun.MAGIC, "Sun raster"),
          (dds.MAGIC, "DDS"), *((m, "PNM") for m in _PNM),
          (qoi.MAGIC, "QOI"), (ico.MAGIC, "ICO"), (icns.MAGIC, "ICNS"),
          *((b"\x0a" + bytes([v]), "PCX") for v in (0, 2, 3, 5)),
          (sgi.MAGIC, "SGI"))
_REFUSED = {
    "GIF": "imageio gives a GIF a frame axis, (1, H, W) or (1, H, W, 3), "
           "which terrain_tpu's crop iterator refuses, so neither package "
           "trains from one: convert it to PNG",
}
_DECODED = ("PNG", "JPEG", "TIFF", "BMP", "WebP", "PNM", "TGA", "JPEG 2000",
            "HDR", "Sun raster", "DDS", "SGI", "PCX", "QOI", "IM", "ICO",
            "ICNS")
_DECODERS = {"JPEG": decode_jpeg, "BMP": decode_bmp, "PNG": read_png,
             "WebP": decode_webp, "TGA": tga.decode_tga,
             "JPEG 2000": jp2.decode_jp2, "HDR": hdr.decode_hdr,
             "DDS": dds.decode_dds, "SGI": sgi.decode_sgi,
             "QOI": qoi.decode_qoi, "ICNS": icns.decode_icns}
# decoders that read a path otherwise than bytes (a file's seek before its
# start fails; imageio offers an IM Pillow does not identify to every
# plugin)
_PATH_DECODERS = {"PCX": pcx.decode_pcx, "ICO": ico.decode_ico,
                  "IM": im.decode_im}


def _refuse_unless_decoded(path, fmt):
    if fmt in _REFUSED:
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} is {fmt}; {_REFUSED[fmt]}")
    if fmt not in _DECODED:
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} is {fmt}; the port decodes PNG, JPEG "
            f"(MPO), TIFF, BMP, WebP, PNM (PFM, PAM), TGA, JPEG 2000, "
            f"Radiance HDR, Sun raster, DDS, SGI, PCX, QOI, IM, ICO and "
            f"ICNS rasters, with its own codecs")


def _sniff(head):
    """The format that the first bytes of a file name, or None."""
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return next((name for magic, name in _MAGIC if head.startswith(magic)),
                "IM" if im.sniff(head) else None)


def format_by_name(path):
    """The raster format of `path` by its extension (PNG where it names
    none); NotImplementedError unless the port decodes it.  Opens nothing."""
    fmt = _EXT.get(os.path.splitext(path)[1].lower(), "PNG")
    _refuse_unless_decoded(path, fmt)
    return fmt


def format_of(path):
    """The raster format of `path` by its name, then by its first bytes (a
    TGA, which has no magic, by its name alone; IM, which has none either,
    by a first header line of Pillow's, after every format with a magic);
    NotImplementedError unless the port decodes it."""
    by_name = format_by_name(path)
    with open(path, "rb") as f:
        head = f.read(100)
    fmt = _sniff(head) or ("TGA" if by_name == "TGA"
                           else "of an unknown format")
    _refuse_unless_decoded(path, fmt)
    ext = os.path.splitext(path)[1].lower()
    if fmt != by_name and \
            cvread.READERS.get(ext, ("pillow",))[0] == "opencv":
        raise NotImplementedError(
            f"TERRAIN_RASTER: {path} holds {fmt}; imageio reads a *{ext} "
            f"path through OpenCV, whose reading of {fmt} the port does not "
            f"reproduce")
    return fmt


def check_header(path, fmt):
    """Raise NotImplementedError where the header of `path` (a TIFF's first
    IFD, a BMP's headers, a WebP's chunks, a PNM's magic or PAM header, a
    JPEG 2000 file's boxes and main header, an IM's text header, an ICO's
    directory and chosen entry's header, an ICNS's blocks) names a variant
    the port does not decode, before any pixel is decoded; where it is
    damaged, what imageio raises there (ValueError for a Radiance, Sun
    raster or DDS header)."""
    if fmt == "TIFF":
        tiff_header(path)
        return
    with open(path, "rb") as f:
        if fmt == "BMP":
            bmp_header(f.read(1 << 19))  # the headers and any palette
        elif fmt == "WebP":
            webp_header(f.read())
        elif fmt == "PNM":
            head = f.read(8)
            pnm.check_kind(path, head + f.read() if head[:2] == b"P7"
                           else head)  # a PAM's header has no set length
        elif fmt == "TGA":
            tga.read_header(f.read(18))
        elif fmt == "JPEG 2000":
            jp2.read_header(f.read())
        elif fmt == "HDR":
            hdr.read_header(f.read())
        elif fmt == "Sun raster":
            sun.check_kind(path, f.read(32))
        elif fmt == "DDS":
            dds.read_header(f.read(148))
        elif fmt == "SGI":
            sgi.read_header(f.read(512))
        elif fmt == "PCX":
            pcx.read_header(f.read(128))
        elif fmt == "QOI":
            qoi.read_header(f.read(14))
        elif fmt == "IM":
            im.read_header(f.read(1 << 20), True)  # the header, its Lut
        elif fmt == "ICO":
            ico.check_header(f.read())
        elif fmt == "ICNS":
            icns.check_header(f.read())


def read_raster(path, fmt=None):
    """A raster decoded by the port's codecs to the array
    imageio.v3.imread(path) gives: its shape, dtype and bytes (a TIFF named
    *.tif through imageio's tifffile plugin, data/tiff.py, mapped, not
    read, so a large one is never held twice; a *.pbm through its OpenCV
    plugin, data/pnm.py; a *.pfm path, PF and P7 through OpenCV's readers;
    a Sun raster named *.sr through OpenCV's, data/sun.py)."""
    fmt = fmt or format_of(path)
    if fmt == "TIFF":
        return read_tiff(path)
    if fmt == "PNM":
        return pnm.read_pnm(path)
    if fmt == "Sun raster":
        return sun.read_sun(path)
    with open(path, "rb") as f:
        buf = f.read()
    if fmt in _PATH_DECODERS:
        return _PATH_DECODERS[fmt](buf, from_path=True)
    return _DECODERS[fmt](buf)

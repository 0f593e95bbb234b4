"""Write the PNG, TIFF, BMP, WebP, PNM, TGA, JPEG 2000, PFM/PAM, Radiance
HDR, Sun raster, DDS, SGI, PCX, QOI, IM, ICO, ICNS and MPO fixtures of
tests/data/{png,tiff,bmp,webp,pnm,tga,jp2,pfm_pam,hdr,sun,dds,sgi,pcx,qoi,
im,ico,icns,mpo}/ and their digests.

    python tests/make_raster_fixtures.py [directory]   # default tests/data

Every variant the port's raster decoders take (serve/png.py, data/tiff.py,
data/bmp.py), small and seeded, written by small encoders here (Pillow
writes no interlaced PNG, no TIFF tile, planar layout or floating-point
predictor, no RLE BMP) and, where Pillow writes the kind, by Pillow:
  png/   gray at 1, 2, 4, 8 and 16 bits; palettes at 1, 2, 4 and 8 bits
         (one whose PLTE is shorter than its indices reach); gray+alpha
         and colour at 8 and 16 bits; tRNS on gray, colour and palette
         images; each of those Adam7-interlaced too, and sizes that leave
         passes empty; the rows' filter types cycling through 0-4
  tiff/  either byte order; strips and tiles (ragged edges); none, LZW,
         deflate (8 and 32946), PackBits; predictors 2 and 3; planar
         configuration 2; FillOrder 2; min-is-white, gray, RGB, palette;
         ExtraSamples 0, 1 and 2; 1-32 bits, SampleFormat 1, 2 and 3;
         BigTIFF; CMYK, YCbCr and CIELab; Orientation 1-8; JPEG (refused);
         and two full-width strips of the NASA rasters' size (21600 columns):
         strip_21600x32_rgb_lzw.tif (Pillow: LZW, predictor 2, 8 rows a
         strip) and strip_21600x32_gray16_deflate.tif (Pillow: deflate,
         16-bit, ocean zeros), which chip_smoke.py repeats into a
         21600x10800 pair
  bmp/   1, 4 and 8 bits through palettes (black and white, a gray ramp,
         colours), BI_RLE8 and BI_RLE4 (every escape), 16 bits (5-5-5 and
         5-6-5), 24 and 32 bits (BI_RGB and BI_BITFIELDS with alpha),
         bottom-up and top-down, the core, info, v4 and v5 headers
  webp/  Pillow's lossy files at quality 0-100 and method 0, 4, 6, lossless
         ones, palettes of 2, 3, 11 and 200 colours, RGBA (exact, alpha
         quality 50 and 100), gray, 1x1, 17x33 and 257x513, VP8X with ICCP
         and EXIF, animations (refused); VP8 frames re-coded with the
         simple filter, sharpness, filter deltas, 2-8 token partitions
         (tests/vp8_bits.py); ALPH raw and VP8L-coded with each filter; the
         VP8X layouts Pillow does not write; damaged files; and the
         1024x640 pair chip_smoke.py's raster phase trains from
  pnm/   P1-P6 plain and binary at maxval 1-65535, comments, Pf both byte
         orders, P0CMYK/PyRGBA/PyCMYK, Pillow's files, bitmaps at *.pbm
         paths (imageio reads them through OpenCV), the kinds refused
  tga/   types 1-3 and 9-11 at every depth Pillow reads, 16- and 24-bit
         colour maps, the four origins, ID fields, literals running on
         across rows, Pillow's files, and what Pillow cannot read
  pfm_pam/  OpenCV's PFM and PAM files and the script's (pfm_pam_fixtures)
  hdr/   OpenCV's Radiance files and the script's (hdr_fixtures)
  sun/   Sun rasters at *.ras and *.sr names (sun_fixtures)
  dds/   Pillow's DDS files, random BC1-BC7 blocks, masks, palettes, and
         two 1024x1024 tiles for chip_smoke.py (dds_fixtures)
  sgi/ pcx/ qoi/ im/ ico/ icns/ mpo/   Pillow's files of each and the
         script's for what Pillow does not write (sgi_fixtures ...
         mpo_fixtures: run-length SGI, PCX bit planes, every QOI op, the
         rest of Pillow's IM table, DIB icons, icns runs and JPEG 2000
         entries), damaged ones included
Each directory's digests.json holds, for each file, its size, the shape,
dtype and SHA-256 of the array imageio.v3.imread decodes from its bytes
(through Pillow; where Pillow raises OSError -- a truncated read, or a
big-endian BigTIFF it cannot open -- "error" says so instead; for a WebP,
PNM or TGA "error" is ValueError, what the port raises wherever imageio
fails), for a TIFF, WebP, PNM or TGA also under "path" those of imageio's
decode of the file by its name (a *.tif through imageio's tifffile
plugin, a *.pbm through OpenCV, as the JAX package reads TERRAIN_RASTER;
null where no plugin reads it), under "refused" (or "path_refused", at
its path only) the words the port's refusal names a file by, and under
"reference" the Pillow, imageio, libtiff (and libwebp, openjpeg, OpenCV)
versions.  For a PNM, PFM/PAM, HDR, Sun or DDS file (CHOICE_KINDS) the
bytes and the path are both read by imageio's own choice of plugin, and
"reader" names it ("pillow" or "opencv"); "error" there is ValueError
wherever imageio raises; for the kinds of NATIVE_KINDS "error" is the
exception imageio raises there (its nearest built-in class, or
struct.error), which the port raises too.  The committed PNG that
no script writes (terrain_48x40_rgb_5filters.png) keeps its entry.
Pillow and imageio are needed here, not on the card: chip_smoke.py holds
the port's decoders to the committed digests, and the port's tests re-run
this script and check them.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(HERE, "data")
STRIP_W, STRIP_H = 21600, 32


def terrain(h, w, seed, channels=3):
    """(h, w, channels) uint8: a few waves, ~30% ocean (zeros in channel
    0's heights), coloured like land and sea, with one level of noise."""
    rnd = np.random.RandomState(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for _ in range(4):
        fy, fx, py, px = rnd.uniform(1, 9, 4)
        f += np.sin(fy * 6.2832 * y + py) * np.cos(fx * 6.2832 * x + px)
    f -= np.quantile(f, 0.3)
    land = f > 0
    t = np.clip(f / f.max(), 0, 1)
    c = [np.where(land, 90 + 110 * t, 20), np.where(land, 110 + 60 * t, 60),
         np.where(land, 60 + 40 * t, 150), np.where(land, 255, 128)]
    img = np.stack(c[:channels], -1) + rnd.randint(0, 2, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


# -------------------------------------------------------------------- PNG
def _png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_bits(v, bits):
    """(h, w) values of `bits` bits -> (h, packed row bytes), most
    significant first, rows padded with zeros."""
    h, w = v.shape
    per = 8 // bits
    pad = (-w) % per
    v = np.concatenate([v, np.zeros((h, pad), v.dtype)], 1).astype(np.uint8)
    v = v.reshape(h, -1, per)
    out = np.zeros(v.shape[:2], np.uint8)
    for i in range(per):
        out |= v[:, :, i] << (8 - bits * (i + 1))
    return out


def _png_rows(samples, depth):
    """(h, w, c) samples -> (h, row bytes) uint8 as PNG stores them."""
    h, w, c = samples.shape
    if depth < 8:
        return _pack_bits(samples[..., 0], depth)
    dt = ">u2" if depth == 16 else np.uint8
    return np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(
        h, -1)


def _png_filter(rows, bpp, first_type=0):
    """Each row led by its filter type, the types cycling through 0-4."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, row in enumerate(rows.astype(np.int32)):
        t = (first_type + r) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if t == 0:
            pred = 0
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([t]) + ((row - pred) & 255).astype(np.uint8)
                   .tobytes())
        prev = row
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_bytes(samples, depth, ctype, plte=None, trns=None, interlace=0):
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == _PNG_CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    if interlace:
        data = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                data += _png_filter(_png_rows(sub, depth), bpp, i)
    else:
        data = _png_filter(_png_rows(samples, depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _png_chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    # the image data in two IDAT chunks, as encoders may split it
    z = zlib.compress(data, 6)
    cut = len(z) // 2
    return (out + _png_chunk(b"IDAT", z[:cut]) + _png_chunk(b"IDAT", z[cut:])
            + _png_chunk(b"IEND", b""))


def png_fixtures():
    rnd = np.random.RandomState(1)
    h, w = 29, 37
    tex = terrain(h, w, 11, 4)
    g8 = tex[..., 0]
    g16 = (tex[..., 0].astype(np.uint16) * 257 + rnd.randint(0, 256, (h, w))
           ).astype(np.uint16)
    rgb16 = tex[..., :3].astype(np.uint16) * 257 + rnd.randint(
        0, 256, (h, w, 3)).astype(np.uint16)
    plte = rnd.randint(0, 256, (256, 3))
    out = {}
    for inter, tag in ((0, ""), (1, "_adam7")):
        for d in (1, 2, 4):
            out[f"gray{d}{tag}.png"] = png_bytes(g8 >> (8 - d), d, 0,
                                                 interlace=inter)
            out[f"palette{d}{tag}.png"] = png_bytes(
                g8 >> (8 - d), d, 3, plte=plte[:1 << d], interlace=inter)
        out[f"gray8{tag}.png"] = png_bytes(g8, 8, 0, interlace=inter)
        out[f"gray16{tag}.png"] = png_bytes(g16, 16, 0, interlace=inter)
        out[f"palette8{tag}.png"] = png_bytes(g8, 8, 3, plte=plte,
                                              interlace=inter)
        out[f"graya8{tag}.png"] = png_bytes(tex[..., [0, 3]], 8, 4,
                                            interlace=inter)
        out[f"graya16{tag}.png"] = png_bytes(
            np.stack([g16, g16[::-1]], -1), 16, 4, interlace=inter)
        out[f"rgb8{tag}.png"] = png_bytes(tex[..., :3], 8, 2,
                                          interlace=inter)
        out[f"rgb16{tag}.png"] = png_bytes(rgb16, 16, 2, interlace=inter)
        out[f"rgba8{tag}.png"] = png_bytes(tex, 8, 6, interlace=inter)
        out[f"rgba16{tag}.png"] = png_bytes(
            np.concatenate([rgb16, g16[..., None]], -1), 16, 6,
            interlace=inter)
    # tRNS on every kind it applies to (imageio ignores it)
    out["gray8_trns.png"] = png_bytes(g8, 8, 0, trns=struct.pack(">H", 20))
    out["rgb8_trns.png"] = png_bytes(tex[..., :3], 8, 2,
                                     trns=struct.pack(">HHH", 20, 60, 150))
    out["palette8_trns_adam7.png"] = png_bytes(
        g8, 8, 3, plte=plte, trns=bytes(range(0, 256, 2)), interlace=1)
    out["palette4_simple_trns.png"] = png_bytes(
        g8 >> 4, 4, 3, plte=plte[:16], trns=b"\xff\xff\x00\xff")
    # indices past a short PLTE (Pillow pads the palette with black)
    out["palette8_short_plte.png"] = png_bytes(g8, 8, 3, plte=plte[:40])
    # sizes whose Adam7 passes are partly empty
    for hh, ww in ((1, 1), (1, 5), (3, 2), (5, 1)):
        out[f"rgb8_{ww}x{hh}_adam7.png"] = png_bytes(
            tex[:hh, :ww, :3], 8, 2, interlace=1)
        out[f"gray1_{ww}x{hh}_adam7.png"] = png_bytes(
            g8[:hh, :ww] >> 7, 1, 0, interlace=1)
    return out


# ------------------------------------------------------------------- TIFF
def lzw_encode(data):
    """TIFF LZW (libtiff's tif_lzw.c LZWEncode): a clear code first, codes
    of 9-12 bits most significant first, the width growing when the next
    entry no longer fits, a clear code when the table is full."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258

    put(256)
    table, nxt = reset()
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            width = 9
            table, nxt = reset()
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([byte])
    if w:
        put(table[w])
        nxt += 1
        if nxt == 4094:
            put(256)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data):
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and
                                             data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_chunk_bytes(block, bits, bo, predictor):
    """(rows, cols, s) samples of one strip or tile -> its bytes before
    compression, the predictor applied."""
    rows, cols, s = block.shape
    if bits < 8:
        return _pack_bits(block[..., 0], bits).tobytes()
    if predictor == 2:
        v = block.reshape(rows, cols * s).astype(block.dtype)
        d = v.copy()
        d[:, s:] = v[:, s:] - v[:, :-s]
        block = d.reshape(rows, cols, s)
    if predictor == 3:  # libtiff's fpDiff: byte planes, then differences
        k = block.dtype.itemsize
        le = block.astype("<" + block.dtype.str[1:]).reshape(rows, cols * s)
        b = le.view(np.uint8).reshape(rows, cols * s, k)
        planes = np.concatenate([b[:, :, k - 1 - j] for j in range(k)], 1)
        d = planes.astype(np.int32)
        d[:, s:] = planes[:, s:].astype(np.int32) - planes[:, :-s]
        return (d & 255).astype(np.uint8).tobytes()
    return np.ascontiguousarray(block.astype(bo + block.dtype.str[1:])
                                ).tobytes()


def tiff_bytes(img, bo="<", photometric=1, compression=1, predictor=1,
               planar=1, tile=None, rows_per_strip=None, bits=None,
               extra=(), colormap=None, fill_order=1, sample_format=None,
               more_tags=None, big=False):
    """A one-image TIFF of img ((H, W) or (H, W, S); for `bits` < 8 the
    values themselves) in the given layout; `more_tags` {tag: (type,
    values)} adds or replaces IFD entries (SHORT 3, LONG 4 or RATIONAL 5,
    a rational as a (numerator, denominator) pair); `big` writes a
    BigTIFF (magic 43, 20-byte entries, offsets and counts as LONG8 16)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, s = img.shape
    bits = bits or img.dtype.itemsize * 8
    if tile:
        tw, th = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th, tw = rows_per_strip or h, w
        grid = [(y, 0) for y in range(0, h, th)]
    planes = range(s) if planar == 2 else [None]
    chunks = []
    for p in planes:
        for y, x in grid:
            block = img[y:y + th, x:x + tw]
            if p is not None:
                block = block[..., p:p + 1]
            if tile:  # a tile is always whole: pad the edges
                full = np.zeros((th, tw, block.shape[2]), img.dtype)
                full[:block.shape[0], :block.shape[1]] = block
                block = full
            raw = _tiff_chunk_bytes(block, bits, bo, predictor)
            if compression == 5:
                raw = lzw_encode(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw, 6)
            elif compression == 32773:
                raw = packbits_encode(raw)
            if fill_order == 2:
                raw = raw.translate(_REVERSED)
            chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [s]), 284: (3, [planar])}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if sample_format:
        tags[339] = (3, [sample_format] * s)
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap, np.uint16).T.reshape(-1)))
    if big:
        data = bytearray(b"II+\x00" if bo == "<" else b"MM\x00+")
        data += struct.pack(bo + "HHQ", 8, 0, 0)
    else:
        data = bytearray(b"II*\x00" if bo == "<" else b"MM\x00*")
        data += struct.pack(bo + "I", 0)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        data += bytes(len(data) % 2)
    counts = [len(c) for c in chunks]
    wide = 16 if big else 4  # the type of offsets and counts
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (wide, offsets),
                     325: (wide, counts)})
    else:
        tags.update({273: (wide, offsets), 278: (4, [th]),
                     279: (wide, counts)})
    tags.update(more_tags or {})
    ifd_at = len(data)
    word, count_code, entry = ("Q", "Q", 20) if big else ("I", "H", 12)
    struct.pack_into(bo + word, data, 8 if big else 4, ifd_at)
    n = len(tags)
    after = (ifd_at + struct.calcsize(count_code) + entry * n
             + struct.calcsize(word))
    entries, blobs = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        code = {3: "H", 4: "I", 5: "II", 16: "Q"}[typ]
        flat = [v for pair in vals for v in pair] if typ == 5 else vals
        payload = struct.pack(bo + code * len(vals), *flat)
        if len(payload) <= struct.calcsize(word):
            field = payload + bytes(struct.calcsize(word) - len(payload))
        else:
            field = struct.pack(bo + word, after + len(blobs))
            blobs += payload + bytes(len(payload) % 2)
        entries += (struct.pack(bo + "HH" + word, tag, typ, len(vals))
                    + field)
    data += (struct.pack(bo + count_code, n) + entries
             + bytes(struct.calcsize(word)) + blobs)
    return bytes(data)


def _pillow(img, fmt, **kw):
    from PIL import Image

    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def tiff_fixtures(with_strips=True):
    from PIL import Image

    rnd = np.random.RandomState(2)
    h, w = 29, 37
    tex = terrain(h, w, 12, 4)
    rgb, g8 = tex[..., :3], tex[..., 0]
    g16 = (g8.astype(np.uint16) * 257 + rnd.randint(0, 256, (h, w))).astype(
        np.uint16)
    f32 = (g8.astype(np.float32) / 7.0 - 3.0) * np.float32(1.7)
    i16 = (g16.astype(np.int32) - 30000).astype(np.int16)
    cmap = rnd.randint(0, 65536, (256, 3))
    premult = tex.copy()
    premult[..., 3] = rnd.randint(0, 256, (h, w))
    premult[0, :5, 3] = [0, 255, 1, 128, 0]
    premult[..., :3] = (premult[..., :3].astype(np.int32)
                        * premult[..., 3:4] // 255).astype(np.uint8)
    out = {
        "rgb8_lzw_pred2_strips_le.tif": tiff_bytes(
            rgb, photometric=2, compression=5, predictor=2,
            rows_per_strip=4),
        "rgb8_lzw_pred2_tiles_be.tif": tiff_bytes(
            rgb, ">", 2, 5, 2, tile=(16, 16)),
        "rgb8_deflate_tiles_be.tif": tiff_bytes(
            rgb, ">", 2, 32946, tile=(16, 16)),
        "rgb8_adobe_deflate_planar2_le.tif": tiff_bytes(
            rgb, photometric=2, compression=8, planar=2, rows_per_strip=8),
        "rgb8_packbits_planar2_tiles_be.tif": tiff_bytes(
            rgb, ">", 2, 32773, planar=2, tile=(16, 32)),
        "rgb8_none_tiles_be.tif": tiff_bytes(rgb, ">", 2, tile=(32, 16)),
        "rgb8_none_planar2_le.tif": tiff_bytes(rgb, photometric=2, planar=2,
                                               rows_per_strip=10),
        "rgba8_lzw_extra2_le.tif": tiff_bytes(
            tex, photometric=2, compression=5, extra=(2,),
            rows_per_strip=7),
        "rgba8_lzw_extra2_planar2_be.tif": tiff_bytes(
            tex, ">", 2, 5, planar=2, extra=(2,), rows_per_strip=16),
        "rgba8_deflate_extra1_le.tif": tiff_bytes(
            premult, photometric=2, compression=8, extra=(1,)),
        "rgba8_deflate_extra1_planar2_le.tif": tiff_bytes(
            premult, photometric=2, compression=8, extra=(1,), planar=2),
        "rgbx8_lzw_extra0_be.tif": tiff_bytes(tex, ">", 2, 5, extra=(0,)),
        "rgba8_none_noextra_le.tif": tiff_bytes(tex, photometric=2),
        "rgb16_lzw_pred2_le.tif": tiff_bytes(
            np.stack([g16, g16[::-1], g16[:, ::-1]], -1), photometric=2,
            compression=5, predictor=2),
        "rgb16_deflate_be.tif": tiff_bytes(
            np.stack([g16, g16[::-1], g16[:, ::-1]], -1), ">", 2, 8),
        "rgba16_lzw_extra2_be.tif": tiff_bytes(
            np.stack([g16, g16[::-1], g16[:, ::-1], g16.T[:h, :w]
                      if h == w else g16], -1), ">", 2, 5, extra=(2,)),
        "gray8_lzw_le.tif": tiff_bytes(g8, compression=5),
        "gray8_lzw_fillorder2_le.tif": tiff_bytes(g8, compression=5,
                                                  fill_order=2),
        "gray8_packbits_minwhite_be.tif": tiff_bytes(g8, ">", 0, 32773),
        "gray8_deflate_pred2_tiles_le.tif": tiff_bytes(
            g8, compression=8, predictor=2, tile=(16, 16)),
        "gray8_signed_lzw_le.tif": tiff_bytes(g8, compression=5,
                                              sample_format=2),
        "graya8_lzw_extra2_le.tif": tiff_bytes(
            tex[..., [0, 3]], compression=5, extra=(2,)),
        "gray16_lzw_pred2_be.tif": tiff_bytes(g16, ">", 1, 5, 2,
                                              rows_per_strip=5),
        "gray16_deflate_pred2_le.tif": tiff_bytes(g16, compression=32946,
                                                  predictor=2),
        "gray16_none_be.tif": tiff_bytes(g16, ">"),
        "gray16_minwhite_lzw_le.tif": tiff_bytes(g16, photometric=0,
                                                 compression=5),
        "int16_lzw_pred2_le.tif": tiff_bytes(i16, compression=5,
                                             predictor=2, sample_format=2),
        "int16_none_be.tif": tiff_bytes(i16, ">", sample_format=2),
        # big-endian and compressed: Pillow swaps libtiff's bytes again
        "int16_lzw_be.tif": tiff_bytes(i16, ">", 1, 5, sample_format=2),
        "int32_deflate_le.tif": tiff_bytes(i16.astype(np.int32) * 7919,
                                           compression=8, sample_format=2),
        "int32_lzw_be.tif": tiff_bytes(i16.astype(np.int32) * 7919, ">", 1,
                                       5, sample_format=2),
        "uint32_none_le.tif": tiff_bytes(g16.astype(np.uint32) * 40503),
        "float32_lzw_pred3_le.tif": tiff_bytes(
            f32, compression=5, predictor=3, sample_format=3,
            rows_per_strip=6),
        "float32_deflate_pred3_tiles_be.tif": tiff_bytes(
            f32, ">", 1, 8, 3, tile=(16, 16), sample_format=3),
        "float32_none_minwhite_be.tif": tiff_bytes(f32, ">", 0,
                                                   sample_format=3),
        "palette8_lzw_le.tif": tiff_bytes(g8, photometric=3, compression=5,
                                          colormap=cmap),
        "palette8_extra0_lzw_le.tif": tiff_bytes(
            tex[..., [0, 3]], photometric=3, compression=5, colormap=cmap,
            extra=(0,)),
        "palette8_alpha_deflate_le.tif": tiff_bytes(
            tex[..., [0, 3]], photometric=3, compression=8, colormap=cmap,
            extra=(2,)),
    }
    for bits in (1, 2, 4):
        v = g8 >> (8 - bits)
        out[f"gray{bits}_lzw_le.tif"] = tiff_bytes(v, compression=5,
                                                   bits=bits)
        out[f"gray{bits}_minwhite_packbits_be.tif"] = tiff_bytes(
            v, ">", 0, 32773, bits=bits, rows_per_strip=9)
        out[f"palette{bits}_deflate_tiles_le.tif"] = tiff_bytes(
            v, photometric=3, compression=8, bits=bits, tile=(16, 16),
            colormap=cmap[:1 << bits])
    out["gray1_none_be.tif"] = tiff_bytes(g8 >> 7, ">", bits=1)
    # and Pillow's own files of the kinds it writes
    for name, mode in (("pillow_rgb_lzw.tif", "RGB"),
                       ("pillow_rgba_deflate.tif", "RGBA"),
                       ("pillow_gray_packbits.tif", "L")):
        comp = {"lzw": "tiff_lzw", "deflate": "tiff_deflate",
                "packbits": "packbits"}[name.split("_")[2][:-4]]
        img = Image.fromarray(tex if mode == "RGBA" else
                              rgb if mode == "RGB" else g8)
        out[name] = _pillow(img, "TIFF", compression=comp)
    out["pillow_1bit_lzw.tif"] = _pillow(Image.fromarray(g8).convert("1"),
                                         "TIFF", compression="tiff_lzw")
    out.update(tiff_kinds(tex))
    if with_strips:
        out.update(tiff_strips())
    return out


def tiff_kinds(tex):
    """BigTIFF in either byte order, strips and tiles, none, LZW and
    deflate (this script's writer; Pillow writes a BigTIFF uncompressed
    only, which is here too); CMYK, YCbCr and CIELab by Pillow (YCbCr
    uncompressed: Pillow reads it 4 bytes a pixel and raises "image file is
    truncated") and by this writer (big-endian, tiles, 16-bit CMYK,
    CMYK plus an unspecified extra sample, YCbCr with ReferenceBlackWhite
    and luma coefficients of its own); Orientation 1-8 by Pillow, as
    stored through tifffile and transposed through Pillow; and JPEG in
    TIFF (Pillow), which imageio's tifffile plugin cannot decompress at a
    *.tif path and the port refuses by name."""
    from PIL import Image

    rgb = tex[..., :3]
    out = {}
    for bo, end in (("<", "le"), (">", "be")):
        for comp, cname in ((1, "none"), (5, "lzw"), (8, "deflate")):
            out[f"bigtiff_rgb8_{cname}_strips_{end}.tif"] = tiff_bytes(
                rgb, bo, 2, comp, rows_per_strip=7, big=True)
            out[f"bigtiff_rgb8_{cname}_tiles_{end}.tif"] = tiff_bytes(
                rgb, bo, 2, comp, 2 if comp == 5 else 1, tile=(16, 16),
                big=True)
    out["bigtiff_gray16_lzw_pred2_be.tif"] = tiff_bytes(
        tex[..., 0].astype(np.uint16) * 251, ">", 1, 5, 2, big=True)
    out["pillow_bigtiff_rgb.tif"] = _pillow(Image.fromarray(rgb), "TIFF",
                                            big_tiff=True)
    for mode in ("CMYK", "YCbCr", "LAB"):
        img = Image.fromarray(rgb).convert(mode)
        for comp in ("raw", "tiff_lzw"):
            name = f"pillow_{mode.lower()}_{comp.removeprefix('tiff_')}.tif"
            out[name] = _pillow(img, "TIFF", compression=comp)
    cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    lab = np.asarray(Image.fromarray(rgb).convert("LAB"))
    out["cmyk8_lzw_tiles_be.tif"] = tiff_bytes(cmyk, ">", 5, 5, 2,
                                               tile=(16, 16))
    out["cmyk16_deflate_le.tif"] = tiff_bytes(
        cmyk.astype(np.uint16) * 257, photometric=5, compression=8)
    out["cmykx8_packbits_be.tif"] = tiff_bytes(
        np.concatenate([cmyk, tex[..., 3:]], -1), ">", 5, 32773,
        extra=(0,))
    out["ycbcr8_deflate_refbw_be.tif"] = tiff_bytes(
        ycc, ">", 6, 8, rows_per_strip=5, more_tags={
            529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)]),
            530: (3, [1, 1]),
            532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                      (240, 1)])})
    out["lab8_lzw_tiles_le.tif"] = tiff_bytes(lab, "<", 8, 5,
                                              tile=(16, 32))
    for o in range(1, 9):
        out[f"pillow_orientation{o}.tif"] = _pillow(
            Image.fromarray(rgb), "TIFF", tiffinfo={274: o})
    out["pillow_orientation6_gray16_lzw.tif"] = _pillow(
        Image.fromarray(tex[..., 0].astype(np.uint16) * 257), "TIFF",
        compression="tiff_lzw", tiffinfo={274: 6})
    out["pillow_orientation7_ycbcr_lzw.tif"] = _pillow(
        Image.fromarray(rgb).convert("YCbCr"), "TIFF",
        compression="tiff_lzw", tiffinfo={274: 7})
    out["pillow_jpeg_refused.tif"] = _pillow(Image.fromarray(rgb), "TIFF",
                                             compression="jpeg")
    return out


# the fixtures the port refuses by name, with the words it names them by
REFUSED = {"pillow_jpeg_refused.tif": "compression 7 (JPEG)",
           "width2_refused.qoi": "a width of 1 or 2",
           "lstar12_refused.im": "the 12-bit samples",
           "dib_top_down_refused.ico": "top-down",
           "rle_stops_at_a_row_refused.sgi": "stops the decode there",
           "ih32_runs_no_mask_refused.icns": "in runs with no mask",
           "pyp_refused.pgm": "PyP",
           "pam_gray_alpha_refused.pam": "tuple type GRAYSCALE_ALPHA",
           "cv_pam_rgb_alpha_8.pam": "tuple type RGB_ALPHA",
           "cv_pam_rgb_alpha_16.pam": "tuple type RGB_ALPHA",
           "gimp_brush_header_refused.ras": "as a GIMP brush",
           "refused_poc.j2k": "POC progression changes",
           "refused_ppm.j2k": "PPM packed packet headers",
           "refused_rgn.j2k": "RGN regions of interest",
           "refused_sop.j2k": "SOP/EPH packet markers",
           "refused_cblk_style.j2k": "code-block style 4",
           "refused_htj2k.j2k": "HTJ2K code-blocks",
           "refused_subsampled.j2k": "a subsampled component",
           "refused_pclr.jp2": "a palette (pclr/cmap)",
           "refused_sycc.jp2": "sYCC colour"}
# refused at their path only (the bytes decode through Pillow)
PATH_REFUSED = {"gray_at_pbm_path_refused.pbm": "a *.pbm path holding P5",
                "p5_at_pfm_path_refused.pfm": "a *.pfm path holding P5",
                "cut_lut.im": "SPE's among them",
                "no_known_key.im": "of an unknown format"}
# the kinds whose decoders raise ValueError wherever imageio fails
VALUE_ERROR_KINDS = ("webp", "pnm", "tga", "jp2")
# kinds whose bytes and paths are digested through imageio's own choice of
# plugin (Pillow, or OpenCV where Pillow cannot open them), recorded
CHOICE_KINDS = ("pnm", "pfm_pam", "hdr", "sun", "dds")
# kinds digested the same way, where "error" names the exception imageio
# raises (the nearest built-in class, or struct.error), which the port's
# decoders raise too
NATIVE_KINDS = ("sgi", "pcx", "qoi", "im", "ico", "icns", "mpo")


def strip_heights(h, w, seed=5):
    """(h, w) uint16 heights: the texture's land as 256 * k + 1..255 (so a
    uint8 cast keeps it land), its ocean zero."""
    t = terrain(h, w, seed, 1)[..., 0].astype(np.uint16)
    land = t > 30
    return np.where(land, (t % 200) * 256 + t % 255 + 1, 0).astype(np.uint16)


def tiff_strips():
    """The two full-width strips, by Pillow (LZW with predictor 2, and
    deflate): a texture and its 16-bit heights, 8 rows a strip."""
    from PIL import Image

    tex = terrain(STRIP_H, STRIP_W, 6)
    hm = strip_heights(STRIP_H, STRIP_W)
    return {
        "strip_21600x32_rgb_lzw.tif": _pillow(
            Image.fromarray(tex), "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2, 278: 8}),
        "strip_21600x32_gray16_deflate.tif": _pillow(
            Image.fromarray(hm), "TIFF", compression="tiff_adobe_deflate",
            tiffinfo={317: 2, 278: 8}),
    }


# -------------------------------------------------------------------- BMP
def bmp_bytes(pixels, bits, palette=None, compression=0, masks=None,
              header=40, top_down=False, rle=None, colors_used=0):
    """A BMP of `pixels` ((H, W) indices or (H, W, 3|4) RGB(A)), or of the
    run-length data `rle` for BI_RLE8/BI_RLE4."""
    h, w = pixels.shape[:2]
    if rle is not None:
        body = rle
    else:
        rows = pixels[::-1] if not top_down else pixels
        if bits < 8:
            packed = _pack_bits(rows, bits)
        elif bits == 8:
            packed = rows.astype(np.uint8)
        elif bits == 16:
            r, g, b = (rows[..., i].astype(np.uint32) for i in range(3))
            if masks == (0xF800, 0x7E0, 0x1F):
                v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
            else:
                v = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
            packed = v.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            packed = rows[..., 2::-1].reshape(h, -1)
        else:
            a = (rows[..., 3] if rows.shape[2] == 4
                 else np.full((h, w), 0x5A, np.uint8))
            packed = np.stack([rows[..., 2], rows[..., 1], rows[..., 0], a],
                              -1).reshape(h, -1)
            if masks == (0xFF, 0xFF00, 0xFF0000, 0xFF000000):  # RGBA
                packed = np.stack([rows[..., 0], rows[..., 1], rows[..., 2],
                                   a], -1).reshape(h, -1)
        stride = -(-packed.shape[1] // 4) * 4
        body = np.zeros((h, stride), np.uint8)
        body[:, :packed.shape[1]] = packed
        body = body.tobytes()
    pal = b""
    if palette is not None:
        pad = 3 if header == 12 else 4
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if pad == 4:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(body), 2835, 2835,
                           colors_used, 0)
        if header >= 52 and masks is not None:
            info += struct.pack("<4I", *(tuple(masks) + (0,))[:4])
        info += bytes(header - len(info))
        if header == 40 and masks is not None:
            info += struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + pal + body


def _rle8(rows, w):
    """Run-length BI_RLE8 data of (H, W) indices (bottom-up), with encoded
    runs, absolute runs (odd and even), a delta escape, end of line and
    end of bitmap."""
    out = bytearray()
    for r, row in enumerate(rows):
        x = 0
        if r == 2:  # a delta: Pillow reads two more bytes and moves by them
            out += bytes([0, 2, 1, 0, 3, 0])
            x = 3
        while x < w:
            j = x
            while j < w and row[j] == row[x] and j - x < 255:
                j += 1
            if j - x >= 3 or w - x < 3:
                out += bytes([j - x, row[x]])
                x = j
            else:
                n = min(w - x, 5 if r % 2 else 4)
                out += bytes([0, n]) + bytes(row[x:x + n].tolist())
                if n % 2:
                    out += b"\x00"
                x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(rows, w):
    """BI_RLE4 data: encoded runs of two alternating nibbles (odd lengths
    too) and absolute runs of even lengths (Pillow misreads an odd one:
    it takes one byte too few)."""
    out = bytearray()
    for r, row in enumerate(rows):
        x = 0
        while x < w:
            n = min(w - x, 7 if r % 2 else 6)
            if r % 3 == 0 or n < 4:
                out += bytes([n, (row[x] << 4) | row[min(x + 1, w - 1)]])
            else:
                n -= n % 2
                data = bytes((row[x + i] << 4) | row[x + i + 1]
                             for i in range(0, n, 2))
                out += bytes([0, n]) + data
                if len(data) % 2:
                    out += b"\x00"
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_fixtures():
    from PIL import Image

    rnd = np.random.RandomState(3)
    h, w = 29, 37
    tex = terrain(h, w, 13, 4)
    rgb, g8 = tex[..., :3], tex[..., 0]
    pal = rnd.randint(0, 256, (256, 3))
    gray = np.repeat(np.arange(256)[:, None], 3, 1)
    bw = np.array([[0, 0, 0], [255, 255, 255]])
    out = {
        "pal1_bw.bmp": bmp_bytes(g8 >> 7, 1, bw),
        "pal1_colour.bmp": bmp_bytes(g8 >> 7, 1, pal[:2]),
        "pal4.bmp": bmp_bytes(g8 >> 4, 4, pal[:16]),
        "pal8.bmp": bmp_bytes(g8, 8, pal),
        "pal8_gray.bmp": bmp_bytes(g8, 8, gray),
        "pal8_top_down.bmp": bmp_bytes(g8, 8, pal, top_down=True),
        "pal8_few_colours.bmp": bmp_bytes(g8 % 40, 8, pal[:40],
                                          colors_used=40),
        "pal8_core.bmp": bmp_bytes(g8, 8, pal, header=12),
        "rle8.bmp": bmp_bytes(g8, 8, pal, 1, rle=_rle8(
            (g8 // 32 * 32)[::-1], w)),
        "rle8_gray.bmp": bmp_bytes(g8, 8, gray, 1, rle=_rle8(g8[::-1], w)),
        "rle4.bmp": bmp_bytes(g8 >> 4, 4, pal[:16], 2, rle=_rle4(
            (g8 >> 4)[::-1], w)),
        "rgb16_555.bmp": bmp_bytes(rgb, 16),
        "rgb16_565_bitfields.bmp": bmp_bytes(
            rgb, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "rgb16_555_bitfields_v4.bmp": bmp_bytes(
            rgb, 16, compression=3, masks=(0x7C00, 0x3E0, 0x1F), header=108),
        "rgb24.bmp": bmp_bytes(rgb, 24),
        "rgb24_top_down.bmp": bmp_bytes(rgb, 24, top_down=True),
        "rgb24_core.bmp": bmp_bytes(rgb, 24, header=12),
        "rgb24_v5.bmp": bmp_bytes(rgb, 24, header=124),
        "rgb32.bmp": bmp_bytes(tex, 32),
        "rgb32_bitfields.bmp": bmp_bytes(
            tex, 32, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
        "rgba32_bitfields_v5.bmp": bmp_bytes(
            tex, 32, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124),
        "rgba32_bitfields_rgba_v4.bmp": bmp_bytes(
            tex, 32, compression=3,
            masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=108),
    }
    for name, mode in (("pillow_rgb.bmp", "RGB"), ("pillow_l.bmp", "L"),
                       ("pillow_1.bmp", "1"), ("pillow_p.bmp", "P")):
        img = Image.fromarray(rgb if mode in ("RGB", "P") else g8)
        img = img.convert(mode) if mode != "P" else img.quantize(50)
        out[name] = _pillow(img, "BMP")
    return out


# ------------------------------------------------------------------- WebP
def _riff(chunks):
    """A WebP file of (tag, payload) chunks, each padded to even length."""
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(c)) + c + b"\0" * (len(c) & 1)
        for tag, c in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _chunks(data):
    out, p = [], 12
    while p < len(data):
        (n,) = struct.unpack("<I", data[p + 4:p + 8])
        out.append((data[p:p + 4], data[p + 8:p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def _vp8x(w, h, alpha):
    return (b"VP8X", bytes([0x10 if alpha else 0, 0, 0, 0])
            + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3])


def _anmf(x, y, w, h, flags, chunks):
    """An ANMF chunk: a frame at (x, y) (even), w x h, 40 ms, `flags`
    (1 dispose, 2 no blending), of `chunks` (ALPH, then VP8 or VP8L)."""
    sub = b"".join(tag + struct.pack("<I", len(c)) + c + b"\0" * (len(c) & 1)
                   for tag, c in chunks)
    return (b"ANMF", b"".join(struct.pack("<I", v)[:3] for v in (
        x // 2, y // 2, w - 1, h - 1, 40)) + bytes([flags]) + sub)


def _anim(canvas, alpha, frames):
    """An animated WebP: VP8X (the animation flag, and the alpha flag when
    `alpha`), ANIM, then the ANMF chunks."""
    w, h = canvas
    return _riff([(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                   + struct.pack("<I", w - 1)[:3]
                   + struct.pack("<I", h - 1)[:3]),
                  (b"ANIM", bytes(6))] + frames)


def _alpha_filter(a, kind):
    """The deltas ALPH's filter `kind` (1 horizontal, 2 vertical, 3
    gradient) leaves of the plane a, libwebp's unfilter undoing them."""
    a = a.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif kind == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


def _alph(plane, kind, compressed):
    """An ALPH payload: the header byte, then the filtered plane raw or as
    a VP8L image stream (Pillow's lossless encoding of it as gray, without
    the stream's 5-byte header: the green channel is the alpha)."""
    from PIL import Image

    deltas = _alpha_filter(plane, kind) if kind else plane
    if not compressed:
        return bytes([kind << 2]) + deltas.tobytes()
    vp8l = _chunks(_pillow(Image.fromarray(deltas), "WEBP", lossless=True,
                           method=4))[0][1]
    return bytes([1 | kind << 2]) + vp8l[5:]


def webp_pair():
    """The 1024x640 pair chip_smoke.py's raster phase times and trains
    from: lossless heights (ocean zeros) and a q90 lossy texture."""
    tex = terrain(640, 1024, 61)
    hm = np.where(tex[..., 0] > 30, tex[..., 1], 0).astype(np.uint8)
    return hm, tex


def webp_fixtures():
    """Pillow's files (every quality and method, palettes, alpha, gray, odd
    sizes, VP8X with ICCP and EXIF, animations) and the kinds Pillow
    cannot write, built here: the simple loop filter, sharpness, filter
    deltas and several token partitions (tests/vp8_bits.py), raw and
    VP8L-coded ALPH chunks with each filter, VP8X layouts Pillow does not
    make, and damaged files."""
    sys.path.insert(0, HERE)
    import vp8_bits
    from PIL import Image

    out = {}
    tex = terrain(48, 64, 41)
    img = Image.fromarray(tex)
    for q in (0, 5, 50, 90, 100):
        for m in (0, 4, 6):
            out[f"pillow_lossy_q{q}_m{m}.webp"] = _pillow(
                img, "WEBP", quality=q, method=m)
    for q in (0, 50, 100):
        for m in (0, 6):
            out[f"pillow_lossless_q{q}_m{m}.webp"] = _pillow(
                img, "WEBP", lossless=True, quality=q, method=m)
    rnd = np.random.RandomState(43)
    for k in (2, 3, 11, 200):  # colour indexing: 8, 4, 2 and 1 a byte
        pal = rnd.randint(0, 256, (k, 3)).astype(np.uint8)
        idx = (np.arange(37 * 29).reshape(37, 29) // 5 + rnd.randint(
            0, 2, (37, 29))) % k
        out[f"pillow_palette{k}.webp"] = _pillow(
            Image.fromarray(pal[idx]), "WEBP", lossless=True)
    rgba = terrain(40, 56, 44, 4)
    rgba[..., 3] = (np.arange(56)[None] * 4 + rnd.randint(0, 40, (40, 56))
                    ).clip(0, 255)
    rgba_img = Image.fromarray(rgba)
    out["pillow_rgba_lossless_exact.webp"] = _pillow(
        rgba_img, "WEBP", lossless=True, exact=True)
    out["pillow_rgba_lossless.webp"] = _pillow(rgba_img, "WEBP",
                                               lossless=True)
    for aq in (50, 100):
        out[f"pillow_rgba_lossy_aq{aq}.webp"] = _pillow(
            rgba_img, "WEBP", quality=80, alpha_quality=aq)
    out["pillow_rgba_lossy_m6.webp"] = _pillow(rgba_img, "WEBP", quality=60,
                                               method=6)
    gray = Image.fromarray(tex[..., 0])
    out["pillow_gray_lossy.webp"] = _pillow(gray, "WEBP", quality=75)
    out["pillow_gray_lossless.webp"] = _pillow(gray, "WEBP", lossless=True)
    for h, w in ((1, 1), (17, 33), (257, 513)):
        with np.errstate(invalid="ignore"):  # 1x1: one height, no range
            sized = Image.fromarray(terrain(h, w, 45))
        out[f"pillow_lossy_{h}x{w}.webp"] = _pillow(sized, "WEBP",
                                                    quality=70)
        out[f"pillow_lossless_{h}x{w}.webp"] = _pillow(
            sized, "WEBP", lossless=True, quality=0, method=0)
    out["pillow_vp8x_iccp_exif_lossless.webp"] = _pillow(
        rgba_img, "WEBP", lossless=True, icc_profile=b"\x00" * 13,
        exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08" + bytes(6))
    out["pillow_vp8x_iccp_lossy.webp"] = _pillow(img, "WEBP", quality=60,
                                                 icc_profile=b"\x01" * 9)
    frames = [Image.fromarray(terrain(24, 32, s)) for s in (46, 47)]
    out["pillow_animated_2_frames.webp"] = _pillow(
        frames[0], "WEBP", save_all=True, append_images=frames[1:],
        lossless=True)
    still = _chunks(_pillow(frames[0], "WEBP", lossless=True))[0]
    anmf = bytes(6) + struct.pack("<I", 31)[:3] + struct.pack("<I", 23)[:3] \
        + struct.pack("<I", 40)[:3] + b"\x00" + still[0] \
        + struct.pack("<I", len(still[1])) + still[1] + b"\0" * (
            len(still[1]) & 1)
    out["animated_1_frame.webp"] = _riff([
        (b"VP8X", bytes([0x02, 0, 0, 0]) + struct.pack("<I", 31)[:3]
         + struct.pack("<I", 23)[:3]),
        (b"ANIM", bytes(4) + b"\x00\x00"), (b"ANMF", anmf)])
    rgba_frames = [Image.fromarray(terrain(24, 32, s, 4)) for s in (49, 50)]
    for f in rgba_frames:
        f.putalpha(Image.fromarray((np.arange(32)[None] * 8 + np.zeros(
            (24, 1), int)).clip(0, 255).astype(np.uint8)))
    out["pillow_animated_lossy_rgba.webp"] = _pillow(
        rgba_frames[0], "WEBP", save_all=True, append_images=rgba_frames[1:],
        quality=70)
    out["pillow_animated_lossy.webp"] = _pillow(
        frames[0], "WEBP", save_all=True, append_images=frames[1:],
        quality=60)
    # a first frame at an offset of a larger canvas: lossy with ALPH,
    # lossless, lossy without alpha; under VP8X's alpha flag and without
    frame = terrain(20, 26, 51, 4)
    lossy_alph = _chunks(_pillow(Image.fromarray(frame), "WEBP",
                                 quality=60))[1:]
    lossless = _chunks(_pillow(Image.fromarray(frame), "WEBP",
                               lossless=True))
    lossy = _chunks(_pillow(Image.fromarray(frame[..., :3]), "WEBP",
                            quality=60))
    for name, sub in (("lossy_alph", lossy_alph), ("lossless", lossless),
                      ("lossy", lossy)):
        for alpha in (True, False):
            out[f"animated_offset_{name}{'' if alpha else '_no_alpha_flag'}"
                f".webp"] = _anim((40, 33), alpha, [
                    _anmf(6, 8, 26, 20, 0, sub),
                    _anmf(0, 0, 26, 20, 2, sub)])
    out["animated_frame_leaves_canvas.webp"] = _anim(
        (30, 30), True, [_anmf(6, 12, 26, 20, 0, lossless)])
    out["animated_anmf_before_anim.webp"] = _riff([
        (b"VP8X", bytes([0x12, 0, 0, 0]) + struct.pack("<I", 39)[:3]
         + struct.pack("<I", 32)[:3]), _anmf(0, 0, 26, 20, 0, lossless)])
    hm, pair_tex = webp_pair()
    out["pillow_pair_hm_1024x640_lossless.webp"] = _pillow(
        Image.fromarray(hm), "WEBP", lossless=True)
    out["pillow_pair_tex_1024x640_q90.webp"] = _pillow(
        Image.fromarray(pair_tex), "WEBP", quality=90)
    # VP8 frames re-coded with the header changed (eight macroblock rows,
    # so eight partitions all hold tokens)
    for q in (90, 30):
        frame = vp8_bits.Frame(_chunks(_pillow(
            Image.fromarray(terrain(136, 72, 48)), "WEBP", quality=q))[0][1])
        for name, kw in (
                ("simple", {"simple": 1}),
                ("simple_sharp7_parts4", {"simple": 1, "sharpness": 7,
                                          "parts": 4}),
                ("sharp3", {"sharpness": 3}),
                ("deltas", {"deltas": ([5, 0, 0, 0], [-9, 0, 0, 0])}),
                ("deltas_level40", {"deltas": ([-20, 3, 0, 0], [30, 0, 0, 0]),
                                    "level": 40}),
                ("level0", {"level": 0}),
                ("parts2", {"parts": 2}),
                ("parts8", {"parts": 8}),
                ("simple_level63", {"simple": 1, "level": 63})):
            out[f"vp8_q{q}_{name}.webp"] = _riff(
                [(b"VP8 ", frame.encode(**kw))])
    # ALPH chunks Pillow does not write, on one lossy frame
    h, w = 40, 56
    vp8 = _chunks(_pillow(Image.fromarray(rgba[..., :3]), "WEBP",
                          quality=80))[0]
    for kind in range(4):
        for comp in (0, 1):
            out[f"alph_filter{kind}_{'vp8l' if comp else 'raw'}.webp"] = \
                _riff([_vp8x(w, h, True),
                       (b"ALPH", _alph(rgba[..., 3], kind, comp)), vp8])
    alph = (b"ALPH", _alph(rgba[..., 3], 1, 1))
    out["vp8x_no_alpha_flag_with_alph.webp"] = _riff(
        [_vp8x(w, h, False), alph, vp8])
    out["vp8x_alpha_flag_no_alph.webp"] = _riff([_vp8x(w, h, True), vp8])
    vp8l = _chunks(out["pillow_rgba_lossless.webp"])[0][1]
    bits = struct.unpack("<I", vp8l[1:5])[0]
    vp8l_opaque = vp8l[:1] + struct.pack("<I", bits & ~(1 << 28)) + vp8l[5:]
    out["vp8x_alpha_flag_vp8l_alpha_bit_0.webp"] = _riff(
        [_vp8x(w, h, True), (b"VP8L", vp8l_opaque)])
    out["vp8x_no_alpha_flag_vp8l.webp"] = _riff(
        [_vp8x(w, h, False), (b"VP8L", vp8l)])
    out["vp8l_alpha_bit_0.webp"] = _riff([(b"VP8L", vp8l_opaque)])
    out["two_alph_chunks.webp"] = _riff([_vp8x(w, h, True), alph, alph, vp8])
    out["alph_with_vp8l.webp"] = _riff([_vp8x(w, h, True), alph,
                                        (b"VP8L", vp8l)])
    out["canvas_not_frame_size.webp"] = _riff([_vp8x(w + 1, h, True), vp8])
    lossy = out["pillow_lossy_q90_m4.webp"]
    out["truncated_lossy.webp"] = lossy[:len(lossy) - 40]
    cut = _chunks(lossy)[0][1]
    out["token_partition_cut.webp"] = _riff([(b"VP8 ", cut[:len(cut) // 2])])
    lossless = out["pillow_lossless_q50_m6.webp"]
    ll = _chunks(lossless)[0][1]
    out["vp8l_stream_cut.webp"] = _riff([(b"VP8L", ll[:len(ll) * 2 // 3])])
    return out


# --------------------------------------------------------------- JPEG 2000
def heights16(h, w, seed):
    """(h, w) uint16 heights: six octaves of waves over 0..60000 with two
    bits of noise, ~30% ocean zeros."""
    rnd = np.random.RandomState(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for k in range(6):
        fy, fx, py, px = rnd.uniform(1, 4 * (k + 1), 4)
        f += np.sin(fy * 6.2832 * y + py) * np.cos(fx * 6.2832 * x + px) / (
            k + 1)
    f -= np.quantile(f, 0.3)
    out = np.clip(f / f.max(), 0, 1) * 60000 + rnd.randint(0, 4, (h, w))
    return np.where(f > 0, out, 0).astype(np.uint16)


# the 1024x1024 one-tile files chip_smoke.py repeats into 20480x10240
# codestreams and trains from
JP2_TILES = ("tile_1024_gray16_53_5levels.jp2", "tile_1024_rgb_97_3layers.jp2")


def jp2_tiles():
    """A 16-bit lossless heights tile (5/3, five levels) and an RGB texture
    tile (9/7 and the ICT, three quality layers), one tile each."""
    from PIL import Image

    hm = heights16(1024, 1024, 81)
    tex = terrain(1024, 1024, 82)
    return {
        JP2_TILES[0]: _pillow(Image.fromarray(hm), "JPEG2000",
                              num_resolutions=6),
        JP2_TILES[1]: _pillow(Image.fromarray(tex), "JPEG2000",
                              irreversible=True, quality_mode="rates",
                              quality_layers=[80, 40, 20]),
    }


def j2k_parts(cs):
    """A codestream as (main header up to its first SOT, [[Isot, TPsot,
    TNsot, tile-part header markers, data], ...], what follows the last
    tile-part)."""
    p = 2
    while True:
        m, n = struct.unpack(">HH", cs[p:p + 4])
        if m == 0xFF90:
            break
        p += 2 + n
    main, parts = cs[:p], []
    while cs[p:p + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[p + 4:p + 12])
        q = p + 12
        while cs[q:q + 2] != b"\xff\x93":
            q += 2 + struct.unpack(">H", cs[q + 2:q + 4])[0]
        parts.append([isot, tpsot, tnsot, cs[p + 12:q], cs[q + 2:p + psot]])
        p += psot
    return main, parts, cs[p:]


def j2k_join(main, parts, tail=b"\xff\xd9", psot0_last=False):
    out = bytearray(main)
    for i, (isot, tpsot, tnsot, hdr, data) in enumerate(parts):
        psot = 0 if psot0_last and i == len(parts) - 1 else \
            12 + len(hdr) + 2 + len(data)
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tpsot, tnsot)
        out += hdr + b"\xff\x93" + data
    return bytes(out + tail)


def _main_markers(main):
    """The main header's marker segments as [(marker, payload)], SOC and
    SIZ first."""
    out, p = [], 2
    while p < len(main):
        m, n = struct.unpack(">HH", main[p:p + 4])
        out.append((m, main[p + 4:p + 2 + n]))
        p += 2 + n
    return out


def _main(segments):
    return b"\xff\x4f" + b"".join(struct.pack(">HH", m, len(x) + 2) + x
                                  for m, x in segments)


def _edit(cs, fn):
    """The codestream with its main header's segments edited by fn."""
    main, parts, tail = j2k_parts(cs)
    return j2k_join(_main(fn(_main_markers(main))), parts, tail)


def _boxes(data):
    out, p = [], 0
    while p < len(data):
        n, t = struct.unpack(">I4s", data[p:p + 8])
        n = n or len(data) - p
        out.append((t, data[p + 8:p + n]))
        p += n
    return out


def _box(tag, payload):
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _jp2(boxes):
    return b"".join(_box(t, x) for t, x in boxes)


def _jp2h(data, fn):
    """A JP2 file with the sub-boxes of its jp2h box edited by fn."""
    return _jp2([(t, _jp2(fn(_boxes(x))) if t == b"jp2h" else x)
                 for t, x in _boxes(data)])


def _colr(enumcs=None, icc=None):
    body = b"\x02\x00\x00" + icc if icc is not None else \
        b"\x01\x00\x00" + struct.pack(">I", enumcs)
    return lambda bs: [(t, body if t == b"colr" else x) for t, x in bs]


def _cod(cs, fn):
    """The codestream with its COD segment's payload edited by fn."""
    return _edit(cs, lambda segs: [(m, fn(bytearray(x)) if m == 0xFF52
                                    else x) for m, x in segs])


def jp2_fixtures():
    """Pillow's files over its options (both wavelets, 1-7 resolutions,
    code-block and precinct sizes, tiles and offsets, every progression,
    quality layers by rate and by dB, mct, JP2 and bare codestreams, PLT,
    comments, signed samples) in gray, 16-bit gray, gray+alpha, RGB and
    RGBA; OpenCV's 16-bit gray and RGB files; codestreams rewritten here
    (tile-parts split, reordered, interleaved, TNsot 0, Psot 0, derived
    quantization, QCC and COC, JP2 boxes and colour spaces); cuts where
    openjpeg still decodes and where it fails; the kinds refused by name;
    and the two 1024x1024 tiles of chip_smoke.py's raster phase."""
    import cv2
    from PIL import Image

    out = {}
    tex = terrain(37, 45, 91)
    rgba = terrain(29, 34, 92, 4)
    rgba[..., 3] = (np.arange(34)[None] * 7).clip(0, 255)
    gray = tex[..., 1]
    g16 = heights16(37, 45, 93)
    la = np.stack([gray, tex[..., 2]], -1)
    imgs = {"gray8": Image.fromarray(gray), "gray16": Image.fromarray(g16),
            "la": Image.fromarray(la, "LA"), "rgb": Image.fromarray(tex),
            "rgba": Image.fromarray(rgba)}
    for name, img in imgs.items():
        out[f"pillow_{name}_53.jp2"] = _pillow(img, "JPEG2000")
        out[f"pillow_{name}_97.jp2"] = _pillow(img, "JPEG2000",
                                               irreversible=True)
        out[f"pillow_{name}_53.j2k"] = _pillow(img, "JPEG2000", no_jp2=True)
    rgb = imgs["rgb"]
    for r in range(1, 8):  # 9/7: levels 0 (dequantisation and ICT) to 6
        big = Image.fromarray(terrain(70, 83, 94))
        out[f"pillow_rgb_97_res{r}.jp2"] = _pillow(
            big, "JPEG2000", irreversible=True, num_resolutions=r)
        out[f"pillow_gray16_53_res{r}.jp2"] = _pillow(
            Image.fromarray(heights16(70, 83, 95)), "JPEG2000",
            num_resolutions=r)
    for cb in ((4, 4), (4, 64), (64, 16), (32, 128)):
        out[f"pillow_rgb_cb{cb[0]}x{cb[1]}.jp2"] = _pillow(
            rgb, "JPEG2000", codeblock_size=cb, irreversible=cb[0] == 64)
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for irr in (False, True):
            out[f"pillow_rgb_{prog.lower()}_{'97' if irr else '53'}.jp2"] = \
                _pillow(rgb, "JPEG2000", progression=prog,
                        precinct_size=(16, 8), tile_size=(24, 20),
                        num_resolutions=3, quality_mode="dB",
                        quality_layers=[28, 36, 44], irreversible=irr)
    out["pillow_rgb_precincts_4x128.jp2"] = _pillow(
        rgb, "JPEG2000", precinct_size=(4, 128), progression="PCRL",
        num_resolutions=2)
    out["pillow_rgb_tiles_16x20.jp2"] = _pillow(rgb, "JPEG2000",
                                                tile_size=(16, 20))
    out["pillow_rgb_97_tiles_offsets.jp2"] = _pillow(
        rgb, "JPEG2000", tile_size=(15, 12), tile_offset=(3, 2),
        offset=(7, 5), irreversible=True, progression="RPCL",
        num_resolutions=3)
    out["pillow_gray16_tiles_offsets.j2k"] = _pillow(
        imgs["gray16"], "JPEG2000", tile_size=(20, 11), tile_offset=(1, 4),
        offset=(5, 9), no_jp2=True, progression="CPRL",
        precinct_size=(8, 16), num_resolutions=3)
    for mode, layers in (("rates", [60, 30, 12]), ("dB", [24, 33, 42])):
        for irr in (False, True):
            out[f"pillow_rgb_layers_{mode}_{'97' if irr else '53'}.jp2"] = \
                _pillow(rgb, "JPEG2000", quality_mode=mode,
                        quality_layers=layers, irreversible=irr)
    out["pillow_gray16_layers_rates_97.j2k"] = _pillow(
        imgs["gray16"], "JPEG2000", quality_mode="rates",
        quality_layers=[50, 10], irreversible=True, no_jp2=True)
    out["pillow_rgb_mct0_97.jp2"] = _pillow(rgb, "JPEG2000", mct=0,
                                            irreversible=True)
    out["pillow_rgb_plt_comment.j2k"] = _pillow(
        rgb, "JPEG2000", plt=True, comment="terrain", no_jp2=True,
        tile_size=(32, 32))
    for name in ("gray8", "gray16", "la", "rgb"):
        out[f"pillow_{name}_signed.jp2"] = _pillow(imgs[name], "JPEG2000",
                                                   signed=True)
    for size in ((1, 1), (1, 9), (9, 1), (2, 3)):
        with np.errstate(invalid="ignore"):  # one height, no range
            small = Image.fromarray(terrain(*size, 96))
        out[f"pillow_rgb_{size[0]}x{size[1]}.jp2"] = _pillow(
            small, "JPEG2000", num_resolutions=1)
    out["pillow_rgb_97_odd_7x5_tiles.j2k"] = _pillow(
        Image.fromarray(terrain(7, 5, 97)), "JPEG2000", irreversible=True,
        num_resolutions=2, tile_size=(4, 4), offset=(3, 3), tile_offset=(1, 2),
        no_jp2=True)
    # OpenCV: 16-bit gray and RGB (its own openjpeg, 6 resolutions, a cdef
    # box on four channels)
    big16 = heights16(70, 73, 98)
    rgb16 = np.stack([big16, big16[::-1], big16[:, ::-1]], -1)
    for name, arr in (("gray16", big16), ("rgb16", rgb16),
                      ("rgba8", terrain(70, 73, 99, 4))):
        ok, buf = cv2.imencode(".jp2", arr)
        assert ok
        out[f"opencv_{name}.jp2"] = buf.tobytes()
    # codestreams rewritten: tile-parts
    cs = out["pillow_rgb_tiles_16x20.jp2"]
    cs = _boxes(cs)[-1][1]
    main, parts, tail = j2k_parts(cs)
    split = []
    for isot, _, _, hdr, data in parts:
        k = len(data) // 3
        split += [[isot, 0, 2, hdr, data[:k]], [isot, 1, 2, b"", data[k:]]]
    out["tileparts_split.j2k"] = j2k_join(main, split)
    out["tileparts_reversed.j2k"] = j2k_join(main, parts[::-1])
    out["tileparts_interleaved.j2k"] = j2k_join(
        main, split[0::2] + split[1::2][::-1])
    out["tileparts_tnsot0.j2k"] = j2k_join(
        main, [[a, b, 0, h, x] for a, b, _, h, x in split])
    out["tileparts_tnsot0_no_eoc.j2k"] = j2k_join(
        main, [[a, b, 0, h, x] for a, b, _, h, x in parts], tail=b"")
    out["tileparts_psot0_last.j2k"] = j2k_join(main, parts, psot0_last=True)
    out["tileparts_tile_missing.j2k"] = j2k_join(main, parts[:2] + parts[3:])
    out["cut_after_sot_marker.j2k"] = j2k_join(main, parts[:4],
                                               tail=b"\xff\x90")
    out["cut_in_tile.j2k"] = cs[:len(cs) * 2 // 3]
    out["cut_before_eoc.j2k"] = cs[:-2]
    out["cut_in_main_header.j2k"] = cs[:40]
    out["junk_for_eoc.j2k"] = cs[:-2] + b"\x12\x34"
    out["tileparts_out_of_order.j2k"] = j2k_join(
        main, [split[1], split[0]] + split[2:])
    # quantization and coding style segments
    cs97 = _boxes(out["pillow_rgb_97_res1.jp2"])[-1][1]

    def derived(segs):
        return [(m, bytes([(x[0] & 0xe0) | 1]) + x[1:3] if m == 0xFF5C else x)
                for m, x in segs]
    out["qcd_derived_res1.j2k"] = _edit(cs97, derived)
    out["qcd_derived_res4.j2k"] = _edit(
        _boxes(out["pillow_rgb_97_res4.jp2"])[-1][1], derived)

    def per_component(segs):
        cod = next(x for m, x in segs if m == 0xFF52)
        qcd = next(x for m, x in segs if m == 0xFF5C)
        return segs + [(0xFF53, bytes([1]) + cod[0:1] + cod[5:]),
                       (0xFF5D, bytes([2]) + qcd)]
    out["coc_qcc_main.j2k"] = _edit(cs, per_component)
    # JP2 boxes and colour spaces
    jrgb = out["pillow_rgb_53.jp2"]
    bxs = _boxes(jrgb)
    out["jp2_xml_uuid_boxes.jp2"] = _jp2(
        bxs[:2] + [(b"xml ", b"<terrain/>")] + bxs[2:3]
        + [(b"uuid", bytes(20))] + bxs[3:])
    out["jp2_res_bpcc_unknown.jp2"] = _jp2h(jrgb, lambda b: b + [
        (b"res ", _box(b"resc", bytes([0, 1, 0, 1, 0, 1, 0, 1, 0, 0]))),
        (b"bpcc", bytes([7, 7, 7])), (b"zzzz", b"abc")])
    out["jp2_colr_after_ihdr_swapped.jp2"] = _jp2h(jrgb, lambda b: b[::-1])
    out["jp2c_length_0.jp2"] = _jp2(bxs[:3]) + struct.pack(">I", 0) \
        + b"jp2c" + bxs[3][1]
    out["jp2_colr_icc.jp2"] = _jp2h(jrgb, _colr(icc=bytes(40)))
    out["jp2_colr_enumcs_99.jp2"] = _jp2h(jrgb, _colr(99))
    out["jp2_no_colr.jp2"] = _jp2h(
        jrgb, lambda b: [(t, x) for t, x in b if t != b"colr"])
    out["jp2_cmyk.jp2"] = _jp2h(out["pillow_rgba_53.jp2"], _colr(12))
    out["jp2_gray_colr_on_rgb.jp2"] = _jp2h(jrgb, _colr(17))
    out["jp2_ihdr_size_differs.jp2"] = _jp2h(jrgb, lambda b: [
        (t, struct.pack(">II", 40, 50) + x[8:] if t == b"ihdr" else x)
        for t, x in b])
    out["jp2_ihdr_bpc9_gray.jp2"] = _jp2h(out["pillow_gray8_53.jp2"], lambda b: [
        (t, x[:10] + bytes([9]) + x[11:] if t == b"ihdr" else x)
        for t, x in b])
    # refused by name
    j2k = out["pillow_rgb_53.j2k"]

    def insert(marker, payload):
        return _edit(j2k, lambda segs: segs + [(marker, payload)])
    out["refused_poc.j2k"] = insert(0xFF5F, bytes([0, 0, 0, 1, 6, 3, 0]))
    out["refused_ppm.j2k"] = insert(0xFF60, bytes(1))
    out["refused_rgn.j2k"] = insert(0xFF5E, bytes([0, 0, 2]))
    out["refused_sop.j2k"] = _cod(j2k, lambda x: bytes([x[0] | 2]) + x[1:])
    out["refused_cblk_style.j2k"] = _cod(
        j2k, lambda x: x[:8] + bytes([4]) + x[9:])
    out["refused_htj2k.j2k"] = _cod(
        j2k, lambda x: x[:8] + bytes([0x40]) + x[9:])
    out["refused_subsampled.j2k"] = _edit(j2k, lambda segs: [
        (m, x[:36 + 3 * 2 + 1] + bytes([2, 2]) + x[36 + 3 * 2 + 3:]
         if m == 0xFF51 else x) for m, x in segs])
    out["refused_pclr.jp2"] = _jp2h(out["pillow_gray8_53.jp2"], lambda b: b + [
        (b"pclr", struct.pack(">HB", 2, 3) + bytes([7, 7, 7]) + bytes(6))])
    out["refused_sycc.jp2"] = _jp2h(jrgb, _colr(18))
    out.update(jp2_tiles())
    return out


# ------------------------------------------------------------------- PNM
def _pnm(magic, w, h, maxval, body):
    head = b"%s\n%d %d\n" % (magic, w, h)
    return head + (b"%d\n" % maxval if maxval is not None else b"") + body


def _plain(v, per_line=12):
    v = np.asarray(v).reshape(-1)
    return b"\n".join(b" ".join(b"%d" % x for x in v[i:i + per_line])
                      for i in range(0, v.size, per_line)) + b"\n"


def pnm_fixtures():
    """P1-P6 plain and binary at maxval 1, 15, 255, 1000 and 65535,
    comments (one inside a token), Pf both ways round, Pillow's CMYK and
    RGBA kinds, Pillow's own files, a bitmap at a *.pbm path (imageio reads
    it through OpenCV), P7 and PF at *.pgm / *.ppm paths (imageio falls
    back to OpenCV where Pillow cannot open them), and the kinds refused by
    name."""
    from PIL import Image

    rnd = np.random.RandomState(51)
    t = terrain(13, 17, 52)
    bits = t[..., 0] > 100
    out = {"p1_plain.pbm": _pnm(b"P1", 17, 13, None, _plain(bits)),
           "p1_plain_tight.pgm": b"P1\n# no spaces\n17 13\n"
           + b"".join(b"".join(b"%d" % x for x in r) + b"\n"
                      for r in bits.astype(int)),
           "p4.pbm": _pnm(b"P4", 17, 13, None,
                          np.packbits(bits, axis=1).tobytes()),
           "p4.pgm": _pnm(b"P4", 17, 13, None,
                          np.packbits(bits, axis=1).tobytes())}
    for maxval in (1, 15, 255, 1000, 65535):
        g = (t[..., 1].astype(np.int64) * maxval // 255)
        c = (t.astype(np.int64) * maxval // 255)
        out[f"p2_max{maxval}.pgm"] = _pnm(b"P2", 17, 13, maxval, _plain(g))
        out[f"p3_max{maxval}.ppm"] = _pnm(b"P3", 17, 13, maxval, _plain(c))
        dt = ">u2" if maxval > 255 else np.uint8
        out[f"p5_max{maxval}.pgm"] = _pnm(b"P5", 17, 13, maxval,
                                          g.astype(dt).tobytes())
        out[f"p6_max{maxval}.ppm"] = _pnm(b"P6", 17, 13, maxval,
                                          c.astype(dt).tobytes())
    out["p5_max200_past_maxval.pnm"] = _pnm(
        b"P5", 4, 1, 200, bytes([0, 100, 200, 250]))
    out["comments.pgm"] = (b"P2\n# a comment\n1#7 inside a token\n7 1 "
                           b"#\n255\n" + _plain(t[0, :, 0]) + b"# end\n")
    out["pf_little.pgm"] = b"Pf\n17 13\n-1.0\n" + (
        t[..., 2].astype("<f4") / 7).tobytes()
    out["pf_big.pgm"] = b"Pf\n17 13\n2.5\n" + (
        t[..., 0].astype(">f4") / 3).tobytes()
    for magic in (b"P0CMYK", b"PyRGBA", b"PyCMYK"):
        four = terrain(13, 17, 53, 4)
        out[f"{magic.decode().lower()}.pnm"] = _pnm(magic, 17, 13, 255,
                                                    four.tobytes())
    out["pyrgba_max100.pnm"] = _pnm(b"PyRGBA", 17, 13, 100,
                                    (terrain(13, 17, 54, 4) % 101).tobytes())
    big = Image.fromarray(terrain(37, 41, 55))
    out["pillow_rgb.ppm"] = _pillow(big, "PPM")
    out["pillow_gray.pgm"] = _pillow(big.convert("L"), "PPM")
    out["pillow_bitmap.pbm"] = _pillow(big.convert("1"), "PPM")
    out["pillow_i16.pgm"] = _pillow(Image.fromarray(
        rnd.randint(0, 65536, (9, 11)).astype(np.uint16)), "PPM")
    out["pillow_float.pgm"] = _pillow(Image.fromarray(
        rnd.uniform(0, 300, (9, 11)).astype(np.float32)), "PPM")
    out["pam_gray_at_pgm_path.pgm"] = (
        b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
        b"TUPLTYPE GRAYSCALE\nENDHDR\n\x05")
    out["pf_colour_at_ppm_path.ppm"] = b"PF\n1 1\n-1.0\n" + bytes(12)
    out["pyp_refused.pgm"] = _pnm(b"PyP", 1, 1, 255, b"\x07")
    out["gray_at_pbm_path_refused.pbm"] = out["p5_max255.pgm"]
    out["truncated.ppm"] = out["p6_max255.ppm"][:-7]
    out["plain_too_large.pgm"] = _pnm(b"P2", 2, 1, 9, b"3 12\n")
    return out


# -------------------------------------------------------------------- TGA
def _tga(img_type, depth, w, h, data, flags=0x20, cmap=b"", cmap_depth=0,
         start=0, ident=b""):
    n = len(cmap) // (2 if cmap_depth == 16 else max(cmap_depth, 8) // 8)
    return struct.pack("<BBBHHBHHHHBB", len(ident), int(bool(cmap)),
                       img_type, start, n, cmap_depth, 0, 0, w, h, depth,
                       flags) + ident + cmap + data


def _tga_rle(px, bpp):
    """Run-length packets of a (n, bpp) pixel stream: a repeat for each run
    of 2-128 equal pixels within a row of 7, literals otherwise, one
    literal of up to 128 running on across rows."""
    out, i, n = bytearray(), 0, len(px)
    while i < n:
        j = i
        while j + 1 < n and j + 1 - i < 128 and (j + 1) % 7 and \
                bytes(px[j + 1]) == bytes(px[i]):
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + bytes(px[i])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and bytes(px[j]) != bytes(px[j - 1]):
            j += 1
        out += bytes([j - i - 1]) + px[i:j].tobytes()
        i = j
    return bytes(out)


def tga_fixtures():
    """Image types 1-3 and 9-11 at every depth Pillow reads, 16- and
    24-bit colour maps (a first index, indices past the map), the four
    origins, an ID field, run-length literals running on across rows,
    Pillow's own files, and what Pillow cannot read."""
    from PIL import Image

    rnd = np.random.RandomState(61)
    w, h = 7, 5
    t = terrain(h, w, 62, 4)
    rgb, gray = t[..., 2::-1], t[..., 0]
    v16 = (rnd.randint(0, 1 << 16, (h, w)).astype("<u2"))
    out = {}
    for rle in (0, 8):
        tag = "_rle" if rle else ""
        for name, typ, depth, px in (
                ("gray8", 3, 8, gray[..., None]),
                ("gray_alpha16", 3, 16, t[..., :2]),
                ("bgr24", 2, 24, rgb),
                ("bgra32", 2, 32, np.dstack([rgb, t[..., 3]])),
                ("bgra15", 2, 16, v16.view(np.uint8).reshape(h, w, 2))):
            flat = px.reshape(-1, px.shape[-1])
            data = _tga_rle(flat, flat.shape[1]) if rle else flat.tobytes()
            out[f"{name}{tag}.tga"] = _tga(typ | rle, depth, w, h, data)
        idx = rnd.randint(0, 9, (h, w)).astype(np.uint8)
        data = _tga_rle(idx.reshape(-1, 1), 1) if rle else idx.tobytes()
        out[f"map24{tag}.tga"] = _tga(1 | rle, 8, w, h, data,
                                      cmap=rnd.randint(0, 256, 18).astype(
                                          np.uint8).tobytes(), cmap_depth=24,
                                      start=2)
        out[f"map16{tag}.tga"] = _tga(1 | rle, 8, w, h, data,
                                      cmap=rnd.randint(0, 1 << 16, 7).astype(
                                          "<u2").tobytes(), cmap_depth=16)
    out["bitmap1.tga"] = _tga(3, 1, 11, 3, np.packbits(
        rnd.randint(0, 2, (3, 11)).astype(np.uint8), axis=1).tobytes())
    for flags in (0x00, 0x10, 0x30):
        out[f"origin_{flags:02x}.tga"] = _tga(2, 24, w, h, rgb.tobytes(),
                                              flags=flags)
        out[f"origin_{flags:02x}_rle.icb"] = _tga(
            10, 32, w, h, _tga_rle(t.reshape(-1, 4), 4), flags=flags)
    out["ident.vda"] = _tga(3, 8, w, h, gray.tobytes(), ident=b"terrain")
    out["long_literal_rle.vst"] = _tga(11, 8, 2, 3,
                                       bytes([0x05, 1, 2, 3, 4, 5, 6]))
    big = Image.fromarray(terrain(29, 31, 63, 4))
    for rle in (False, True):
        tag = "_rle" if rle else ""
        for mode in ("RGB", "RGBA", "L", "LA", "1"):
            out[f"pillow_{mode.lower()}{tag}.tga"] = _pillow(
                big.convert(mode), "TGA", rle=rle and mode != "1")
        out[f"pillow_p{tag}.tga"] = _pillow(big.convert("RGB").quantize(40),
                                            "TGA", rle=rle)
    out["map32_unreadable.tga"] = _tga(1, 8, 2, 1, bytes([0, 1]),
                                       cmap=bytes(8), cmap_depth=32)
    out["repeat_across_rows.tga"] = _tga(11, 8, 2, 2, bytes([0x83, 7]))
    out["truncated_rle.tga"] = _tga(10, 24, 2, 2, bytes([0x81, 1, 2, 3]))
    return out


# ------------------------------------------------------------ PFM and PAM
def _cv(img, ext, params=()):
    import cv2

    ok, buf = cv2.imencode(ext, img, list(params))
    if not ok:
        raise RuntimeError(f"OpenCV wrote no {ext}")
    return buf.tobytes()


def _pfm(magic, v, scale):
    """PFM bytes of v (H, W) or (H, W, 3), rows bottom-up, little-endian for
    a negative scale."""
    h, w = v.shape[:2]
    order = "<f4" if scale < 0 else ">f4"
    return (b"%s\n%d %d\n%r\n" % (magic, w, h, scale)
            + v[::-1].astype(order).tobytes())


def _pam(w, h, depth, maxval, tupltype, body, extra=b""):
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + extra + b"ENDHDR\n" + body


def pfm_pam_fixtures():
    """PFM (Pf, PF) and PAM (P7) files, which imageio reads through OpenCV
    at a *.pfm or *.pam path and as PF or P7 bytes: OpenCV's own files (Pf
    and PF; PAM of every tuple type it writes, 8 and 16 bits), and the
    script's: both byte orders and other scales, values at .5 and at the
    saturation edges, NaN and infinities, PAM headers with comments, blank
    and CR-ended lines, maxval 1 (packed bits) and unscaled maxvals, PF and
    P7 at *.ppm / *.pgm / *.pnm paths, and what OpenCV fails on or leaves
    undefined."""
    import cv2

    rnd = np.random.RandomState(61)
    heights = (rnd.randint(0, 601, (13, 17)) / 2).astype(np.float32)
    colour = rnd.uniform(-20, 300, (9, 11, 3)).astype(np.float32)
    colour[0, :4] = [[0.5, 1.5, 2.5], [254.5, 255.5, 256.0],
                     [-0.5, -0.6, 127.5], [0.49999997, 1e10, -3e9]]
    out = {"cv_pf_gray.pfm": _cv(heights, ".pfm"),
           "cv_pf_colour.pfm": _cv(colour, ".pfm")}
    edge = np.array([[0.5, 1.5, 2.5, 254.5, 255.5, 256, -0.4, -0.5],
                     [np.nan, np.inf, -np.inf, 3e9, 2147483648.0, -3e9,
                      127.49999, 1.4999999]], np.float32)
    out["pf_gray_edges_big_endian.pfm"] = _pfm(b"Pf", edge, 1.0)
    out["pf_gray_scale_2_5.pfm"] = _pfm(b"Pf", heights * 2.5, 2.5)
    out["pf_colour_scale_0_3.pfm"] = _pfm(b"PF", colour * 0.3, -0.3)
    out["pf_colour_big_endian.pfm"] = _pfm(b"PF", colour, 7.0)
    out["pf_colour_scaled_at_ppm_path.ppm"] = _pfm(b"PF", colour, -1.0)
    out["pf_colour_at_pnm_path.pnm"] = _pfm(b"PF", colour, -2.0)
    out["pf_header_tokens.pfm"] = (b"Pf\n17\n13\t-1.0e0\n"
                                   + heights[::-1].astype("<f4").tobytes())
    out["pf_scale_zero.pfm"] = b"Pf\n2 1\n0\n" + bytes(8)
    out["pf_cut_short.pfm"] = _pfm(b"PF", colour, -1.0)[:-5]
    u8 = terrain(11, 13, 62)
    for tt in ("NULL", "BLACKANDWHITE", "GRAYSCALE", "RGB", "RGB_ALPHA"):
        code = getattr(cv2, "IMWRITE_PAM_FORMAT_" + tt)
        img = {"RGB": u8, "RGB_ALPHA": terrain(11, 13, 63, 4)}.get(
            tt, u8[..., 1])
        for bits in (8, 16):
            px = img if bits == 8 else img.astype(np.uint16) * 257 + 3
            out[f"cv_pam_{tt.lower()}_{bits}.pam"] = _cv(
                px, ".pam", (cv2.IMWRITE_PAM_TUPLETYPE, code))
    out["cv_pam_null_rgb_8.pam"] = _cv(u8, ".pam", (
        cv2.IMWRITE_PAM_TUPLETYPE, cv2.IMWRITE_PAM_FORMAT_NULL))
    g = u8[..., 2]
    out["pam_comments_cr.pam"] = (
        b"P7\r# written by hand\r\n  WIDTH   13  \n\n#x\rHEIGHT\t11\n"
        b"DEPTH 1\nMAXVAL 255\nTUPLTYPE RGB\nTUPLTYPE GRAYSCALE   \n"
        b"ENDHDR\n" + g.tobytes())
    out["pam_maxval1_bits.pam"] = _pam(13, 11, 1, 1, b"BLACKANDWHITE",
                                       rnd.randint(0, 256, 143).astype(
                                           np.uint8).tobytes())
    out["pam_maxval100_unscaled.pam"] = _pam(13, 11, 3, 100, b"RGB",
                                             u8.tobytes())
    out["pam_grayscale_at_pgm_path.pgm"] = _pam(13, 11, 1, 255,
                                                b"GRAYSCALE", g.tobytes())
    out["pam_rgb_at_pnm_path.pnm"] = _pam(13, 11, 3, 255, None,
                                          u8.tobytes())
    out["pam_lowercase_names.pam"] = (b"P7\nwidth 1\nheight 1\ndepth 1\n"
                                      b"maxval 255\nendhdr\n\x05")
    out["pam_depth_mismatch.pam"] = _pam(2, 1, 1, 255, b"RGB", b"\x01\x02")
    out["pam_cut_short.pam"] = out["cv_pam_rgb_8.pam"][:-4]
    out["pam_gray_alpha_refused.pam"] = _pam(
        13, 11, 2, 255, b"GRAYSCALE_ALPHA",
        rnd.randint(0, 256, 286).astype(np.uint8).tobytes())
    out["pam_at_pfm_path.pfm"] = out["pam_grayscale_at_pgm_path.pgm"]
    out["p5_at_pfm_path_refused.pfm"] = _pnm(b"P5", 2, 1, 255, b"\x01\x02")
    return out


# ------------------------------------------------------------ Radiance HDR
def _rgbe_rle(px, rnd):
    """One new-style scanline of px (W, 4): each channel as runs and
    literals, chosen at random where both fit."""
    w = len(px)
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch = px[:, c].tolist()
        i = 0
        while i < w:
            j = i
            while j < w and ch[j] == ch[i] and j - i < 127:
                j += 1
            if j - i >= 2 and rnd.rand() < 0.8:
                out += bytes([128 + j - i, ch[i]])
                i = j
            else:
                k = min(int(rnd.randint(1, 10)), w - i)
                out += bytes([k] + ch[i:i + k])
                i += k
    return bytes(out)


def _rgbe_pixels(h, w, rnd):
    px = rnd.choice([0, 1, 2, 3, 100, 128, 129, 255], (h, w, 4)).astype(
        np.uint8)
    px[..., 3] = rnd.choice([0, 1, 100, 120, 127, 128, 129, 134, 135, 136,
                             140, 160, 255], (h, w))
    return px


def hdr_fixtures():
    """Radiance files, which imageio reads through OpenCV by path and by
    bytes: OpenCV's own (run-length and flat), and the script's: old-style
    runs read flat, new-style scanlines then flat ones, widths under 8,
    the #?RGBE magic, comments and EXPOSURE before and after the FORMAT
    line, a header line longer than fgets' 127 bytes, exponents from 0 to
    255 (products at .5 and past 255), a *.pic path, and what OpenCV fails
    on."""
    rnd = np.random.RandomState(71)
    img = rnd.uniform(0, 1.2, (9, 23, 3)).astype(np.float32)
    img[0, :4] = [[0.5 / 255, 1.5 / 255, 2.5 / 255]] * 4
    import cv2

    out = {"cv_rle.hdr": _cv(img, ".hdr", (
        cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_RLE)),
        "cv_flat.hdr": _cv(img, ".hdr", (
            cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE))}
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    px = _rgbe_pixels(6, 19, rnd)
    size = b"-Y 6 +X 19\n"
    out["exponents_flat.hdr"] = head + size + px.tobytes()
    old = px.copy()
    old[1, 3:6] = [1, 1, 1, 2]  # an old-style run: read flat by OpenCV
    out["old_style_run_flat.hdr"] = head + size + old.tobytes()
    out["rle_then_flat.hdr"] = head + size + b"".join(
        _rgbe_rle(px[y], rnd) for y in range(3)) + px[3:].tobytes()
    out["all_rle.hdr"] = head + size + b"".join(
        _rgbe_rle(px[y], rnd) for y in range(6))
    narrow = _rgbe_pixels(5, 7, rnd)
    out["narrow_flat.hdr"] = head + b"-Y 5 +X 7\n" + narrow.tobytes()
    out["rgbe_magic_comments.hdr"] = (
        b"#?RGBE\n# made by hand\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n"
        b"GAMMA=2.2\n\n-Y  6   +X 19\n" + px.tobytes())
    out["long_header_line.hdr"] = (
        b"#?RADIANCE\n#" + b"x" * 200 + b"\nFORMAT=32-bit_rle_rgbe\n#"
        + b"y" * 125 + b"\n\n" + size + px.tobytes())
    out["at_pic_path.pic"] = out["all_rle.hdr"]
    out["plus_y_orientation.hdr"] = head + b"+Y 6 +X 19\n" + px.tobytes()
    out["no_format_line.hdr"] = b"#?RADIANCE\n\n" + size + px.tobytes()
    out["crlf_header.hdr"] = (b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n"
                              + size + px.tobytes())
    out["rle_cut_short.hdr"] = out["all_rle.hdr"][:-9]
    out["flat_cut_short.hdr"] = out["exponents_flat.hdr"][:-1]
    return out


# -------------------------------------------------------------- Sun raster
def _sun(w, h, depth, body, ftype=1, maptype=0, cmap=b"", length=None):
    return struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(body) if length is None else length, ftype,
                       maptype, len(cmap)) + cmap + body


def _sun_rle(raw):
    """Byte-encoded (type 2) data: runs of 3 or more, a lone 0x80 escaped,
    runs of up to 256 crossing row ends."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        if j - i >= 3 or raw[i] == 0x80:
            out += (b"\x80\x00" if j - i == 1 else
                    bytes([0x80, j - i - 1, raw[i]]))
            i = j
        else:
            out.append(raw[i])
            i += 1
    return bytes(out)


def sun_fixtures():
    """Sun rasters, which imageio reads through Pillow by bytes and at a
    *.ras path and through OpenCV at a *.sr path: each kind at both names.
    OpenCV's own files; depths 1, 4, 8, 24 and 32, odd widths (rows padded
    to 16 bits), colour maps of 1, 2, 16 and 256 entries (planar), file
    types 0, 1, 3 (RGB order) and 2 (byte-encoded runs that carry across
    rows, escaped 0x80s), and what Pillow or OpenCV fails on (depth 16,
    type 6, a raw colour map, a depth-1 image with a map, cut files), and
    the GIMP-brush header refused by name."""
    rnd = np.random.RandomState(81)
    tex = terrain(9, 14, 82)  # even rows: OpenCV writes no padding byte,
    out = {}                  # which it would leave unset

    def both(name, data):
        out[f"{name}.ras"] = data
        out[f"{name}.sr"] = data

    both("cv_rgb", _cv(tex, ".sr"))
    both("cv_gray", _cv(tex[..., 1], ".sr"))

    def raw(w, h, depth):
        stride = ((w * depth + 15) // 16) * 2
        return rnd.randint(0, 256, stride * h).astype(np.uint8).tobytes()

    both("depth1", _sun(13, 9, 1, raw(13, 9, 1)))
    out["depth4.ras"] = _sun(13, 9, 4, raw(13, 9, 4))
    out["depth4_map16.ras"] = _sun(13, 9, 4, raw(13, 9, 4), 1, 1, bytes(
        rnd.randint(0, 256, 48).astype(np.uint8)))
    both("depth8", _sun(13, 9, 8, raw(13, 9, 8), 0))
    both("depth8_map256", _sun(13, 9, 8, raw(13, 9, 8), 1, 1, bytes(
        rnd.randint(0, 256, 768).astype(np.uint8))))
    both("depth8_map2", _sun(13, 9, 8, bytes(rnd.randint(0, 3, 126).astype(
        np.uint8)), 1, 1, bytes([0, 255, 10, 20, 30, 40])))
    both("depth1_map2", _sun(13, 9, 1, raw(13, 9, 1), 1, 1,
                             bytes([0, 255, 10, 20, 30, 40])))
    both("depth24", _sun(13, 9, 24, raw(13, 9, 24)))
    both("depth24_rgb_type3", _sun(13, 9, 24, raw(13, 9, 24), 3))
    both("depth32", _sun(13, 9, 32, raw(13, 9, 32)))
    out["depth32_rgb_type3.ras"] = _sun(13, 9, 32, raw(13, 9, 32), 3)
    for depth in (1, 8, 24):
        row = (13 * depth + 7) // 8
        data = rnd.choice([0, 7, 0x80, 200], row * 9).astype(np.uint8)
        data[5:70] = 9  # a run crossing rows
        both(f"rle_depth{depth}", _sun(13, 9, depth,
                                       _sun_rle(data.tobytes()), 2))
    both("depth16", _sun(13, 9, 16, raw(13, 9, 16)))
    both("type6", _sun(13, 9, 8, raw(13, 9, 8), 6))
    both("map_type2", _sun(13, 9, 8, raw(13, 9, 8), 1, 2, bytes(6)))
    both("cut_short", _sun(13, 9, 24, raw(13, 9, 24))[:-30])
    both("rle_cut_short", out["rle_depth8.ras"][:-6])
    out["gimp_brush_header_refused.ras"] = _sun(2, 3, 8, bytes(12),
                                                length=4)
    return out


# --------------------------------------------------------------------- DDS
DDS_TILES = ("tile_1024_dxt1.dds", "tile_1024_bc7.dds")
_DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83,
         "BC5_SNORM": 84, "BC6H_UF16": 95, "BC6H_SF16": 96, "BC7": 98,
         "BC7_SRGB": 99, "R8G8B8A8": 28}


def _dds(w, h, body, fourcc=None, dxgi=None, pfflags=0x4, bitcount=0,
         masks=(0, 0, 0, 0), mipmaps=0):
    """A DDS header (and DX10 extension where `dxgi` is given) over body."""
    if dxgi is not None:
        fourcc = b"DX10"
    pf = struct.pack("<2I4sI4I", 32, pfflags, fourcc or bytes(4), bitcount,
                     *masks)
    head = (struct.pack("<7I", 124, 0x1007, h, w, 0, 0, mipmaps) + bytes(44)
            + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    ext = struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return b"DDS " + head + ext + body


def _bc_blocks(rnd, n, kind):
    """n random 16-byte blocks reaching every BC7 or BC6H mode (reserved
    ones too), or random 8- or 16-byte blocks."""
    size = 8 if kind in ("BC1", "BC4") else 16
    b = rnd.randint(0, 256, (n, size)).astype(np.uint8)
    if kind == "BC7":
        for i in range(n):
            m = i % 9  # modes 0-7, and 8: a first byte of 0
            b[i, 0] = 0 if m == 8 else (int(b[i, 0]) >> (m + 1) << (m + 1)
                                        | 1 << m)
    elif kind.startswith("BC6H"):
        modes = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23]
        for i in range(n):
            b[i, 0] = (int(b[i, 0]) & 0xE0) | modes[i % len(modes)]
    return b.tobytes()


def dds_fixtures():
    """DDS files, which imageio reads through Pillow by bytes and path:
    Pillow's own (RGB, RGBA, L, LA, DXT1/3/5, BC2, BC3, BC5) at sizes that
    are and are not multiples of 4; the script's: DX10 over seeded random
    BC1-BC7 blocks (BC6H UF16 and SF16 and BC7 reaching every mode),
    fourCCs ATI1, ATI2, BC4U, BC5U, BC5S, uncompressed masks (5-6-5,
    1-5-5-5, 10-10-10-2, sparse ones), a palette, R8G8B8A8, mipmaps after
    the first surface, a short uncompressed surface (zeros); what Pillow
    fails on; and the two 1024x1024 tiles chip_smoke.py repeats into a
    21600x10800 texture (Pillow's DXT1 of a terrain texture, random BC7
    blocks)."""
    from PIL import Image

    rnd = np.random.RandomState(91)
    out = {}
    for w, h in ((16, 12), (13, 9)):
        im = Image.fromarray(terrain(h, w, 92, 4))
        out[f"pillow_rgba_{w}x{h}.dds"] = _pillow(im, "DDS")
        out[f"pillow_rgb_{w}x{h}.dds"] = _pillow(im.convert("RGB"), "DDS")
        out[f"pillow_l_{w}x{h}.dds"] = _pillow(im.convert("L"), "DDS")
        out[f"pillow_la_{w}x{h}.dds"] = _pillow(im.convert("LA"), "DDS")
        for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
            out[f"pillow_{pf.lower()}_{w}x{h}.dds"] = _pillow(
                im, "DDS", pixel_format=pf)
        out[f"pillow_bc5_{w}x{h}.dds"] = _pillow(im.convert("RGB"), "DDS",
                                                 pixel_format="BC5")
    w, h = 19, 13
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    for kind, dxgi in _DXGI.items():
        if kind == "R8G8B8A8":
            body = rnd.randint(0, 256, w * h * 4).astype(np.uint8).tobytes()
        else:
            body = _bc_blocks(rnd, nb, kind.split("_")[0] if not
                              kind.startswith("BC6H") else "BC6H")
        out[f"dx10_{kind.lower()}.dds"] = _dds(w, h, body, dxgi=dxgi)
    for cc in (b"ATI1", b"BC4U", b"ATI2", b"BC5U", b"BC5S"):
        size = 8 if cc in (b"ATI1", b"BC4U") else 16
        out[f"fourcc_{cc.decode().lower()}.dds"] = _dds(
            w, h, rnd.randint(0, 256, nb * size).astype(np.uint8).tobytes(),
            fourcc=cc)
    px = rnd.randint(0, 256, w * h * 4).astype(np.uint8).tobytes()
    for name, bits, masks, flags in (
            ("rgb565", 16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
            ("argb1555", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
            ("a2rgb10", 32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 0x41),
            ("bgr24", 24, (0xFF, 0xFF00, 0xFF0000, 0), 0x40),
            ("sparse_masks", 16, (0xA5, 0x5A00, 0, 0), 0x40)):
        out[f"masks_{name}.dds"] = _dds(w, h, px[:w * h * bits // 8],
                                        pfflags=flags, bitcount=bits,
                                        masks=masks)
    out["masks_short_surface.dds"] = out["masks_rgb565.dds"][:-40]
    out["palette8.dds"] = _dds(w, h, rnd.randint(0, 256, 1024).astype(
        np.uint8).tobytes() + px[:w * h], pfflags=0x20, bitcount=8)
    out["mipmaps_bc7.dds"] = _dds(8, 8, _bc_blocks(rnd, 4 + 1, "BC7"),
                                  dxgi=98, mipmaps=2)
    out["dxgi_unknown.dds"] = _dds(w, h, px, dxgi=87)
    out["fourcc_unknown.dds"] = _dds(w, h, px, fourcc=b"RXGB")
    out["luminance16.dds"] = _dds(w, h, px[:2 * w * h], pfflags=0x20000,
                                  bitcount=16)
    out["bc7_cut_short.dds"] = out["dx10_bc7.dds"][:-3]
    out["header_size_100.dds"] = (out["dx10_bc1.dds"][:4]
                                  + struct.pack("<I", 100)
                                  + out["dx10_bc1.dds"][8:])
    tex = Image.fromarray(terrain(1024, 1024, 93, 3))
    out[DDS_TILES[0]] = _pillow(tex, "DDS", pixel_format="DXT1")
    out[DDS_TILES[1]] = _dds(1024, 1024, _bc_blocks(rnd, 256 * 256, "BC7"),
                             dxgi=98)
    return out


# -------------------------------------------------------------------- SGI
def _sgi_rle_row(v, bpc, rnd=None):
    """One row of SGI run-length packets (runs of 3 or more repeated,
    literal runs otherwise, at most 127 samples a packet) and the
    terminator; 16-bit samples as big-endian words."""
    out, i, n = bytearray(), 0, len(v)
    word = (lambda x: bytes([int(x)])) if bpc == 1 else \
        (lambda x: struct.pack(">H", int(x)))
    while i < n:
        j = i
        while j < n and v[j] == v[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += word(j - i) + word(v[i])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 127 and not (j + 2 < n and v[j] == v[j + 1]
                                             == v[j + 2]):
            j += 1
        out += word(0x80 | (j - i)) + b"".join(word(x) for x in v[i:j])
        i = j
    return bytes(out + word(0))


def _packets(row):
    """The 8-bit SGI packets of a row, the terminator included."""
    i = 0
    while i < len(row):
        n = row[i] & 0x7F
        yield row[i:i + 1 + (n if row[i] & 0x80 else min(n, 1))]
        if not n:
            return
        i += 1 + (n if row[i] & 0x80 else 1)


def sgi_bytes(planes, bpc=1, storage=0, rows=None, dim=None, tail=b""):
    """An SGI file of planes (z, h, w) (uint8, or uint16 for bpc 2): storage
    0 planes bottom-up, or 1 with `rows` (z * h, channel-major, bottom row
    first; default _sgi_rle_row of each) behind the offset and length
    tables: a row's packets, (packets, length field), or (offset, length
    field) of data elsewhere."""
    z, h, w = planes.shape
    dim = dim or (3 if z > 1 else (1 if h == 1 else 2))
    head = struct.pack(">hBBHHHHll", 474, storage, bpc, dim, w, h, z, 0,
                       255 if bpc == 1 else 65535).ljust(512, b"\0")
    flip = planes[:, ::-1]
    if storage != 1:
        dt = ">u2" if bpc == 2 else "u1"
        return head + flip.astype(dt).tobytes() + tail
    rows = rows or [_sgi_rle_row(flip[c, r].tolist(), bpc)
                    for c in range(z) for r in range(h)]
    at, body, starts, lengths = 512 + 8 * z * h, b"", [], []
    for row in rows:
        row, length = row if isinstance(row, tuple) else (row, len(row))
        if isinstance(row, int):
            starts.append(row)
        else:
            starts.append(at + len(body))
            body += row
        lengths.append(length)
    return (head + struct.pack(f">{z * h}I", *starts)
            + struct.pack(f">{z * h}I", *lengths) + body + tail)


def sgi_fixtures():
    """SGI files, by Pillow (uncompressed, 8 and 16 bits, at each of the
    four names) and by the script (run-length rows: 8 and 16 bits, 1, 3
    and 4 channels, rows that share data, rows that end early, a length
    field that counts packets, one that stops Pillow's decode (refused:
    the rows it leaves unwritten are not defined), overruns, cuts)."""
    from PIL import Image

    tex = terrain(11, 13, 101, 4)
    out = {"pillow_gray.sgi": _pillow(Image.fromarray(tex[..., 0]), "SGI"),
           "pillow_rgb.rgb": _pillow(Image.fromarray(tex[..., :3]), "SGI"),
           "pillow_rgba.rgba": _pillow(Image.fromarray(tex), "SGI"),
           "pillow_gray16.bw": _pillow(Image.fromarray(tex[..., 1]), "SGI",
                                       bpc=2),
           "pillow_rgb16.sgi": _pillow(Image.fromarray(tex[..., :3]), "SGI",
                                       bpc=2),
           "pillow_one_row.sgi": _pillow(Image.fromarray(tex[:1, :, 2]),
                                         "SGI")}
    planes = np.ascontiguousarray(tex.transpose(2, 0, 1))
    wide = (planes.astype(np.uint16) * 257 + np.arange(13, dtype=np.uint16))
    out["rle_gray.sgi"] = sgi_bytes(planes[:1], storage=1)
    out["rle_rgb.rgb"] = sgi_bytes(planes[:3], storage=1)
    out["rle_rgba.rgba"] = sgi_bytes(planes, storage=1)
    out["rle_gray16.bw"] = sgi_bytes(wide[:1], 2, 1)
    out["rle_rgb16.sgi"] = sgi_bytes(wide[:3], 2, 1)
    out["rle_rgba16.sgi"] = sgi_bytes(wide, 2, 1)
    out["rle_dimension1.sgi"] = sgi_bytes(planes[:1, :1], storage=1)
    rows = [_sgi_rle_row(planes[0, ::-1][r].tolist(), 1) for r in range(11)]
    first = 512 + 8 * 11
    out["rle_shared_rows.sgi"] = sgi_bytes(
        planes[:1], storage=1,
        rows=[rows[0]] + [(first, len(rows[0]))] * 4 + rows[5:])
    short = [r[:3] + b"\0" if k % 3 == 1 else r for k, r in enumerate(rows)]
    out["rle_rows_end_early.sgi"] = sgi_bytes(planes[:1], storage=1,
                                              rows=short)
    packets = [(r, r.count(0) and sum(1 for _ in _packets(r))) for r in rows]
    out["rle_length_counts_packets.sgi"] = sgi_bytes(planes[:1], storage=1,
                                                     rows=packets)
    out["rle_stops_at_a_row_refused.sgi"] = sgi_bytes(
        planes[:1], storage=1, rows=rows[:6] + [(rows[6], 1)] + rows[7:])
    out["rle_overrun.sgi"] = sgi_bytes(
        planes[:1], storage=1, rows=rows[:4] + [bytes([0x7f, 9, 0])]
        + rows[5:])
    out["rle_offset_in_header.sgi"] = sgi_bytes(
        planes[:1], storage=1, rows=rows[:2] + [(100, 5)] + rows[3:])
    out["rle_cut_short.sgi"] = out["rle_rgb.rgb"][:-40]
    out["rle_tables_cut.sgi"] = out["rle_rgb.rgb"][:512 + 100]
    out["raw_cut_short.sgi"] = out["pillow_rgb.rgb"][:-7]
    out["raw16_cut_short.sgi"] = out["pillow_gray16.bw"][:-7]
    out["storage_2.sgi"] = sgi_bytes(planes[:1], storage=2)
    out["dimension3_one_channel.sgi"] = sgi_bytes(planes[:1], dim=3)
    out["header_cut.sgi"] = out["pillow_gray.sgi"][:9]
    out["zero_width.sgi"] = sgi_bytes(planes[:1, :, :0])
    return out


# -------------------------------------------------------------------- PCX
def _pcx_rle_line(line, escape_all=False):
    """PCX runs of one scan line: a repeated byte or one of 0xC0 and above
    as (0xC0 | count, value), at most 63 a run; never across lines."""
    out, i = bytearray(), 0
    while i < len(line):
        j = i
        while j < len(line) and line[j] == line[i] and j - i < 63:
            j += 1
        if j - i > 1 or line[i] >= 0xC0 or escape_all:
            out += bytes([0xC0 | (j - i), line[i]])
            i = j
        else:
            out.append(line[i])
            i += 1
    return bytes(out)


def pcx_bytes(lines, w, h, bits, planes, stride, version=5, palette=b"",
              trailer=b"", body=None):
    """A PCX file: the 128-byte header (the stride field `stride`), the
    scan lines (h, planes x Pillow's stride) in runs, then `trailer`."""
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                       h - 1, 72, 72) + palette.ljust(48, b"\0")[:48]
    head = (head + b"\0" + bytes([planes]) + struct.pack("<HH", stride, 1)
            ).ljust(128, b"\0")
    if body is None:
        body = b"".join(_pcx_rle_line(bytes(line)) for line in lines)
    return head + body + trailer


def pcx_fixtures():
    """PCX files: Pillow's (1 bit, gray, palette, RGB; odd widths) and the
    script's: 1 bit in 2 and 4 planes (even and padded strides, a width of
    3, whose padded planes Pillow moves together), a 3-pixel RGB line
    Pillow does not move, a short 8-bit file (gray from bytes, refused by
    imageio's file seek at its path), a trailer that is the gray ramp, a
    run across a line, cuts, other kinds."""
    from PIL import Image

    rnd = np.random.RandomState(111)
    tex = terrain(9, 17, 112, 3)
    img = Image.fromarray(tex)
    out = {"pillow_bitmap.pcx": _pillow(img.convert("1"), "PCX"),
           "pillow_gray.pcx": _pillow(img.convert("L"), "PCX"),
           "pillow_palette.pcx": _pillow(img.quantize(40), "PCX"),
           "pillow_rgb.pcx": _pillow(img, "PCX"),
           "pillow_rgb_w3.pcx": _pillow(Image.fromarray(tex[:, :3]), "PCX"),
           "pillow_gray_w1.pcx": _pillow(img.convert("L").crop((0, 0, 1, 9)),
                                         "PCX")}
    pal = bytes(rnd.randint(0, 256, 48).astype(np.uint8))
    for planes in (2, 4):
        for w, pad in ((16, 0), (17, 1), (3, 1)):
            st = (w + 7) // 8
            stride = st + (st % 2 if pad else 0)
            lines = rnd.randint(0, 256, (5, planes * stride)).astype(np.uint8)
            out[f"planes{planes}_w{w}.pcx"] = pcx_bytes(
                lines, w, 5, 1, planes, st + pad, 2, pal)
    gray = tex[..., 1]
    out["gray_ramp_trailer.pcx"] = pcx_bytes(
        gray, 17, 9, 8, 1, 18, trailer=b"\x0c" + bytes(
            np.repeat(np.arange(256, dtype=np.uint8), 3)))
    out["gray_short_file.pcx"] = pcx_bytes(
        np.pad(gray[:2, :5], ((0, 0), (0, 1))), 5, 2, 8, 1, 6)
    padded = np.zeros((9, 3, 6), np.uint8)  # planes of 5 pixels + 1
    padded[:, :, :5] = tex[:, :5].transpose(0, 2, 1)
    out["rgb_w5_padded.pcx"] = pcx_bytes(padded.reshape(9, -1), 5, 9, 8, 3,
                                         6)
    out["run_crosses_lines.pcx"] = pcx_bytes(None, 17, 9, 8, 1, 18,
                                             body=bytes([0xC0 | 30, 7]) * 6)
    out["cut_short.pcx"] = out["pillow_rgb.pcx"][:200]
    out["header_cut.pcx"] = out["pillow_rgb.pcx"][:66]
    out["version3_8bit.pcx"] = pcx_bytes(gray, 17, 9, 8, 1, 18, version=3)
    out["bits4.pcx"] = pcx_bytes(gray, 17, 9, 4, 1, 18)
    out["empty_box.pcx"] = out["pillow_gray.pcx"][:8] + struct.pack(
        "<H", 0xFFFF) + out["pillow_gray.pcx"][10:]
    return out


# -------------------------------------------------------------------- QOI
def _qoi_hash(p):
    return (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64


def qoi_bytes(px, channels=None, end=True, ops=None):
    """A QOI file of px (h, w, 4) by the format's encoder (index, diff,
    luma, run, RGB and RGBA ops), or of the raw op bytes `ops`."""
    h, w = px.shape[:2]
    head = b"qoif" + struct.pack(">II", w, h) + bytes(
        [channels or px.shape[-1], 0])
    if ops is None:
        ops, index = bytearray(), [None] * 64
        prev, run = (0, 0, 0, 255), 0
        flat = [tuple(int(v) for v in p) for p in px.reshape(-1, 4)]
        for k, p in enumerate(flat):
            if p == prev:
                run += 1
                if run == 62 or k == len(flat) - 1:
                    ops.append(0xC0 | (run - 1))
                    run = 0
                continue
            if run:
                ops.append(0xC0 | (run - 1))
                run = 0
            hsh = _qoi_hash(p)
            if index[hsh] == p:
                ops.append(hsh)
            elif p[3] != prev[3]:
                ops += bytes([0xFF, *p])
            else:
                d = [(p[i] - prev[i] + 128) % 256 - 128 for i in range(3)]
                dg = d[1]
                if all(-2 <= x <= 1 for x in d):
                    ops.append(0x40 | (d[0] + 2) << 4 | (d[1] + 2) << 2
                               | (d[2] + 2))
                elif -32 <= dg <= 31 and all(-8 <= d[i] - dg <= 7
                                             for i in (0, 2)):
                    ops += bytes([0x80 | (dg + 32),
                                  (d[0] - dg + 8) << 4 | (d[2] - dg + 8)])
                else:
                    ops += bytes([0xFE, *p[:3]])
            index[hsh] = p
            prev = p
    return head + bytes(ops) + (b"\0" * 7 + b"\1" if end else b"")


def qoi_fixtures():
    """QOI files: Pillow's RGB and RGBA, the format's encoder over every op,
    ops streams Pillow reads its own way (an index never set, a run first,
    a run past the end, no end marker), another channel count, cuts inside
    each op, a header cut short, and a width Pillow's GIMP brush reader
    takes first (refused)."""
    from PIL import Image

    tex = terrain(10, 14, 121, 4)
    tex[..., 3] = np.where(tex[..., 0] > 100, 255, 90)
    tex[3:5] = tex[2]  # runs
    tex[7, 3:9] = tex[7, 3]
    out = {"pillow_rgb.qoi": _pillow(Image.fromarray(tex[..., :3]), "QOI"),
           "pillow_rgba.qoi": _pillow(Image.fromarray(tex), "QOI")}
    out["ops_rgba.qoi"] = qoi_bytes(tex)
    smooth = np.cumsum(np.random.RandomState(122).randint(
        -3, 4, (10, 14, 4)), 1).astype(np.uint8) + 100
    smooth[..., 3] = 255
    out["ops_rgb_diff_luma.qoi"] = qoi_bytes(smooth, 3)
    out["channels_0.qoi"] = qoi_bytes(smooth, 0)
    out["no_end_marker.qoi"] = qoi_bytes(smooth, 3, end=False)
    small = np.zeros((3, 4, 4), np.uint8)
    out["index_never_set.qoi"] = qoi_bytes(small, 4, ops=bytes(
        [0x05, 0xC2, 0x3F, 0xFE, 9, 8, 7, 0x2B, 0xC3, 0x00, 0x40, 0xFF,
         1, 2, 3, 4, 0x1D, 0xC5]))
    out["run_past_the_end.qoi"] = qoi_bytes(small, 3, ops=bytes(
        [0xFE, 50, 60, 70, 0xFD]))
    full = out["ops_rgba.qoi"]
    k = 14
    cuts = {}
    while k < len(full) - 8:
        op = full[k]
        n = 5 if op == 0xFF else 4 if op == 0xFE else 2 if op >> 6 == 2 \
            else 1
        for kind, at in (("rgba", 0xFF), ("rgb", 0xFE)):
            if op == at and kind not in cuts:
                cuts[kind] = full[:k + 2]
        if op >> 6 == 2 and op not in (0xFE, 0xFF) and "luma" not in cuts:
            cuts["luma"] = full[:k + 1]
        k += n
    cuts["op"] = full[:len(full) - 8 - 1]
    for kind, data in sorted(cuts.items()):
        out[f"cut_in_{kind}.qoi"] = data
    out["header_cut.qoi"] = full[:11]
    out["zero_height.qoi"] = qoi_bytes(small[:0], 4, ops=b"")
    out["width2_refused.qoi"] = qoi_bytes(small[:, :2], 4)
    return out


# --------------------------------------------------------------------- IM
def im_bytes(kind, w, h, body, lut=None, frames=1, extra=b"", pad=True):
    """An IM file: Pillow's header lines for image type `kind`, its NUL
    padding to 511 bytes and 0x1a, a Lut (768 bytes) where given, body."""
    head = (f"Image type: {kind} image\r\nName: fixture\r\nImage size "
            f"(x*y): {w}*{h}\r\nFile size (no of images): {frames}\r\n"
            ).encode() + extra
    if lut is not None:
        head += b"Lut: 1\r\n"
    head = head.ljust(511, b"\0") if pad else head
    return head + b"\x1a" + (bytes(lut) if lut is not None else b"") + body


def im_fixtures():
    """IM files: Pillow's for every mode it writes, and the script's for
    the rest of Pillow's table (2- and 4-bit palettes, whole planes, 24-bit
    interleaved, float samples of 8, 16 and 32 bits, "L 32 S"), Lut rules
    (gray and linear, gray and not, colour on L, LA and B2), two frames,
    CRs and a NUL in the header, and what Pillow fails on (RLB, a palette
    without a colour Lut, a cut frame, a header with none of its keys) or
    the port refuses (a bit-packed float type)."""
    from PIL import Image

    rnd = np.random.RandomState(131)
    tex = terrain(7, 9, 132, 4)
    img = Image.fromarray(tex)
    out = {}
    for mode in ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK",
                 "YCbCr", "I", "I;16", "I;16L", "I;16B", "F"):
        if mode == "P":
            src = img.convert("RGB").quantize(30)
        elif mode == "PA":
            src = img.convert("RGB").quantize(30).convert("PA")
        elif mode.startswith("I;16"):
            src = Image.fromarray((tex[..., 0].astype(np.uint16) * 251)
                                  ).convert(mode)
        elif mode in ("I", "F"):
            src = Image.fromarray(tex[..., 0].astype(np.int32) * 99991 - 7
                                  ).convert(mode)
        else:
            src = img.convert(mode)
        out[f"pillow_{mode.replace(';', '_').lower()}.im"] = _pillow(src,
                                                                      "IM")
    flip = lambda a: np.ascontiguousarray(a[::-1])  # noqa: E731
    pal = rnd.randint(0, 256, 768).astype(np.uint8)
    grey = np.tile(rnd.randint(0, 256, 256).astype(np.uint8), 3)
    ramp = np.tile(np.arange(256, dtype=np.uint8), 3)
    idx2 = rnd.randint(0, 4, (7, 9)).astype(np.uint8)
    idx4 = rnd.randint(0, 16, (7, 9)).astype(np.uint8)
    pack = lambda v, b: _pack_bits(flip(v), b).tobytes()  # noqa: E731
    out["b2_colour_lut.im"] = im_bytes("B2", 9, 7, flip(idx2 * 60).tobytes(),
                                       pal)
    out["b4_colour_lut.im"] = im_bytes("B4", 9, 7, flip(idx4 * 15).tobytes(),
                                       pal)
    out["b2_without_lut.im"] = im_bytes("B2", 9, 7, pack(idx2, 2))
    out["b4_grey_lut.im"] = im_bytes("B4", 9, 7, pack(idx4, 4), grey)
    out["l_grey_lut.im"] = im_bytes("Greyscale", 9, 7,
                                    flip(tex[..., 0]).tobytes(), grey)
    out["l_ramp_lut.im"] = im_bytes("Greyscale", 9, 7,
                                    flip(tex[..., 0]).tobytes(), ramp)
    out["la_colour_lut.im"] = im_bytes(
        "LA", 9, 7, flip(tex[..., :2].transpose(0, 2, 1)).tobytes(), pal)
    out["rgb_lut.im"] = im_bytes(
        "RGB", 9, 7, flip(tex[..., :3].transpose(0, 2, 1)).tobytes(), pal)
    planes = flip(tex[..., :3]).transpose(2, 0, 1)
    out["rgb3_planes.im"] = im_bytes("RGB3", 9, 7, planes[[1, 0, 2]].tobytes())
    out["ryb3_planes.im"] = im_bytes("RYB3", 9, 7, planes[[1, 0, 2]].tobytes())
    out["x24_interleaved.im"] = im_bytes("X 24", 9, 7,
                                         flip(tex[..., :3]).tobytes())
    out["l1_bitmap.im"] = im_bytes("L 1", 9, 7, pack(tex[..., 0] > 120, 1))
    out["grayscale_spelling.im"] = im_bytes("Grayscale", 9, 7,
                                            flip(tex[..., 1]).tobytes())
    vals = rnd.randint(0, 1 << 16, (7, 9))
    for kind, dt in (("L 8", "u1"), ("L 8S", "i1"), ("L 16", "<u2"),
                     ("L 16S", "<i2"), ("L 32", "<u4"), ("L*8", "u1"),
                     ("L*16", "<u2"), ("L*32", "<u4"), ("L 32 S", "<u4"),
                     ("L 32S", "<i4")):
        name = kind.replace(" ", "_").replace("*", "star")
        out[f"{name.lower()}.im"] = im_bytes(kind, 9, 7, flip(
            (vals * 40503 + 12345) % (1 << 8 * np.dtype(dt).itemsize)
            ).astype(np.uint64).astype(dt).tobytes())
    f32 = (rnd.randn(7, 9) * 1000).astype("<f4")
    f32[0, 0], f32[1, 1] = np.inf, -0.0
    out["l_32f.im"] = im_bytes("L 32F", 9, 7, flip(f32).tobytes())
    out["l_32_f_space.im"] = im_bytes("L 32 F", 9, 7, flip(
        vals.astype("<u4") * 65537).tobytes())
    out["two_frames.im"] = im_bytes("Greyscale", 9, 7, flip(
        tex[..., 0]).tobytes() + flip(tex[..., 1]).tobytes(), frames=2)
    out["crlf_and_nul.im"] = b"\r\r" + im_bytes(
        "Greyscale", 9, 7, flip(tex[..., 2]).tobytes(), extra=b"Comment: a\n"
        b"Comment: b\r\n\0junk")
    out["no_padding.im"] = im_bytes("Greyscale", 9, 7, flip(
        tex[..., 2]).tobytes(), pad=False)
    out["rlb_unknown_raw_mode.im"] = im_bytes("RLB", 9, 7, bytes(3 * 63))
    out["pa_without_lut.im"] = im_bytes("PA", 9, 7, bytes(2 * 63))
    out["cut_frame.im"] = out["pillow_rgb.im"][:-20]
    out["cut_lut.im"] = out["b2_colour_lut.im"][:700]
    out["no_known_key.im"] = b"Foo: bar\r\n".ljust(511, b"\0") + b"\x1a" + \
        bytes(63)
    out["lstar12_refused.im"] = im_bytes("L*12", 9, 7, bytes(12 * 63))
    return out


# --------------------------------------------------------------------- ICO
def _dib(img_rows, bits, w, h, palette=b"", mask=None, header=40):
    """A DIB as an icon holds it: the info (or core) header with twice the
    height, a palette, the rows (bottom-up, padded to 32 bits), then the
    AND mask where given ((h, w) bool, set = transparent)."""
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    raw = np.asarray(img_rows, np.uint8).reshape(h, -1)
    rows[:, :raw.shape[1]] = raw
    if header == 12:
        head = struct.pack("<IHHHH", 12, w, 2 * h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0,
                           0, 0, 0)
    out = head + palette + rows[::-1].tobytes()
    if mask is not None:
        ms = ((w + 31) // 32) * 4
        m = np.zeros((h, ms * 8), np.uint8)
        m[:, :w] = mask
        out += np.packbits(m, axis=1)[::-1].tobytes()
    return out


def ico_bytes(entries):
    """An ICO of [(width byte, height byte, colour count, bpp, data)]."""
    head = struct.pack("<HHH", 0, 1, len(entries))
    at, dirs, blobs = 6 + 16 * len(entries), b"", b""
    for w, h, ncolor, bpp, data in entries:
        dirs += struct.pack("<BBBBHHII", w, h, ncolor, 0, 1, bpp, len(data),
                            at + len(blobs))
        blobs += data
    return head + dirs + blobs


def ico_fixtures():
    """ICO files: Pillow's (PNG entries of each mode, several sizes; DIB
    entries at 1, 8, 24 and 32 bits) and the script's: Pillow's choice of
    entry (by colour depth, then area: of a 256x256 icon with 8- and
    32-bit DIBs the 8-bit one; the colour count where the bit count is 0),
    a PNG whose size is not the directory's (by png_bytes), a core-header
    DIB, 4-bit and
    palette DIBs with masks, a 32-bit entry over a 24-bit DIB, cuts in the
    directory, PNG, pixels and mask, a 5x7 image Pillow writes without
    entries, what Pillow does not read and a top-down DIB (refused)."""
    from PIL import Image

    rnd = np.random.RandomState(141)
    tex = terrain(24, 24, 142, 4)
    tex[..., 3] = np.where(tex[..., 0] > 100, 255, 40)
    img = Image.fromarray(tex)
    out = {}
    for mode in ("RGBA", "RGB", "L", "LA", "P", "1"):
        src = img.convert(mode) if mode != "P" else img.convert(
            "RGB").quantize(20)
        out[f"pillow_png_{mode.lower()}.ico"] = _pillow(
            src, "ICO", sizes=[(24, 24), (16, 16)])
        if mode in ("RGBA", "RGB", "L", "P", "1"):
            out[f"pillow_bmp_{mode.lower()}.ico"] = _pillow(
                src, "ICO", sizes=[(24, 24), (16, 16)], bitmap_format="bmp")
    out["pillow_png_i16.ico"] = _pillow(Image.fromarray(
        tex[..., 0].astype(np.uint16) * 257), "ICO", sizes=[(24, 24)])
    out["pillow_nonsquare_no_entries.ico"] = _pillow(
        Image.fromarray(tex[:7, :5]), "ICO")
    big = terrain(256, 256, 143, 4)
    pal8 = bytes(rnd.randint(0, 256, 1024).astype(np.uint8))
    idx = (big[..., 0] // 4).astype(np.uint8)
    dib8 = _dib(idx, 8, 256, 256, pal8, mask=big[..., 1] < 80)
    dib32 = _dib(big[..., [2, 1, 0, 3]].reshape(256, -1), 32, 256, 256)
    out["depth_choice_256.ico"] = ico_bytes([(0, 0, 0, 32, dib32),
                                             (0, 0, 0, 8, dib8)])
    pal4 = bytes(rnd.randint(0, 256, 64).astype(np.uint8))
    v4 = rnd.randint(0, 16, (12, 10)).astype(np.uint8)
    dib4 = _dib(_pack_bits(v4, 4), 4, 10, 12, pal4,
                mask=rnd.rand(12, 10) < 0.3)
    out["colour_count_depth.ico"] = ico_bytes([
        (10, 12, 16, 0, dib4),
        (10, 12, 0, 24, _dib(tex[:12, :10, 2::-1].reshape(12, -1), 24, 10,
                             12, mask=np.zeros((12, 10))))])
    out["dib4_mask.ico"] = ico_bytes([(10, 12, 16, 4, dib4)])
    core = _dib(idx[:9, :11], 8, 11, 9, pal8[:768], mask=idx[:9, :11] > 40,
                header=12)
    out["dib8_core_header.ico"] = ico_bytes([(11, 9, 0, 8, core)])
    dib24 = _dib(tex[:, :, 2::-1].reshape(24, -1), 24, 24, 24,
                 mask=tex[..., 1] > 150)
    out["bpp32_over_dib24.ico"] = ico_bytes([(24, 24, 0, 32, dib24)])
    png40 = png_bytes(terrain(40, 40, 144, 3), 8, 2)
    out["png_size_differs.ico"] = ico_bytes([(32, 32, 0, 32, png40)])
    out["dir_cut.ico"] = out["pillow_png_rgba.ico"][:20]
    out["no_entries.ico"] = struct.pack("<HHH", 0, 1, 0)
    out["png_entry_cut.ico"] = ico_bytes([(24, 24, 0, 32, png_bytes(
        tex, 8, 6))])[:-40]
    out["png_chunk_header_cut.ico"] = ico_bytes([(40, 40, 0, 32,
                                                  png40[:35])])
    out["dib_mask_cut.ico"] = ico_bytes([(24, 24, 0, 24, dib24)])[:-80]
    out["dib_last_mask_row_short.ico"] = ico_bytes([(24, 24, 0, 24,
                                                     dib24)])[:-1]
    cut = bytearray(ico_bytes([(24, 24, 0, 24, dib24)])[:-1200])
    cut[14:18] = struct.pack("<I", 40 + 96)  # the mask over the header
    out["dib_pixels_cut.ico"] = bytes(cut)
    out["dib_header_64x.ico"] = ico_bytes([(4, 4, 0, 24, struct.pack(
        "<I", 20) + bytes(60))])
    td = bytearray(dib24)
    td[8:12] = struct.pack("<i", -48)
    out["dib_top_down_refused.ico"] = ico_bytes([(24, 24, 0, 24,
                                                  bytes(td))])
    return out


# ------------------------------------------------------------------- ICNS
def _icns_runs(plane):
    """One plane in the icns run coding: runs of 3-130 as (n + 125, v),
    literals of 1-128 as (n - 1, bytes)."""
    out, i, v = bytearray(), 0, bytes(plane)
    while i < len(v):
        j = i
        while j < len(v) and v[j] == v[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, v[i]])
            i = j
            continue
        j = i + 1
        while j < len(v) and j - i < 128 and not (
                j + 2 < len(v) and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + v[i:j]
        i = j
    return bytes(out)


def icns_bytes(blocks, size=None):
    """An icns file of [(type, data)] blocks."""
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body) if size is None
                                 else size) + body


def icns_fixtures():
    """ICNS files: Pillow's (PNG entries up to 1024x1024, from flat blocks;
    RGBA, RGB and gray) and the script's (PNG entries by png_bytes: Pillow's
    zlib output for one image differed between two test processes here):
    it32 + t8mk and ih32,
    il32, is32 with and without masks, in runs and raw (runs without a
    mask refused: imageio's array of them is not defined), a JPEG 2000 entry
    (gray and RGB), a size whose PNG is half the listed one, a block named
    twice, and what Pillow fails on (a mask alone, a bad it32 signature,
    uneven runs, an unknown subimage, a cut block, a PNG of another
    size)."""
    from PIL import Image

    small = terrain(12, 12, 151, 4)
    small[..., 3] = np.where(small[..., 0] > 100, 255, 0)
    # Pillow writes every entry up to 1024x1024 as PNG: 8x8 flat blocks of
    # 128 pixels keep them small (a smooth or noisy source takes MBs)
    img = Image.fromarray(np.kron(small[:8, :8], np.ones((128, 128, 1),
                                                          np.uint8)))
    out = {"pillow_rgba.icns": _pillow(img, "ICNS"),
           "pillow_rgb.icns": _pillow(img.convert("RGB"), "ICNS"),
           "pillow_gray.icns": _pillow(img.convert("L"), "ICNS")}
    planes = {}
    for side in (128, 48, 32, 16):
        t = np.asarray(Image.fromarray(small).resize((side, side),
                                                     Image.NEAREST))
        planes[side] = t
    t = planes[128]
    runs = b"".join(_icns_runs(t[..., c].tobytes()) for c in range(3))
    out["it32_t8mk.icns"] = icns_bytes([(b"it32", bytes(4) + runs),
                                        (b"t8mk", t[..., 3].tobytes())])
    out["ih32_runs_no_mask_refused.icns"] = icns_bytes([(b"ih32", b"".join(
        _icns_runs(planes[48][..., c].tobytes()) for c in range(3)))])
    out["ih32_raw_no_mask.icns"] = icns_bytes([
        (b"ih32", planes[48][..., :3].tobytes())])
    out["il32_raw_l8mk.icns"] = icns_bytes([
        (b"il32", planes[32][..., :3].tobytes()),
        (b"l8mk", planes[32][..., 3].tobytes())])
    out["is32_s8mk.icns"] = icns_bytes([
        (b"s8mk", planes[16][..., 3].tobytes()),
        (b"is32", b"".join(_icns_runs(planes[16][..., c].tobytes())
                           for c in range(3)))])
    j2 = _pillow(Image.fromarray(planes[128][..., :3]), "JPEG2000",
                 irreversible=False)
    out["ic07_jp2_rgb.icns"] = icns_bytes([(b"ic07", j2)])
    jg = _pillow(Image.fromarray(planes[32][..., 1]), "JPEG2000",
                 no_jp2=True)
    out["icp5_j2k_gray.icns"] = icns_bytes([(b"icp5", jg)])
    p64 = png_bytes(planes[32], 8, 6)
    out["ic09_half_size_png.icns"] = icns_bytes([(b"ic09", png_bytes(
        np.asarray(Image.fromarray(small).resize((256, 256))), 8, 6))])
    out["block_named_twice.icns"] = icns_bytes([(b"icp5", b"junk"),
                                                (b"icp5", p64)])
    out["mask_only.icns"] = icns_bytes([(b"h8mk", bytes(48 * 48))])
    out["it32_bad_signature.icns"] = icns_bytes([(b"it32", b"\1\0\0\0"
                                                  + runs)])
    out["runs_uneven.icns"] = icns_bytes([(b"is32", bytes([0x83, 9]) * 3
                                           + bytes([0xFF, 1]))])
    out["unknown_subimage.icns"] = icns_bytes([(b"ic08", b"GIF89a" +
                                                bytes(30))])
    out["block_cut.icns"] = out["il32_raw_l8mk.icns"][:30]
    out["png_odd_size.icns"] = icns_bytes([(b"ic07", png_bytes(
        np.asarray(Image.fromarray(small).resize((100, 100))), 8, 6))])
    return out


# -------------------------------------------------------------------- MPO
def mpo_fixtures():
    """MPO files by Pillow: two and three frames, a progressive first
    frame, and an EXIF Orientation of 6 (which imageio does not apply); the
    two-frame file cut in a marker's length (ValueError), in a segment's
    data and in the first frame's scan (OSError)."""
    from PIL import Image

    frames = [Image.fromarray(terrain(16, 24, 161 + k, 3)) for k in range(3)]
    exif = Image.Exif()
    exif[0x0112] = 6
    two = _pillow(frames[0], "MPO", save_all=True, append_images=frames[1:2])
    dqt, sos = two.index(b"\xff\xdb"), two.index(b"\xff\xda")
    return {
        "pillow_two_frames.mpo": two,
        "pillow_cut_in_marker_length.mpo": two[:dqt + 3],
        "pillow_cut_in_segment.mpo": two[:dqt + 10],
        "pillow_cut_in_scan.mpo": two[:sos + 60],
        "pillow_three_frames.mpo": _pillow(frames[0], "MPO", save_all=True,
                                           append_images=frames[1:]),
        "pillow_progressive.mpo": _pillow(frames[0], "MPO", save_all=True,
                                          append_images=frames[1:2],
                                          progressive=True),
        "pillow_orientation6.mpo": _pillow(frames[1], "MPO", save_all=True,
                                           append_images=frames[2:],
                                           exif=exif)}


# ---------------------------------------------------------------- digests
def _summary(a):
    a = np.asarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def digest(data, path=None, kind=None):
    """imageio's decode of the bytes through Pillow (its first choice; where
    Pillow cannot open a file, a big-endian BigTIFF, imageio falls back to
    OpenCV where that is installed, which the port does not follow):
    {bytes, shape, dtype, sha256}, or {bytes, error: "OSError"} where
    Pillow raises one -- for a WebP, PNM or TGA {bytes, error: "ValueError",
    imageio: the class it raised} where it raises anything, the port's
    decoders raising ValueError there; with `path`, under "path" its
    decode of the file by name (a *.tif through its tifffile plugin, a
    *.pbm through OpenCV; null where that fails)."""
    import warnings

    import imageio.v3 as iio

    if kind in CHOICE_KINDS + NATIVE_KINDS:
        native = kind in NATIVE_KINDS
        return {"bytes": len(data), **imageio_choice(data, native),
                "path": imageio_choice(path, native)}
    caught = Exception if kind in VALUE_ERROR_KINDS else OSError
    try:  # Pillow, imageio's first choice for bytes, and no fall-back
        out = {"bytes": len(data),
               **_summary(iio.imread(data, plugin="pillow"))}
    except caught as e:  # "image file is truncated", "cannot identify"
        out = {"bytes": len(data), "error": "OSError"}
        if kind in VALUE_ERROR_KINDS:
            out.update(error="ValueError", imageio=type(e).__name__)
    if path is not None:
        try:
            with warnings.catch_warnings():  # the plugin's deprecation
                warnings.simplefilter("ignore")
                # a JPEG 2000 path through Pillow, imageio's first choice
                # (where Pillow fails imageio tries OpenCV, which the port
                # does not follow)
                out["path"] = _summary(iio.imread(
                    path, **({"plugin": "pillow"} if kind == "jp2" else {})))
        except Exception:  # noqa: BLE001 -- no plugin reads it
            out["path"] = None
    return out


def error_name(e):
    """The nearest built-in class of an exception (struct.error named so)."""
    import builtins

    for c in type(e).__mro__:
        if c is struct.error:
            return "struct.error"
        if getattr(builtins, c.__name__, None) is c:
            return c.__name__
    return "Exception"


def imageio_choice(src, native=False):
    """imageio.v3.imread(src) (bytes or a path) by imageio's own choice of
    plugin: {reader: "pillow" or "opencv", shape, dtype, sha256}, or
    {error: "ValueError", imageio: the class it raised} (what the port
    raises wherever imageio fails; with `native`, error_name of what
    imageio raised)."""
    import warnings

    import imageio.v3 as iio

    names = {"PillowPlugin": "pillow", "OpenCVPlugin": "opencv"}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with iio.imopen(src, "r") as f:
                reader = names.get(type(f).__name__, type(f).__name__)
                a = np.asarray(f.read())
    except Exception as e:  # noqa: BLE001 -- imageio raises many kinds
        return {"error": error_name(e) if native else "ValueError",
                "imageio": type(e).__name__}
    return {"reader": reader, **_summary(a)}


def reference(kind):
    import imageio
    import PIL
    from PIL import features

    out = {"pillow": PIL.__version__, "imageio": imageio.__version__,
           "libtiff": features.version("libtiff")}
    if kind == "webp":
        out["libwebp"] = features.version("webp")
    if kind == "jp2":
        out["openjpeg"] = features.version("jpg_2000")
    if kind in ("jp2",) + CHOICE_KINDS:
        import cv2

        out["opencv"] = cv2.__version__
    return out


KINDS = {"png": png_fixtures, "tiff": tiff_fixtures, "bmp": bmp_fixtures,
         "webp": webp_fixtures, "pnm": pnm_fixtures, "tga": tga_fixtures,
         "jp2": jp2_fixtures, "pfm_pam": pfm_pam_fixtures,
         "hdr": hdr_fixtures, "sun": sun_fixtures, "dds": dds_fixtures,
         "sgi": sgi_fixtures, "pcx": pcx_fixtures, "qoi": qoi_fixtures,
         "im": im_fixtures, "ico": ico_fixtures, "icns": icns_fixtures,
         "mpo": mpo_fixtures}
# committed files no script here writes, kept with their entries
KEPT = {"png": ("terrain_48x40_rgb_5filters.png",)}


def main(out_dir=DEFAULT_DIR, kinds=tuple(KINDS)):
    """Write every kind's files and digests.json under out_dir/<kind>/;
    returns {kind: digests}."""
    got = {}
    for kind in kinds:
        d = os.path.join(out_dir, kind)
        os.makedirs(d, exist_ok=True)
        digests = {"reference": reference(kind)}
        for name in KEPT.get(kind, ()):
            src = os.path.join(DEFAULT_DIR, kind, name)
            with open(src, "rb") as f:
                data = f.read()
            if os.path.abspath(d) != os.path.dirname(os.path.abspath(src)):
                with open(os.path.join(d, name), "wb") as f:
                    f.write(data)
            digests[name] = digest(data)
        for name, data in KINDS[kind]().items():
            path = os.path.join(d, name)
            with open(path, "wb") as f:
                f.write(data)
            digests[name] = digest(
                data, path if kind == "tiff" or kind in VALUE_ERROR_KINDS
                + CHOICE_KINDS + NATIVE_KINDS else None, kind)
            if name in REFUSED:
                if kind in CHOICE_KINDS + NATIVE_KINDS:  # imageio's array,
                    # if any, unkept:
                    # a PAM with alpha comes back with unwritten bytes
                    digests[name] = {"bytes": len(data)}
                digests[name]["refused"] = REFUSED[name]
            if name in PATH_REFUSED:
                digests[name]["path_refused"] = PATH_REFUSED[name]
        with open(os.path.join(d, "digests.json"), "w") as f:
            json.dump(digests, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"{kind}: {len(digests) - 1} files, "
              f"{sum(v['bytes'] for k, v in digests.items() if k != 'reference')} "
              f"bytes")
        got[kind] = digests
    return got


if __name__ == "__main__":
    main(*sys.argv[1:])

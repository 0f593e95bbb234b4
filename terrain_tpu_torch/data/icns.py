"""Apple icon (ICNS) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes an ICNS
(*.icns; magic "icns") through Pillow (IcnsImagePlugin.py).  The port
depends on no image library: `decode_icns` walks the blocks here and gives
`imageio.v3.imread`'s array (Pillow 12.1.0, imageio 2.37.4) of the largest
(width, height, scale) that any known block names (Pillow's bestsize: a
512@2 entry gives 1024 x 1024):
  * a PNG entry (ic07-ic14, icp4-icp6) through serve/png.py;
  * a JPEG 2000 entry through data/jp2.py, converted to RGBA (gray and
    gray + alpha spread over red, green and blue; alpha 255 where it has
    none);
  * it32, ih32, il32 and is32: RGB, stored as three planes, each as it is
    (exactly 3 x pixels bytes) or in Pillow's runs (a byte b < 128: b + 1
    literal bytes; b >= 128: the next byte b - 125 times; a plane may read
    on past its block), it32 after 4 zero bytes; alpha (RGBA) from t8mk,
    h8mk, l8mk or s8mk where the size has one, else RGB.
imageio reads the result as Pillow hands it over: RGBA as it is, RGB as
its 4-byte pixels in Pillow's memory (the fourth byte 255) cut into
3-byte ones (Pillow packs the pixels for the RGBA its header promised
before it loads the entry, and numpy shapes them by the mode it loaded),
any other PNG mode not at all (ValueError).  An RGB entry in runs with no
mask is refused by name: Pillow fills an image it never initialised, and
imageio reads its fourth bytes too.  Where a block is named twice, the last one counts.  What imageio fails on
raises what it raises there: SyntaxError where Pillow does not identify
the file (a block header cut short or of size 0, no known entry) or a
plane of runs does not come out even, ValueError for an entry that is
neither PNG nor JPEG 2000, a cut plane or mask, or a PNG or JPEG 2000
entry whose size no listed size is a multiple of, KeyError for a size with
only a mask, the errors of the PNG or JPEG 2000 decoders for those.
A 16-bit JPEG 2000 entry, or a damaged one (whose error the port's decoder
does not tell apart as Pillow's does), is refused by name.
"""

import struct

import numpy as np

from terrain_tpu_torch.data import jp2, pillow_open
from terrain_tpu_torch.serve.png import check_open as check_png_open
from terrain_tpu_torch.serve.png import read_header as png_header
from terrain_tpu_torch.serve.png import read_png

MAGIC = b"icns"
EXTENSIONS = (".icns",)
_PNG = b"\x89PNG\r\n\x1a\n"
# (width, height, scale) -> its blocks, in Pillow's order
_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"), (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_RGB = (b"it32", b"ih32", b"il32", b"is32")
_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def blocks(buf):
    """{type: (start, length)} of the blocks after the 8-byte header, as
    Pillow's IcnsFile reads them."""
    buf = bytes(buf)
    if len(buf) < 8 or buf[:4] != MAGIC:
        raise SyntaxError("ICNS: not an icns file, or its header is cut "
                          "short")
    (filesize,) = struct.unpack(">I", buf[4:8])
    out, i, pos = {}, 8, 8
    while i < filesize:
        if len(buf) < pos + 8:
            raise SyntaxError("ICNS: a block header is cut short")
        sig, size = struct.unpack(">4sI", buf[pos:pos + 8])
        if size <= 0:
            raise SyntaxError("ICNS: invalid block header")
        i += 8
        pos += 8
        size -= 8
        out[sig] = (i, size)
        pos = max(0, pos + size)
        i += size
    return out


def best_size(found):
    """Pillow's bestsize: the largest (width, height, scale) with a block."""
    sizes = [s for s, codes in _SIZES.items() if any(c in found
                                                    for c in codes)]
    if not sizes:
        raise SyntaxError("ICNS: No 32bit icon resources found")
    return max(sizes)


def _check_size(found, w, h):
    """Pillow's size setter, given an entry's own size: some listed size
    must be an integer multiple of it."""
    for size, codes in _SIZES.items():
        if any(c in found for c in codes):
            sw, sh = size[0] * size[2], size[1] * size[2]
            if sh / h == sw // w:
                return
    raise ValueError(f"ICNS: an entry of {w}x{h} (This is not one of the "
                     f"allowed sizes of this image)")


def _plane_runs(buf, p, n):
    """One plane of Pillow's runs from buf[p:]: (bytes, next position)."""
    out, left = [], n
    while left > 0:
        if p >= len(buf):
            break
        b = buf[p]
        p += 1
        if b & 0x80:
            k = b - 125
            out.append(buf[p:p + 1] * k)
            p += 1
        else:
            k = b + 1
            out.append(buf[p:p + k])
            p += k
        left -= k
    if left != 0:
        raise SyntaxError(f"ICNS: Error reading channel [{left} left]")
    data = b"".join(out)
    if len(data) < n:
        raise ValueError("ICNS: a plane is cut short (buffer is not large "
                         "enough)")
    return np.frombuffer(data, np.uint8, n), p


def _rgb(buf, start, length, side):
    """An RGB entry, raw (exactly 3 x pixels bytes) or in runs."""
    n = side * side
    if length == 3 * n:
        px = np.frombuffer(buf[start:start + length], np.uint8)
        if px.size < 3 * n:
            raise ValueError("ICNS: the pixels are cut short (buffer is not "
                             "large enough)")
        return px.reshape(side, side, 3)
    planes, p = [], start
    for _ in range(3):
        plane, p = _plane_runs(buf, p, n)
        planes.append(plane)
    return np.stack(planes, -1).reshape(side, side, 3)


def _refuse_unmasked_runs(found, size):
    """An RGB entry in runs with no mask: Pillow fills the bands of an
    image it never initialised, and imageio reads its fourth bytes too
    (_as_read), so the array depends on Pillow's memory."""
    codes = _SIZES[size]
    rgb = [c for c in codes if c in _RGB and c in found]
    if rgb and not any(c in _MASKS and c in found for c in codes) and \
            found[rgb[0]][1] - 4 * (rgb[0] == b"it32") != 3 * (
                size[0] * size[2]) ** 2:
        raise NotImplementedError(
            f"ICNS: an {rgb[0].decode()} entry in runs with no mask; imageio "
            f"reads the uninitialised fourth bytes of Pillow's RGB image "
            f"there, so its array is not defined")


def _rgba(px):
    """Pillow's convert("RGBA") of a JPEG 2000 entry's array."""
    if px.dtype != np.uint8:
        raise NotImplementedError(
            f"ICNS: a {px.dtype} JPEG 2000 entry; the port reads 8-bit ones")
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[-1] in (1, 2):
        px = np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]], -1)
    if px.shape[-1] == 3:
        px = np.concatenate(
            [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], -1)
    return np.ascontiguousarray(px)


def check_header(buf):
    """Raise as `decode_icns` does for the blocks, and for a JPEG 2000
    entry's boxes and main header, before any pixel is decoded."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    found = blocks(buf)
    _refuse_unmasked_runs(found, best_size(found))
    for code in _SIZES[best_size(found)]:
        start, length = found.get(code, (0, 0))
        sig = buf[start:start + 12]
        if code in found and code not in _RGB + _MASKS and \
                not sig.startswith(_PNG):
            jp2.read_header(buf[start:start + length])


def _as_read(px, mode):
    """numpy's view of the image as imageio takes it: Pillow packs the
    pixels as RGBA, the mode the header promised, before it loads them,
    and shapes them by the mode it loaded.  So RGBA is read as it is, RGB
    as its 4-byte pixels in Pillow's memory (the fourth byte 255) cut into
    3-byte ones, and no other mode can be packed (ValueError)."""
    if mode == "RGBA":
        return px
    if mode != "RGB":
        raise ValueError(f"ICNS: a PNG entry of {mode} (No packer found "
                         f"from it to RGBA)")
    h, w = px.shape[:2]
    flat = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(flat.reshape(-1)[:h * w * 3].reshape(h, w,
                                                                     3))


def decode_icns(buf):
    """ICNS bytes -> the array imageio.v3.imread returns (through Pillow)."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    found = blocks(buf)
    size = best_size(found)
    side = size[0] * size[2]
    got = {}
    for code in _SIZES[size]:
        if code not in found:
            continue
        start, length = found[code]
        if code in _RGB:
            if code == b"it32":
                if buf[start:start + 4] != bytes(4):
                    raise SyntaxError("ICNS: Unknown signature, expecting "
                                      "0x00000000")
                start, length = start + 4, length - 4
            got["RGB"] = _rgb(buf, start, length, side)
        elif code in _MASKS:
            a = np.frombuffer(buf[start:start + side * side], np.uint8)
            if a.size < side * side:
                raise ValueError("ICNS: the mask is cut short (buffer is not "
                                 "large enough)")
            got["A"] = a.reshape(side, side)
        else:
            sig = buf[start:start + 12]
            if sig.startswith(_PNG):
                got["RGBA"] = ("png", start)
            elif sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
                    or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
                got["RGBA"] = ("jp2", start, length)
            else:
                raise ValueError("ICNS: Unsupported icon subimage format")
    if "RGBA" in got:
        kind, start = got["RGBA"][:2]
        if kind == "png":
            check_png_open(buf[start:])
            px = read_png(buf[start:])
            _, _, depth, ctype, _ = png_header(buf[start:start + 29])
            mode = "RGBA" if ctype == 6 or (ctype == 4 and depth == 16) \
                else "RGB" if ctype == 2 else f"colour type {ctype}"
        else:
            try:
                px = jp2.decode_jp2(buf[start:start + got["RGBA"][2]])
            except ValueError as e:
                raise NotImplementedError(
                    f"ICNS: a JPEG 2000 entry the port's decoder rejects "
                    f"({e}); which error Pillow raises for it (SyntaxError "
                    f"in its header, OSError in its data) the port does not "
                    f"reproduce") from e
            px, mode = _rgba(px), "RGBA"
        _check_size(found, px.shape[1], px.shape[0])
        return _as_read(px, mode)
    if "RGB" not in got:
        raise KeyError("ICNS: a size with a mask and no RGB entry")
    _refuse_unmasked_runs(found, size)  # once the runs have decoded
    px = got["RGB"]
    if "A" in got:
        return np.ascontiguousarray(np.concatenate([px, got["A"][..., None]],
                                                   -1))
    return _as_read(px, "RGB")

"""IFUNC Image Memory (IM) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes an IM file
(*.im) through Pillow (ImImagePlugin.py).  The port depends on no image
library: `decode_im` reads the text header here, as Pillow reads it, and
the first frame's raw rows with numpy, giving `imageio.v3.imread`'s array
(Pillow 12.1.0, imageio 2.37.4).  The header: its first 100 bytes hold a
line feed; "Key: value" lines of at most 100 bytes, a carriage return at
a line's start skipped, up to a NUL or a 0x1a byte, then everything up to
the next 0x1a skipped; a header needs one of Pillow's nine keys; "Image
size (x*y)" (default 512*512) and "Image type" (default "L"), whose value
names the layout (Pillow's OPEN table):
  1, L          "0 1", "L 1", "B1" (bool (H, W)); "Greyscale" (uint8)
  P             "B2", "B4": 2- and 4-bit indices
  RGB           "RGB" (planes line by line), "RLB" and "RYB", "X 24"
                (interleaved), "RGB3" and "RYB3" (whole planes, green
                first), "RGBX" (line by line, X dropped)
  LA, RGBA, CMYK, YCbCr   "LA", "PA", "RGBA", "CMYK", "YCC": planes line
                by line; YCbCr and CMYK samples as stored
  I;16, I;16L, I;16B  "L 16", "L 16L", "L 16B" (and "L*16..."): uint16,
                big-endian for I;16B (dtype >u2)
  I             "L 32S" (int32)
  F             "L 8", "L 8S", "L 16", "L 16S", "L 32", "L 32F" (and their
                "L*" forms): float32 from uint8, int8, uint16, int16,
                uint32, float32 samples
A "Lut" key reads a 768-byte table after the header (planar R, G, B): on
an L or P image that is not gray it makes P (8-bit indices, even for "B2"
and "B4") with that palette, which imageio applies (RGB); on LA or PA it
makes PA, which imageio leaves as (H, W, 2).  Rows are bottom-up; a file
of several frames gives its first.  The "L*n" types of another n (Pillow's
bit decoder) and types outside the table are refused by name.  What
imageio fails on raises what it raises there: OSError where Pillow does
not identify bytes (imageio has no other reader for them; a file at a
path it then offers to every plugin, SPE's among them, so the port
refuses that by name), OSError for a truncated frame, ValueError for a
size field that is not a number or a raw mode Pillow lacks (RLB, PA;L on
LA), AttributeError for a palette image without a colour Lut (imageio
finds no palette to apply).
"""

import re

import numpy as np

from terrain_tpu_torch.data import pillow_open
from terrain_tpu_torch.serve.png import pillow_bool

EXTENSIONS = (".im",)
# the keys Pillow counts: a header needs one of them
_TAGS = ("Comment", "Date", "Digitalization equipment",
         "File size (no of images)", "Lut", "Name", "Scale (x,y)",
         "Image size (x*y)", "Image type")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# image type -> (Pillow's mode, its raw mode)
_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = (f"I;{_i}",
                                                         f"I;{_i}")
_OPEN["L 32S image"] = _OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):  # over "L*8", "L*16" and "L*32" too, as in Pillow
    _OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# raw mode -> sample dtype of F and I modes
_SAMPLES = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2",
            "F;32": "<u4", "F;32F": "<f4", "I;32": "<u4", "I;32S": "<i4"}
_BANDS = {"1": 1, "L": 1, "P": 1, "RGB": 3, "LA": 2, "PA": 2, "RGBA": 4,
          "CMYK": 4, "YCbCr": 3, "I;16": 1, "I;16L": 1, "I;16B": 1,
          "I": 1, "F": 1}


class Unidentified(OSError):
    """Pillow does not identify the file as IM."""


def _unidentified(what):
    raise Unidentified(f"IM: Pillow does not identify the file ({what})")


def _header(buf, from_path):
    try:
        return Header(buf)
    except Unidentified as e:
        if not from_path:
            raise
        raise NotImplementedError(
            f"{e}; at a path imageio then tries its other plugins, SPE's "
            f"among them, whose reading the port does not reproduce") from e


def _number(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


class Header:
    """What Pillow's ImImageFile._open reads: `mode`, `rawmode`, `size`
    (width, height), `palette` ((256, 3) or None) and `offset`, the first
    frame's first byte."""

    def __init__(self, buf):
        if b"\n" not in buf[:100]:
            _unidentified("no line feed in the first 100 bytes")
        info = {"Image type": "L", "Image size (x*y)": (512, 512)}
        self.rawmode = "L"
        n, p, s = 0, 0, b""
        while True:
            s = buf[p:p + 1]
            p += 1
            if s == b"\r":
                continue
            if not s or s in (b"\0", b"\x1a"):
                break
            end = buf.find(b"\n", p)
            end = len(buf) if end < 0 else end + 1
            s += buf[p:end]
            p = end
            if len(s) > 100:
                _unidentified("a header line longer than 100 bytes")
            s = s[:-2] if s.endswith(b"\r\n") else (
                s[:-1] if s.endswith(b"\n") else s)
            m = _SPLIT.match(s)
            if not m:
                _unidentified(f"the header line {s[:40]!r}")
            k, v = (x.decode("latin-1", "replace") for x in m.group(1, 2))
            if k in ("File size (no of images)", "Scale (x,y)",
                     "Image size (x*y)"):
                v = tuple(map(_number, v.replace("*", ",").split(",")))
                v = v[0] if len(v) == 1 else v
            elif k == "Image type" and v in _OPEN:
                v, self.rawmode = _OPEN[v]
            info[k] = v
            n += k in _TAGS
        if not n:
            _unidentified("none of its keys")
        size, mode = info["Image size (x*y)"], info["Image type"]
        if not isinstance(size, tuple):  # Pillow's size check: TypeError
            _unidentified(f"an image size of {size!r}")
        if not (len(size) == 2
                and all(isinstance(x, int) for x in size)):
            raise NotImplementedError(
                f"IM: an image size of {size!r}; the port reads two whole "
                f"numbers there")
        if mode not in _BANDS:
            raise NotImplementedError(f"IM: the image type {mode!r}; the "
                                      f"port reads the types of Pillow's "
                                      f"table")
        if size[0] <= 0 or size[1] <= 0:
            _unidentified(f"a {size[0]}x{size[1]} image")
        while s and s != b"\x1a":
            s = buf[p:p + 1]
            p += 1
        if not s:
            _unidentified("no 0x1a byte ends the header")
        self.palette = None
        if "Lut" in info:
            lut = np.frombuffer(buf, np.uint8, min(768, len(buf) - p), p)
            if lut.size < 768:
                _unidentified("its Lut is cut short")
            p += 768
            pal = lut.reshape(3, 256)
            grey = (pal[0] == pal[1]).all() and (pal[1] == pal[2]).all()
            if not grey and mode in ("L", "P"):
                mode = self.rawmode = "P"
                self.palette = np.ascontiguousarray(pal.T)
            elif not grey and mode in ("LA", "PA"):
                mode, self.rawmode = "PA", "PA;L"
        if self.rawmode.startswith("F;") and self.rawmode not in _SAMPLES:
            raise NotImplementedError(
                f"IM: the {self.rawmode[2:]}-bit samples of the image type "
                f"{info.get('Image type')!r}; the port reads 8, 16 and 32")
        self.mode, self.size, self.offset = mode, size, p


def sniff(head):
    """Whether the first bytes of a file open as Pillow's IM header does: a
    line feed in the first 100 bytes and a first line "Key: value" with
    one of its keys (IM has no magic)."""
    if b"\n" not in head[:100]:
        return False
    line = head.lstrip(b"\r").split(b"\n", 1)[0].rstrip(b"\r")
    m = _SPLIT.match(line)
    return bool(m) and m.group(1).decode("latin-1") in _TAGS


def read_header(buf, from_path=False):
    """(height, width, Pillow's mode) of IM bytes; raises as `decode_im`
    does for a header it does not take."""
    hd = _header(bytes(buf), from_path)
    return hd.size[1], hd.size[0], hd.mode


def _lines(px, h, w, k):
    """Line-interleaved rows: (h, k * w) -> (h, w, k)."""
    return px.reshape(h, k, w).transpose(0, 2, 1)


def decode_im(buf, from_path=False):
    """IM bytes -> the array imageio.v3.imread returns (through Pillow): the
    first frame; `from_path`: read from a file, where a file Pillow does
    not identify is refused by name."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    hd = _header(buf, from_path)
    (w, h), raw = hd.size, hd.rawmode
    if raw == "RLB" or (raw == "PA;L" and hd.mode == "LA"):
        raise ValueError(f"IM: Pillow has no raw mode {raw} for {hd.mode} "
                         f"images (unknown raw mode for given image mode)")
    if hd.mode == "P" and hd.palette is None:
        raise AttributeError("IM: a palette image without a colour Lut "
                             "(imageio finds no palette to apply)")
    bits = {"1": 1, "P;2": 2, "P;4": 4}.get(raw, 8 * np.dtype(
        _SAMPLES.get(raw, "u1")).itemsize * (
            1 if raw in _SAMPLES or raw.startswith("I;16") else
            _BANDS[hd.mode] + (raw == "RGBX;L")))
    if raw.startswith("I;16"):
        bits = 16
    stride = (w * bits + 7) // 8
    total = stride * h
    if len(buf) - hd.offset < total:
        raise OSError("IM: image file is truncated")
    rows = np.frombuffer(buf, np.uint8, total, hd.offset).reshape(h, stride)
    rows = rows[::-1]  # bottom-up
    if raw in ("1", "P;2", "P;4"):
        px = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        px = (px << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[:, :w]
        if raw == "1":
            return pillow_bool(px)
    elif raw in _SAMPLES:
        v = rows.copy().view(_SAMPLES[raw])
        return np.ascontiguousarray(v.astype(
            np.float32 if hd.mode == "F" else np.int32))
    elif raw.startswith("I;16"):
        return np.ascontiguousarray(rows).view(
            ">u2" if raw == "I;16B" else "<u2").astype(
            ">u2" if raw == "I;16B" else np.uint16)
    elif raw in ("L", "P"):
        px = rows
    elif raw == "RGB":
        px = rows.reshape(h, w, 3)
    elif raw in ("RGB;T", "RYB;T"):
        planes = np.frombuffer(buf, np.uint8, 3 * w * h, hd.offset) \
            if len(buf) - hd.offset >= 3 * w * h else None
        if planes is None:
            raise OSError("IM: image file is truncated")
        g, r, b = planes.reshape(3, h, w)[:, ::-1]
        return np.ascontiguousarray(np.stack([r, g, b], -1))
    else:  # line-interleaved planes
        k = _BANDS[hd.mode] + (raw == "RGBX;L")
        px = _lines(rows, h, w, k)[..., :_BANDS[hd.mode]]
    if hd.mode == "P":
        return hd.palette[px]
    px = np.ascontiguousarray(px)
    return px

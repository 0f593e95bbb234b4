"""PNM (PBM, PGM, PPM) decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes PNM bytes,
and a *.pgm, *.ppm or *.pnm path, through Pillow (PpmImagePlugin.py), but
a *.pbm path through OpenCV.  The port depends on no image library:
`decode_pnm` reads the header as Pillow tokenizes it (comments anywhere,
even inside a token) and the samples with numpy, and gives
`imageio.v3.imread`'s array (Pillow 12.1.0, imageio 2.37.4):
  * P1 and P4 (bitmaps): bool (H, W), True where the bit is 0 (white),
    stored as Pillow stores it (the byte 255);
  * P2 and P5 (gray): uint8 (H, W) for a maxval up to 255, int32 above it
    (Pillow's mode I: 65535 kept as stored, any other maxval scaled to
    0-65535), each sample round(v / maxval * out_max), half to even,
    clamped in binary files (a value past maxval in a plain file raises);
  * P3 and P6 (RGB), P0CMYK, PyRGBA and PyCMYK (four channels as stored):
    uint8, scaled to 0-255 from any maxval (two bytes a sample above 255);
  * Pf (gray float): float32 (H, W), little-endian for a negative scale,
    rows bottom-up as the format stores them.
`read_pnm(path)` reads a *.pbm path as imageio's OpenCV plugin does: a
bitmap as uint8 (H, W, 3), 0 where the bit is 1, else 255 (its header
tokenized as Pillow does: a damaged one that OpenCV reads leniently
raises ValueError here).  Refused by
name (NotImplementedError): PF (colour PFM) and P7 (PAM), which imageio
reads only through OpenCV, a *.pbm path holding anything but a bitmap,
and PyP, which imageio fails on; a damaged or truncated file raises
ValueError.
"""

import os

import numpy as np

from terrain_tpu_torch.serve.png import pillow_bool

_WS = b" \t\n\x0b\x0c\r"
_BLOCK = 1 << 20  # Pillow's ImageFile.SAFEBLOCK, the plain decoder's reads
# magic -> (Pillow's mode, its channels)
_MODES = {b"P1": ("1", 1), b"P2": ("L", 1), b"P3": ("RGB", 3),
          b"P4": ("1", 1), b"P5": ("L", 1), b"P6": ("RGB", 3),
          b"P0CMYK": ("CMYK", 4), b"Pf": ("F", 1), b"PyRGBA": ("RGBA", 4),
          b"PyCMYK": ("CMYK", 4)}
_REFUSED = {
    b"PF": "PF (colour PFM), which imageio reads only through OpenCV",
    b"P7": "P7 (PAM), which imageio reads only through OpenCV",
    b"PyP": "PyP (Pillow's palette test kind), which imageio fails on",
}
MAGICS = tuple(_MODES) + tuple(_REFUSED)


def _refuse(what):
    raise NotImplementedError(f"PNM: {what}; the port decodes P1-P6, Pf, "
                              f"P0CMYK, PyRGBA and PyCMYK")


class _Reader:
    """Pillow's header reader over the file's bytes."""

    def __init__(self, buf):
        self.buf, self.pos = buf, 0

    def char(self):
        c = self.buf[self.pos:self.pos + 1]
        self.pos += 1
        return c

    def magic(self):
        m = b""
        for _ in range(6):
            c = self.char()
            if not c or c in _WS:
                break
            m += c
        return m

    def token(self):
        tok = b""
        while len(tok) <= 10:
            c = self.char()
            if not c:
                break
            if c in _WS:
                if not tok:
                    continue
                break
            if c == b"#":  # to the line's end, then the token goes on
                while self.char() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("PNM: the header ends early")
        if len(tok) > 10:
            raise ValueError(f"PNM: a header token too long ({tok[:11]!r})")
        return tok


def _int(tok):
    try:
        return int(tok)
    except ValueError:
        raise ValueError(f"PNM: {tok!r} is not a number") from None


def _plain_blocks(buf, pos):
    """The plain decoder's reads: blocks of the data with comments taken
    out, a comment cut at a block's end carried on into the next."""
    spans = False
    while pos < len(buf):
        block = buf[pos:pos + _BLOCK]
        pos += _BLOCK
        if spans:
            end = _comment_end(block)
            while end < 0 and pos < len(buf):
                block = buf[pos:pos + _BLOCK]
                pos += _BLOCK
                end = _comment_end(block)
            block = block[end + 1:] if end >= 0 else b""
        spans = False
        while True:
            start = block.find(b"#")
            if start < 0:
                break
            end = _comment_end(block, start)
            if end < 0:
                block, spans = block[:start], True
                break
            block = block[:start] + block[end + 1:]
        yield block


def _comment_end(block, start=0):
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_bits(buf, pos, total):
    data = b""
    for block in _plain_blocks(buf, pos):
        tokens = b"".join(block.split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"PNM: {bad[:1]!r} in a plain bitmap")
        data = (data + tokens)[:total]
        if len(data) == total:
            break
    if len(data) < total:
        raise ValueError("PNM: the plain bitmap is cut short")
    return pillow_bool(np.frombuffer(data, np.uint8) == ord("0"))


def _plain_samples(buf, pos, total, maxval, out_max):
    vals, half = [], b""
    blocks = _plain_blocks(buf, pos)
    while len(vals) < total:
        block = next(blocks, None)
        if block is None:  # the end of the file
            if not half:
                break
            block = b" "
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError("PNM: a sample token too long")
        for tok in tokens:
            if len(tok) > 10:
                raise ValueError("PNM: a sample token too long")
            v = _int(tok)
            if v < 0 or v > maxval:
                raise ValueError(f"PNM: a sample of {v} for maxval {maxval}")
            vals.append(round(v / maxval * out_max))
            if len(vals) == total:
                break
    if len(vals) < total:
        raise ValueError("PNM: the plain samples are cut short")
    return np.array(vals, np.int64)


def _header(buf):
    r = _Reader(buf)
    magic = r.magic()
    if magic in _REFUSED:
        _refuse(_REFUSED[magic])
    if magic not in _MODES:
        raise ValueError(f"PNM: not a PNM file (magic {magic[:6]!r})")
    mode, bands = _MODES[magic]
    width, height = _int(r.token()), _int(r.token())
    if width <= 0 or height <= 0:
        raise ValueError(f"PNM: a {width}x{height} image")
    if mode == "1":
        arg = None
    elif mode == "F":
        try:
            arg = float(r.token())
        except ValueError:
            raise ValueError("PNM: the Pf scale is not a number") from None
        if arg == 0.0 or not np.isfinite(arg):
            raise ValueError("PNM: the Pf scale must be finite and non-zero")
    else:
        arg = _int(r.token())
        if not 0 < arg < 65536:
            raise ValueError(f"PNM: maxval {arg}")
    return magic, mode, bands, width, height, arg, r.pos


def decode_pnm(buf):
    """PNM bytes -> the array imageio.v3.imread returns (through Pillow)."""
    buf = bytes(buf)
    magic, mode, bands, w, h, arg, pos = _header(buf)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            return _plain_bits(buf, pos, w * h).reshape(h, w)
        stride = (w + 7) // 8
        raw = np.frombuffer(buf, np.uint8, min(stride * h, len(buf) - pos),
                            pos)
        if raw.size < stride * h:
            raise ValueError("PNM: the bitmap is cut short")
        return pillow_bool(
            np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w] == 0)
    if mode == "F":
        n = 4 * w * h
        if len(buf) - pos < n:
            raise ValueError("PNM: the Pf samples are cut short")
        px = np.frombuffer(buf, "<f4" if arg < 0 else ">f4", w * h, pos)
        return px.astype(np.float32).reshape(h, w)[::-1].copy()
    maxval = arg
    wide = mode == "L" and maxval > 255  # Pillow's mode I: int32
    out_max = 65535 if wide else 255
    total = w * h * bands
    if plain:
        v = _plain_samples(buf, pos, total, maxval, out_max)
    else:
        two = maxval > 255
        n = total * (2 if two else 1)
        if len(buf) - pos < n:
            raise ValueError("PNM: the samples are cut short")
        v = np.frombuffer(buf, ">u2" if two else np.uint8, total, pos)
        if maxval != (65535 if wide else 255):
            v = np.minimum(out_max, np.round(v / maxval * out_max))
    v = np.asarray(v).astype(np.int32 if wide else np.uint8)
    return v.reshape(h, w) if bands == 1 else v.reshape(h, w, bands)


def check_kind(path, head):
    """Raise NotImplementedError where the magic in `head` (the file's
    first bytes) names a kind the port refuses, for a file at `path`."""
    magic = _Reader(bytes(head)).magic()
    if magic in _REFUSED:
        _refuse(_REFUSED[magic])
    if (os.path.splitext(path)[1].lower() == ".pbm"
            and magic not in (b"P1", b"P4")):
        _refuse(f"a *.pbm path holding {magic.decode(errors='replace')} "
                f"(imageio reads a *.pbm path through OpenCV)")


def read_pnm(path):
    """A PNM file decoded as imageio.v3.imread(path) gives it: a *.pbm path
    through OpenCV's reading of a bitmap, any other through Pillow."""
    with open(path, "rb") as f:
        buf = f.read()
    check_kind(path, buf[:8])
    if os.path.splitext(path)[1].lower() != ".pbm":
        return decode_pnm(buf)
    white = np.where(decode_pnm(buf), np.uint8(255), np.uint8(0))
    return np.repeat(white[..., None], 3, axis=2)

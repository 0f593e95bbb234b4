"""PNM (PBM, PGM, PPM), PFM and PAM decoding for the trainer's raster pairs
(TERRAIN_RASTER) and the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes PNM bytes,
and a *.pgm, *.ppm, *.pnm or *.pam path, through Pillow
(PpmImagePlugin.py), and takes OpenCV where Pillow cannot open the file
(PF, P7), and always for a *.pbm or *.pfm path.  The port depends on no
image library: `decode_pnm` reads the header as Pillow tokenizes it
(comments anywhere, even inside a token) and the samples with numpy, and
gives `imageio.v3.imread`'s array (Pillow 12.1.0, OpenCV 5.0.0, imageio
2.37.4):
  * P1 and P4 (bitmaps): bool (H, W), True where the bit is 0 (white),
    stored as Pillow stores it (the byte 255);
  * P2 and P5 (gray): uint8 (H, W) for a maxval up to 255, int32 above it
    (Pillow's mode I: 65535 kept as stored, any other maxval scaled to
    0-65535), each sample round(v / maxval * out_max), half to even,
    clamped in binary files (a value past maxval in a plain file raises);
  * P3 and P6 (RGB), P0CMYK, PyRGBA and PyCMYK (four channels as stored):
    uint8, scaled to 0-255 from any maxval (two bytes a sample above 255);
  * Pf (gray float): float32 (H, W), little-endian for a negative scale,
    rows bottom-up as the format stores them;
  * PF (colour float), through OpenCV's PFM reader (data/cvread.py):
    uint8 (H, W, 3), each sample times 1/|scale| in float32, rounded half
    to even and saturated, the channels as stored;
  * P7 (PAM), through OpenCV's PAM reader: uint8 (H, W, 3) for tuple types
    BLACKANDWHITE, GRAYSCALE (the gray value three times) and RGB (its
    channels reversed, as OpenCV copies RGB rows into a BGR image), maxval
    unscaled, 16-bit samples shifted right by 8, and at maxval 1 each row's
    first bytes read as packed bits (0 or 255); its header as OpenCV
    parses it (case-sensitive names, strict decimal numbers, the last
    TUPLTYPE kept).
`read_pnm(path)` reads a *.pbm path as imageio's OpenCV plugin does: a
bitmap as uint8 (H, W, 3), 0 where the bit is 1, else 255 (its header
tokenized as Pillow does: a damaged one that OpenCV reads leniently
raises ValueError here); a *.pfm path holding Pf through OpenCV's PFM
reader (uint8 (H, W)); PF and P7 at any path as their bytes.  Refused by
name (NotImplementedError): a PAM of tuple type GRAYSCALE_ALPHA or
RGB_ALPHA (OpenCV's reader leaves part of each row unwritten, so
imageio's array is not defined), a *.pbm path holding anything but a
bitmap or PFM/PAM and a *.pfm path holding P1-P6 (imageio reads those
through OpenCV's PxM reader), and PyP, which imageio fails on; a damaged
or truncated file raises ValueError where imageio raises.
"""

import concurrent.futures
import os
import re

import numpy as np

from terrain_tpu_torch.data import cvread
from terrain_tpu_torch.serve.png import pillow_bool

_WS = b" \t\n\x0b\x0c\r"
_BLOCK = 1 << 20  # Pillow's ImageFile.SAFEBLOCK, the plain decoder's reads
# magic -> (Pillow's mode, its channels)
_MODES = {b"P1": ("1", 1), b"P2": ("L", 1), b"P3": ("RGB", 3),
          b"P4": ("1", 1), b"P5": ("L", 1), b"P6": ("RGB", 3),
          b"P0CMYK": ("CMYK", 4), b"Pf": ("F", 1), b"PyRGBA": ("RGBA", 4),
          b"PyCMYK": ("CMYK", 4)}
_REFUSED = {
    b"PyP": "PyP (Pillow's palette test kind), which imageio fails on",
}
# the kinds Pillow cannot open, which imageio reads through OpenCV
_OPENCV = (b"PF", b"P7")
_BAND_ROWS = 64  # a large PFM is converted in bands of rows, on threads
_THREADS = min(8, os.cpu_count() or 1)
MAGICS = tuple(_MODES) + _OPENCV + tuple(_REFUSED)


def _refuse(what):
    raise NotImplementedError(f"PNM: {what}; the port decodes P1-P7, Pf, "
                              f"PF, P0CMYK, PyRGBA and PyCMYK")


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
    """PNM bytes -> the array imageio.v3.imread returns: through Pillow,
    or (PF and P7, which Pillow cannot open) through OpenCV."""
    buf = bytes(buf)
    if cvread.reader(None, _Reader(buf[:8]).magic() not in _OPENCV) \
            == "opencv":
        return decode_pfm_cv(buf) if buf[:2] == b"PF" else \
            decode_pam_cv(buf)
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


# ------------------------------------------------------- OpenCV's readers
def _cv_token(buf, pos):
    """OpenCV's PFM read_number: the bytes up to the first white space
    (which it takes too), at most 2048; a byte past 127 fails."""
    tok = bytearray()
    for _ in range(2048):
        if pos >= len(buf):
            raise ValueError("PFM: the header ends early")
        c = buf[pos]
        pos += 1
        if c >= 128:
            raise ValueError("PFM: a byte past 127 in the header")
        if c in _WS:
            break
        tok.append(c)
    return bytes(tok), pos


_CV_INT = re.compile(rb"[+-]?[0-9]+")
_CV_FLOAT = re.compile(
    rb"[+-]?(inf(inity)?|nan|([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?)",
    re.IGNORECASE)


def decode_pfm_cv(buf):
    """Pf or PF bytes -> the array imageio gives through OpenCV's PFM reader:
    uint8 (H, W) or (H, W, 3), rows bottom-up, each sample times
    1/|scale| in float32, rounded half to even and saturated (cvread), in
    bands of rows on host threads (the bytes do not depend on them)."""
    buf = bytes(buf)
    if buf[:1] != b"P" or buf[1:2] not in (b"f", b"F") or buf[2:3] != b"\n":
        raise ValueError("PFM: not a PFM header (Pf or PF, then a newline)")
    bands = 3 if buf[1:2] == b"F" else 1
    pos = 3
    w_tok, pos = _cv_token(buf, pos)
    h_tok, pos = _cv_token(buf, pos)
    s_tok, pos = _cv_token(buf, pos)
    w, h = (int(m.group()) if (m := _CV_INT.match(t)) else 0
            for t in (w_tok, h_tok))
    m = _CV_FLOAT.match(s_tok)
    scale = float(m.group()) if m else 0.0
    if not abs(scale) > 0.0:
        raise ValueError("PFM: the scale must be non-zero")
    cvread.check_size(w, h, "PFM")
    n = w * h * bands
    if len(buf) - pos < 4 * n:
        raise ValueError("PFM: the samples are cut short")
    shape = (h, w, 3) if bands == 3 else (h, w)
    px = np.frombuffer(buf, ">f4" if scale > 0 else "<f4", n, pos).reshape(
        shape)
    k = None if abs(scale) == 1.0 else 1.0 / abs(scale)
    out = np.empty(shape, np.uint8)

    def band(r0, r1):  # output rows r0..r1: the file's rows bottom-up
        out[r0:r1] = cvread.to_u8(px[h - r1:h - r0][::-1].astype(
            np.float32), k)

    spans = [(r, min(r + _BAND_ROWS, h)) for r in range(0, h, _BAND_ROWS)]
    if len(spans) == 1:
        band(*spans[0])
    else:  # numpy lets go of the GIL in the arithmetic
        with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
            for f in [pool.submit(band, *b) for b in spans]:
                f.result()
    return out


_PAM_FIELDS = (b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE",
               b"ENDHDR")
_PAM_TUPLES = {b"": 0, b"BLACKANDWHITE": 1, b"GRAYSCALE": 1,
               b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(buf, pos):
    """One header line as OpenCV's ReadPAMHeaderLine reads it: (field or
    None for a comment, value, position after it)."""
    def byte():
        nonlocal pos
        if pos >= len(buf):
            raise ValueError("PAM: the header ends early")
        pos += 1
        return buf[pos - 1:pos]

    c = byte()
    while c in _WS:
        c = byte()
    if c == b"#":
        while c not in (b"\n", b"\r"):
            c = byte()
        return None, b"", pos
    ident = b""
    for _ in range(8):
        if c in _WS:
            break
        ident += c
        c = byte()
    if c not in _WS:
        raise ValueError(f"PAM: a header name too long ({ident!r}...)")
    if ident not in _PAM_FIELDS:
        raise ValueError(f"PAM: an unknown header name {ident!r}")
    if c in (b"\n", b"\r"):
        return ident, b"", pos
    while c in _WS:
        c = byte()
    value = b""
    for _ in range(255):
        if c in (b"\n", b"\r"):
            break
        value += c
        c = byte()
    if c not in (b"\n", b"\r"):
        raise ValueError("PAM: a header value too long")
    return ident, value.rstrip(_WS), pos


def pam_header(buf):
    """(width, height, depth, maxval, tuple type, data offset) of a PAM as
    OpenCV reads its header; NotImplementedError for a tuple type whose
    rows OpenCV leaves partly unwritten, ValueError where it fails."""
    buf = bytes(buf)
    if buf[:2] != b"P7" or buf[2:3] not in (b"\n", b"\r"):
        raise ValueError("PAM: not a PAM header (P7, then a newline)")
    pos, got, tuple_type = 3, {}, b""
    while True:
        field, value, pos = _pam_line(buf, pos)
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise ValueError(f"PAM: tuple type {value!r}")
            tuple_type = value
        elif field is not None:
            if field in got:
                raise ValueError(f"PAM: {field.decode()} given twice")
            if not re.fullmatch(rb"-?[0-9]+", value) or \
                    abs(int(value)) >= 1 << 31:
                raise ValueError(f"PAM: {field.decode()} {value!r}")
            got[field] = int(value)
    if len(got) < 4:
        raise ValueError("PAM: the header lacks WIDTH, HEIGHT, DEPTH or "
                         "MAXVAL")
    w, h, depth, maxval = (got[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH",
                                             b"MAXVAL"))
    if maxval > 65535:
        raise ValueError(f"PAM: maxval {maxval}")
    if not tuple_type:
        tuple_type = {1: b"GRAYSCALE", 3: b"RGB"}.get(depth) \
            if maxval < 256 else None
        if tuple_type is None:
            raise ValueError(f"PAM: OpenCV cannot tell the tuple type of "
                             f"depth {depth} at maxval {maxval}")
    if _PAM_TUPLES[tuple_type] != depth:
        raise ValueError(f"PAM: tuple type {tuple_type.decode()} at depth "
                         f"{depth}")
    if tuple_type.endswith(b"_ALPHA"):
        _refuse(f"a PAM of tuple type {tuple_type.decode()}, whose rows "
                f"OpenCV's reader leaves partly unwritten (imageio's array "
                f"is not defined)")
    cvread.check_size(w, h, "PAM")
    return w, h, depth, maxval, tuple_type, pos


def decode_pam_cv(buf):
    """P7 bytes -> the array imageio gives through OpenCV's PAM reader:
    uint8 (H, W, 3)."""
    buf = bytes(buf)
    w, h, depth, maxval, _, pos = pam_header(buf)
    two = maxval > 255
    row = w * depth * (2 if two else 1)
    if len(buf) - pos < row * h:
        raise ValueError("PAM: the samples are cut short")
    if maxval == 1:  # OpenCV's bit mode: each row's first bytes as bits
        rows = np.frombuffer(buf, np.uint8, row * h, pos).reshape(h, row)
        bits = np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w]
        gray = bits * np.uint8(255)
        return np.repeat(gray[..., None], 3, axis=2)
    v = np.frombuffer(buf, ">u2" if two else np.uint8, w * h * depth, pos)
    if two:
        v = v >> 8
    v = v.astype(np.uint8).reshape(h, w, depth)
    if depth == 1:
        return np.repeat(v, 3, axis=2)
    return cvread.colour(v)  # RGB rows copied into OpenCV's BGR image


def check_kind(path, head):
    """Raise NotImplementedError where the file's first bytes `head` (its
    header, for a PAM) name a kind the port refuses for a file at `path`:
    PyP, a PAM with alpha, and where imageio reads the path through OpenCV
    (a *.pbm or *.pfm path) any kind but a bitmap at a *.pbm path, PFM and
    PAM; ValueError where a PAM's header is damaged."""
    head = bytes(head)
    magic = _Reader(head).magic()
    if magic in _REFUSED:
        _refuse(_REFUSED[magic])
    if head[:2] == b"P7":
        pam_header(head)
    ext = os.path.splitext(path)[1].lower()
    by_opencv = magic in _OPENCV or head[:2] in (b"Pf", b"PF") or (
        ext == ".pbm" and magic in (b"P1", b"P4"))
    if magic in MAGICS and not by_opencv and \
            cvread.reader(path, magic not in _OPENCV) == "opencv":
        _refuse(f"a *{ext} path holding {magic.decode(errors='replace')} "
                f"(imageio reads a *{ext} path through OpenCV)")


def read_pnm(path):
    """A PNM file decoded as imageio.v3.imread(path) gives it: a *.pbm path
    through OpenCV's reading of a bitmap, a *.pfm path through OpenCV's PFM
    reader, PF and P7 through OpenCV's readers, any other through
    Pillow."""
    with open(path, "rb") as f:
        buf = f.read()
    check_kind(path, buf[:8] if buf[:2] != b"P7" else buf)
    magic = _Reader(buf[:8]).magic()
    if cvread.reader(path, magic not in _OPENCV) == "pillow":
        return decode_pnm(buf)
    if buf[:2] in (b"Pf", b"PF"):
        return decode_pfm_cv(buf)
    if magic == b"P7":
        return decode_pam_cv(buf)
    white = np.where(decode_pnm(buf), np.uint8(255), np.uint8(0))
    return np.repeat(white[..., None], 3, axis=2)

"""A small PNG codec on numpy and zlib, for the server's png payloads and
the trainer's raster pairs (TERRAIN_RASTER).

The port depends on no image library.  `encode_png` writes 8- or 16-bit
gray, gray+alpha, RGB or RGBA images, with the "Up" filter on every row by
default (smooth terrain compresses well under it) or any per-row choice of
the five filter types; filtering reads only the unfiltered image, so numpy
vectorizes it.  `decode_png` reads any PNG: every colour type and
bit depth, Adam7 interlaced or not, palettes through PLTE; `read_png` gives
what `imageio.v3.imread` gives for it (Pillow's modes), and a file cut or
damaged in its image data decodes or raises as Pillow's does (`_inflate`;
`check_open` holds Pillow's errors before the data, which icons raise).
Undoing the Average and Paeth filters is sequential
along a row, so it runs in host C++ (csrc/png_unfilter.cpp, built at
first use with the host compiler; without one decoding raises).
`unfilter_reference` is the same work one byte at a time in Python, the
plain version the tests hold the C++ against.
"""

import ctypes
import functools
import os
import re
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR.items()}
_UNFILTER_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "csrc", "png_unfilter.cpp")
_FILTER_ROWS = 256  # rows filtered at once by the encoder (bounds memory)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _shift_left(a, bpp):
    """a's bytes one pixel to the right: the left neighbour of each byte
    (0 before the first pixel)."""
    out = np.zeros_like(a)
    out[:, bpp:] = a[:, :-bpp]
    return out


def _predict(ftype, cur, up, bpp):
    """The PNG predictor of filter type `ftype` for rows `cur` (uint8) under
    rows `up`."""
    if ftype == 0:
        return 0
    if ftype == 1:
        return _shift_left(cur, bpp)
    if ftype == 2:
        return up
    left = _shift_left(cur, bpp)
    if ftype == 3:  # floor((left + up) / 2), in uint8
        return (left >> 1) + (up >> 1) + (left & up & 1)
    a, b = left.astype(np.int16), up.astype(np.int16)
    c = _shift_left(up, bpp).astype(np.int16)
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _filter_rows(rows, bpp, ftypes):
    """rows (h, stride) uint8, the unfiltered image; ftypes (h,) filter
    types 0-4 -> (h, 1 + stride) uint8 rows, each led by its type.  Every
    predictor reads unfiltered bytes only, so the rows of one type are
    filtered together, _FILTER_ROWS at a time."""
    h, stride = rows.shape
    ftypes = np.asarray(ftypes, np.uint8).reshape(h)
    if (ftypes > 4).any():
        raise ValueError("PNG filter types are 0-4")
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = ftypes
    for ftype in range(5):
        idx = np.nonzero(ftypes == ftype)[0]
        for i in range(0, idx.size, _FILTER_ROWS):
            r = idx[i:i + _FILTER_ROWS]
            cur = rows[r]
            up = rows[r - 1]
            up[r == 0] = 0
            out[r, 1:] = cur - _predict(ftype, cur, up, bpp)
    return out


def encode_png(img, level=3, filters=2):
    """img (H, W) or (H, W, 1|2|3|4) of uint8 or uint16 -> PNG bytes.
    `filters`: one filter type for every row (default 2, Up) or one per
    row."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR:
        raise ValueError(f"expected (H, W, 1|2|3|4), got shape {a.shape}")
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"expected uint8 or uint16, got {a.dtype}")
    if not 0 <= int(level) <= 9:
        raise ValueError(f"zlib level must be in [0, 9], got {level}")
    h, w, c = a.shape
    raw = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = raw.view(np.uint8).reshape(h, w * c * (depth // 8))
    data = _filter_rows(rows, c * depth // 8,
                        np.broadcast_to(np.asarray(filters, np.uint8), (h,)))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), int(level)))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_reference(raw, h, stride, bpp):
    """The plain version of the C++ unfilter: raw (h * (1 + stride),)
    uint8 -> (h, stride) uint8, one byte at a time.  For tests only."""
    raw = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    for r in range(h):
        ftype = int(raw[r, 0])
        if ftype > 4:
            raise ValueError(f"bad PNG filter type {ftype} in row {r}")
        prev = [int(v) for v in out[r - 1]] if r else [0] * stride
        row = [int(v) for v in raw[r, 1:]]
        for i in range(stride):
            left = row[i - bpp] if i >= bpp else 0
            ul = prev[i - bpp] if i >= bpp else 0
            pred = (0, left, prev[i], (left + prev[i]) // 2,
                    _paeth(left, prev[i], ul))[ftype]
            row[i] = (row[i] + pred) & 0xFF
        out[r] = row
    return out


@functools.lru_cache(maxsize=None)
def _unfilter_fn():
    from terrain_tpu_torch.ops.kernels import _build

    fn = ctypes.CDLL(_build.build_host(_UNFILTER_SRC)).png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    return fn


def unfilter(raw, h, stride, bpp):
    """raw (h * (1 + stride),) uint8, the inflated image data -> (h, stride)
    uint8 rows with every filter undone (csrc/png_unfilter.cpp)."""
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size != h * (stride + 1) or bpp < 1:
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h} rows of 1 + {stride}")
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_fn()(raw.ctypes.data, h, stride, bpp, out.ctypes.data)
    if bad:
        r = bad - 1
        raise ValueError(f"bad PNG filter type {raw[r * (stride + 1)]} in "
                         f"row {r}")
    return out


def read_header(buf):
    """(width, height, bit depth, colour type, interlace) of PNG bytes."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG")
    (n,) = struct.unpack(">I", buf[8:12])
    if buf[12:16] != b"IHDR" or n != 13:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        buf[16:29])
    return w, h, depth, ctype, interlace


# colour type -> the bit depths PNG allows for it
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def unpack_samples(rows, w, depth):
    """(h, row bytes) of `depth`-bit samples (1, 2 or 4), most significant
    first, as PNG, TIFF and BMP pack them -> (h, w) uint8 values."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(rows.shape[0], -1)[:, :w]


def _samples(raw, w, h, depth, c):
    """Inflated, filtered rows of one image (or one Adam7 pass) -> (h, w, c)
    samples: uint8 (values 0 to 2^depth - 1 below 8 bits) or uint16."""
    bits = c * depth
    stride = -(-w * bits // 8)
    out = unfilter(raw, h, stride, max(1, bits // 8))
    if depth < 8:
        return unpack_samples(out, w, depth)[..., None]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, c)
    return out.reshape(h, w, c)


def _chunks(buf):
    """(IDAT bytes joined, PLTE bytes or None, [(end of each IDAT's data in
    the joined bytes, its end in `buf` as its length field says)])."""
    pos, idat, plte, ends, joined = 8, [], None, [], 0
    while pos + 8 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat.append(buf[pos + 8:pos + 8 + n])
            joined += len(idat[-1])
            ends.append((joined, pos + 8 + n))
        elif tag == b"PLTE":
            plte = bytes(buf[pos + 8:pos + 8 + n])
        elif tag == b"IEND":
            break
        pos += 12 + n
    return b"".join(idat), plte, ends


def _is_chunk_type(tag):
    return re.fullmatch(rb"\w{4}", tag) is not None


def _truncated(buf, ends):
    """What Pillow raises where the IDATs end before the rows: SyntaxError
    where 4 to 7 bytes of the next chunk's header, or one naming no chunk
    type, follow the last IDAT and its CRC, OSError otherwise."""
    head = buf[ends[-1][1] + 4:ends[-1][1] + 12] if ends else b""
    if len(head) >= 4 and not _is_chunk_type(head[4:]):
        return SyntaxError("PNG: a chunk header after the image data is cut "
                           "short or broken")
    return OSError("PNG: image file is truncated")


def _rows_chunk(data, ends, rows):
    """The IDAT (its index in `ends`) in which Pillow's decoder fills the
    rows [(bytes of a row, filter included, count)], or None.  Pillow feeds
    it each IDAT's data in blocks of up to 64 KiB, and it inflates one row
    at a time while its block lasts, even where zlib holds the next row
    already."""
    d, start = zlib.decompressobj(), 0
    sizes = (size for size, count in rows for _ in range(count))
    left = next(sizes)
    for j, (end, _) in enumerate(ends):
        for b in range(start, end, 1 << 16):
            tail = data[b:min(b + (1 << 16), end)]
            while tail:
                left -= len(d.decompress(tail, left))
                tail = d.unconsumed_tail
                if not left:
                    left = next(sizes, 0)
                    if not left:
                        return j
        start = end
    return None


def _inflate(buf, rows):
    """(the bytes the IDATs of PNG bytes `buf` inflate to for the rows
    [(bytes of a row, filter included, count)], its PLTE bytes or None), as
    Pillow's PngImageFile.load takes them.  Its decoder stops once the rows
    are filled: a stream cut or damaged after them still gives the image,
    but every later chunk up to IEND whose header is whole must hold its
    data (OSError).  Data that ends or breaks before the rows raises as
    `_truncated` says, or OSError."""
    data, plte, ends = _chunks(buf)
    need = sum(size * count for size, count in rows)
    try:
        raw = zlib.decompressobj().decompress(data, need)
    except zlib.error as e:
        raise OSError(f"PNG: broken data stream ({e})") from e
    if len(raw) < need:
        raise _truncated(buf, ends)
    # the walk below may start at any IDAT from the one that fills the rows
    # on while the IDATs are whole; where the last is cut, at that one
    j = len(ends) - 1
    if ends[j][1] > len(buf):
        j = _rows_chunk(data, ends, rows)
        if j is None:
            raise _truncated(buf, ends)
    pos = ends[j][1] + 4  # past its CRC
    while True:  # Pillow's load_end
        head = buf[pos:pos + 8]
        if len(head) < 8 or not _is_chunk_type(head[4:]) or \
                head[4:] == b"IEND":
            return raw, plte
        (n,) = struct.unpack(">I", head[:4])
        if len(buf) < pos + 8 + n:
            raise OSError("PNG: a chunk after the image data is cut short "
                          "(Truncated File Read)")
        pos += 12 + n


def decode_samples(buf):
    """PNG bytes -> (samples (H, W, C), bit depth, colour type, palette):
    the stored samples de-interlaced (uint8, values below 2^depth for 1, 2
    and 4 bits, or uint16) and, for colour type 3, PLTE as a (256, 3) uint8
    table (entries past PLTE black, as Pillow pads it)."""
    w, h, depth, ctype, interlace = read_header(buf)
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or \
            interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    c = 1 if ctype == 3 else _CHANNELS[ctype]
    # (x0, y0, dx, dy, width, height) of each pass that holds pixels (an
    # empty pass has no bytes, not even filters)
    passes = [(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy))
              for x0, y0, dx, dy in (_ADAM7 if interlace else
                                     ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    rows = [(1 + -(-pw * c * depth // 8), ph) for *_, pw, ph in passes]
    raw, plte = _inflate(buf, rows)
    raw = np.frombuffer(raw, np.uint8)
    if not interlace:
        img = _samples(raw, w, h, depth, c)
    else:
        img = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for (x0, y0, dx, dy, pw, ph), (size, _) in zip(passes, rows):
            img[y0::dy, x0::dx] = _samples(raw[at:at + size * ph], pw, ph,
                                           depth, c)
            at += size * ph
    palette = None
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: a palette image without its PLTE")
        palette = np.zeros((256, 3), np.uint8)
        k = min(len(plte) // 3, 256)
        palette[:k] = np.frombuffer(plte, np.uint8)[:3 * k].reshape(k, 3)
    return img, depth, ctype, palette


def decode_png(buf):
    """PNG bytes -> (H, W, C) uint8 or uint16 array: 8- and 16-bit samples
    as stored, gray of 1, 2 or 4 bits scaled to 0-255, a palette image as
    its RGB colours."""
    img, depth, ctype, palette = decode_samples(buf)
    if ctype == 3:
        return palette[img[..., 0]]
    if depth < 8:
        return img * np.uint8(255 // ((1 << depth) - 1))
    return img


def pillow_bool(v):
    """A bool array as Pillow's mode "1" gives it to numpy: True stored as
    the byte 255, not 1 (so its bytes, and a digest of them, are Pillow's;
    comparisons and casts see True either way)."""
    return np.where(np.asarray(v) != 0, np.uint8(255), np.uint8(0)).view(
        bool)


def check_open(buf):
    """Raise what Pillow's PngImageFile raises while it opens PNG bytes (the
    chunks up to the first IDAT): SyntaxError where a chunk header or
    checksum is cut short, OSError where a chunk's data is."""
    p = 8
    while True:
        if len(buf) < p + 8:
            raise SyntaxError("PNG: a chunk header is cut short")
        (n,) = struct.unpack(">I", buf[p:p + 4])
        if buf[p + 4:p + 8] == b"IDAT":
            return
        if len(buf) < p + 8 + n:
            raise OSError("PNG: a chunk is cut short (Truncated File Read)")
        if len(buf) < p + 12 + n:
            raise SyntaxError("PNG: a checksum is cut short")
        p += 12 + n


def read_png(buf):
    """PNG bytes -> the array imageio.v3.imread returns (through Pillow's
    modes): bool (H, W) for 1-bit gray, uint8 (H, W) for 2-, 4- and 8-bit
    gray (2 and 4 scaled by 85 and 17), uint16 (H, W) for 16-bit gray,
    (H, W, 3) RGB for a palette image (tRNS ignored, as imageio ignores it
    for every colour type), and for 16-bit colour the high bytes as uint8:
    RGB, RGBA, and gray+alpha as (L, L, L, A)."""
    img, depth, ctype, palette = decode_samples(buf)
    if ctype == 3:
        return palette[img[..., 0]]
    if ctype == 0:
        g = img[..., 0]
        if depth == 1:
            return pillow_bool(g)
        return g * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else g
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:  # Pillow's "LA;16B" into RGBA
            return img[..., [0, 0, 0, 1]]
    return img


def read_png_path(path):
    """The PNG at `path` as `imageio.v3.imread(path)` gives it (read_png)."""
    with open(path, "rb") as f:
        return read_png(f.read())


def write_png_path(path, img):
    """`imageio.v3.imwrite(path, img)` for a PNG name: img (encode_png's
    shapes and dtypes) as a PNG at `path`.  imageio picks the format by the
    name; the port writes PNG only, and refuses any other name by name."""
    if os.path.splitext(os.fspath(path))[1].lower() != ".png":
        raise NotImplementedError(f"{path}: the port writes PNG images only "
                                  f"(serve/png.py); name the output *.png")
    with open(path, "wb") as f:
        f.write(encode_png(img))

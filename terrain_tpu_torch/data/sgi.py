"""SGI image decoding for the trainer's raster pairs (TERRAIN_RASTER) and
the port's dataset tools.

The JAX package reads its rasters with imageio, which decodes an SGI file
(*.sgi, *.rgb, *.rgba, *.bw; magic 474, big-endian) through Pillow
(SgiImagePlugin.py).  The port depends on no image library: `decode_sgi`
reads the 512-byte header here, uncompressed channels with numpy and
run-length rows with the port's host C++ (csrc/raster_decode.cpp's
sgi_rle, Pillow's SgiRleDecode.c, bands of rows on host threads: the
bytes do not depend on the thread count), and gives
`imageio.v3.imread`'s array (Pillow 12.1.0, imageio 2.37.4):
  * storage 0 (one plane a channel) and 1 (run-length rows through the
    offset and length tables, channel-major);
  * 1 or 2 bytes a sample: a 16-bit sample gives its high byte (Pillow's
    raw mode L;16B), so every SGI comes back as uint8;
  * dimension 1 or 2 with one channel (gray, (H, W)), dimension 3 with 3
    (RGB) or 4 (RGBA) channels;
  * rows bottom-up.
Pillow's run-length quirks are kept: a row's length field counts packets,
not bytes; a row that ends early keeps what the row before left in those
columns; a copy run that ends on the file's last byte is an overrun.  A
last allowed packet that is not the terminator stops Pillow's decode and
leaves the rows from there on unwritten in an image it never initialised:
imageio's array is not defined, and the port refuses the file by name.
What imageio fails on raises the exception it raises there: SyntaxError
for a header cut short or a zero side, ValueError for another (bpc,
dimension, zsize), OSError for a truncated or overrun file or another
storage byte, ValueError for a cut 16-bit plane.
"""

import concurrent.futures
import os
import struct

import numpy as np

from terrain_tpu_torch.data import pillow_open

MAGIC = b"\x01\xda"
EXTENSIONS = (".sgi", ".rgb", ".rgba", ".bw")
_HEADER = 512
_THREADS = min(8, os.cpu_count() or 1)
# (bpc, dimension, zsize) -> channels, as Pillow's MODES
_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1,
          (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4, (2, 3, 4): 4}


def read_header(buf):
    """(storage, bpc, width, height, channels) of an SGI header, as Pillow
    reads it; SyntaxError where Pillow does not identify it (a header cut
    short, a zero side: imageio's legacy SGI reader then raises that),
    ValueError for a layout Pillow does not read."""
    buf = bytes(buf[:_HEADER])
    if len(buf) < 2 or buf[:2] != MAGIC:
        raise SyntaxError("SGI: not an SGI file")
    if len(buf) < 12:
        raise SyntaxError("SGI: the header is cut short")
    storage, bpc = buf[2], buf[3]
    dim, w, h, z = struct.unpack(">4H", buf[4:12])
    if (bpc, dim, z) not in _MODES:
        raise ValueError(f"SGI: bpc {bpc}, dimension {dim} and {z} channels "
                         f"(Pillow: Unsupported SGI image mode)")
    if not w or not h:
        raise SyntaxError(f"SGI: a {w}x{h} image")
    return storage, bpc, w, h, _MODES[(bpc, dim, z)]


def _planes(buf, bpc, w, h, z):
    """Storage 0: one bottom-up plane a channel; the high byte of each
    16-bit sample."""
    page = w * h * bpc
    have = len(buf) - _HEADER
    if have < page * z:
        if bpc == 2:  # Pillow's SGI16Decoder: Image.frombytes
            raise ValueError("SGI: not enough image data")
        raise OSError("SGI: image file is truncated")
    px = np.frombuffer(buf, np.uint8, page * z, _HEADER).reshape(
        z, h, w, bpc)[..., 0]
    return np.ascontiguousarray(px[:, ::-1].transpose(1, 2, 0))


def _rle(buf, bpc, w, h, z):
    from terrain_tpu_torch.data.tiff import _lib

    data = np.frombuffer(buf, np.uint8, offset=_HEADER) \
        if len(buf) > _HEADER else np.zeros(0, np.uint8)
    n = z * h
    if data.size < 8 * n:
        raise OSError("SGI: image buffer overrun error (the offset and "
                       "length tables are cut short)")
    tabs = data[:8 * n].view(">u4").astype(np.int64)
    starts, lengths = np.ascontiguousarray(tabs[:n]), \
        np.ascontiguousarray(tabs[n:])
    out = np.zeros((h, w, z), np.uint8)
    ends = np.zeros(n, np.int64)
    status = np.zeros(n, np.int8)
    lib = _lib()

    def band(r0, r1):
        lib.sgi_rle(data.ctypes.data, data.size, starts.ctypes.data,
                    lengths.ctypes.data, w, h, z, bpc, r0, r1,
                    out.ctypes.data, ends.ctypes.data, status.ctypes.data)

    step = max(1, -(-h // (4 * _THREADS)))
    bands = [(r, min(r + step, h)) for r in range(0, h, step)]
    if len(bands) == 1:
        band(*bands[0])
    else:
        with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
            for f in [pool.submit(band, *b) for b in bands]:
                f.result()
    bad = np.flatnonzero(status)
    if bad.size:
        first = int(bad[0])
        if status[first] < 0:
            raise OSError("SGI: image buffer overrun error")
        raise NotImplementedError(
            f"SGI: the length field of row {first // z} stops the decode "
            f"there; Pillow leaves that row and those above it unwritten in "
            f"an image it does not initialise, so imageio's array is not "
            f"defined")
    # a row that stopped short keeps the row before's samples (bottom-up)
    short = np.flatnonzero(ends < w)
    for i in short.tolist():
        r, c = divmod(i, z)
        y = h - 1 - r
        x = int(ends[i])
        out[y, x:, c] = out[y + 1, x:, c] if r else 0
    return out


def decode_sgi(buf):
    """SGI bytes -> the array imageio.v3.imread returns (through Pillow):
    uint8 (H, W), (H, W, 3) or (H, W, 4)."""
    buf = bytes(buf)
    pillow_open.check_tiny(buf)
    storage, bpc, w, h, z = read_header(buf)
    if storage == 0:
        px = _planes(buf, bpc, w, h, z)
    elif storage == 1:
        px = _rle(buf, bpc, w, h, z)
    else:
        raise OSError(f"SGI: storage {storage} (Pillow: cannot load this "
                       f"image)")
    return px.reshape(h, w) if z == 1 else px  # a view: no second copy

"""The port's PNM and TGA decoders (terrain_tpu_torch/data/pnm.py,
data/tga.py and the run-length packets of data/csrc/raster_decode.cpp)
against imageio, which decodes them through Pillow (a *.pbm path, and PF
and P7 bytes, through OpenCV; the JAX package's reader): every committed fixture of
tests/data/pnm and tests/data/tga (tests/make_raster_fixtures.py) to
imageio's shape, dtype and SHA-256, files Pillow writes here, random
samples at every maxval, random run-length streams, the kinds refused by
name, damaged files, and a PGM/TGA pair's crops against terrain_tpu's
`_get_data`.  Images are a few dozen pixels a side."""

import io
import struct

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, rerun, same_first_batches,
                          script, summary)
from terrain_tpu_torch.data import pnm, tga
from terrain_tpu_torch.data.raster import read_raster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()


def _pillow(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(digests("pnm")))
def test_each_pnm_fixture_decodes_to_imageios_array(name):
    check_fixture("pnm", name, pnm.decode_pnm)


@pytest.mark.parametrize("name", sorted(digests("tga")))
def test_each_tga_fixture_decodes_to_imageios_array(name):
    check_fixture("tga", name, tga.decode_tga)


@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6"])
@pytest.mark.parametrize("maxval", [1, 2, 15, 100, 255, 256, 999, 4095,
                                    65535])
def test_random_samples_scale_as_pillow(magic, maxval):
    """Every sample 0..maxval (and, in a binary file, past it: Pillow
    clamps) rounded half to even as Pillow's decoders round it."""
    rnd = np.random.RandomState(maxval)
    bands = 3 if magic in (b"P3", b"P6") else 1
    h, w = 5, 11
    top = maxval if magic in (b"P2", b"P3") else min(2 * maxval, 65535)
    v = rnd.randint(0, top + 1, (h, w, bands))
    if magic in (b"P2", b"P3"):
        body = mk._plain(v)
    else:
        body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    data = mk._pnm(magic, w, h, maxval, body)
    assert summary(pnm.decode_pnm(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB", "F"])
def test_pillows_pnm_files_decode_as_imageio(mode, tmp_path):
    rnd = np.random.RandomState(7)
    img = Image.fromarray(mk.terrain(19, 23, 3))
    img = {"1": img.convert("1"), "L": img.convert("L"),
           "RGB": img, "I;16": Image.fromarray(
               rnd.randint(0, 65536, (19, 23)).astype(np.uint16)),
           "F": Image.fromarray(rnd.randn(19, 23).astype(np.float32))}[mode]
    data = _pillow(img, "PPM")
    assert summary(pnm.decode_pnm(data)) == summary(iio.imread(data))
    path = tmp_path / ("a.pbm" if mode == "1" else "a.pgm")
    path.write_bytes(data)
    assert summary(read_raster(str(path))) == summary(iio.imread(path))


@pytest.mark.parametrize("data", [
    b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x07",
    b"PF\n1 1\n-1.0\n" + bytes(12),
    b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n"
    + bytes(range(6)),
    b"PF\n2 1\n1.0\n" + np.arange(6, dtype=">f4").tobytes()])
def test_pf_and_p7_bytes_decode_as_imageio_through_opencv(data):
    """PF and P7, which Pillow cannot open: imageio falls back to OpenCV
    for their bytes (data/pnm.py's OpenCV readers)."""
    assert summary(pnm.decode_pnm(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("data,match", [
    (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\n"
     b"TUPLTYPE GRAYSCALE_ALPHA\nENDHDR\n\x00\x01",
     r"tuple type GRAYSCALE_ALPHA"),
    (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 4\nMAXVAL 255\n"
     b"TUPLTYPE RGB_ALPHA\nENDHDR\n\x00\x01\x02\x03",
     r"tuple type RGB_ALPHA"),
    (b"PyP\n1 1\n255\n\x00", "PyP")])
def test_other_pnm_kinds_are_refused_by_name(data, match):
    with pytest.raises(NotImplementedError, match=match):
        pnm.decode_pnm(data)


def test_a_pbm_path_holding_gray_is_refused(tmp_path):
    path = tmp_path / "a.pbm"
    path.write_bytes(mk._pnm(b"P5", 2, 1, 255, b"\x01\x02"))
    with pytest.raises(NotImplementedError, match=r"a \*.pbm path holding"):
        read_raster(str(path))
    assert summary(pnm.decode_pnm(path.read_bytes())) == summary(
        iio.imread(path.read_bytes()))


@pytest.mark.parametrize("data,match", [
    (b"P6\n2 2\n255\n" + bytes(11), "cut short"),
    (b"P5\n2 2\n255\n", "cut short"),
    (b"P4\n9 2\n\x00\x00\x00", "cut short"),
    (b"P2\n2 1\n9\n3 12\n", "a sample of 12 for maxval 9"),
    (b"P1\n2 1\n0 2\n", "in a plain bitmap"),
    (b"P5\n2 1\n0\n\x00\x00", "maxval 0"),
    (b"P5\n2 1\n65536\n" + bytes(4), "maxval 65536"),
    (b"P5\n2", "the header ends early"),
    (b"P5\nx 1\n255\n\x00", "is not a number"),
    (b"P5\n123456789012 1\n255\n", "token too long"),
    (b"Pf\n1 1\n0\n" + bytes(4), "finite and non-zero"),
    (b"P9\n1 1\n255\n\x00", "not a PNM file")])
def test_damaged_pnm_raises_value_error(data, match):
    with pytest.raises(Exception):
        iio.imread(data)
    with pytest.raises(ValueError, match=match):
        pnm.decode_pnm(data)


def _random_tga_rle(rnd, n, bpp):
    """Packets covering n pixels: repeats within rows of 9, literals of any
    length running on across rows."""
    out, left, x = bytearray(), n, 0
    while left:
        if rnd.randint(2):
            k = int(rnd.randint(1, min(9 - x % 9, left) + 1))
            out += bytes([0x80 | (k - 1)]) + bytes(rnd.randint(
                0, 256, bpp).tolist())
        else:
            k = int(rnd.randint(1, min(128, left) + 1))
            out += bytes([k - 1]) + bytes(rnd.randint(
                0, 256, k * bpp).tolist())
        left -= k
        x += k
    return bytes(out)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", [(11, 8), (11, 16), (10, 16), (10, 24),
                                  (10, 32), (9, 8)])
def test_random_run_length_streams_decode_as_pillow(kind, seed):
    img_type, depth = kind
    rnd = np.random.RandomState(seed)
    w, h = 9, int(rnd.randint(2, 12))
    cmap = rnd.randint(0, 256, 30).astype(np.uint8).tobytes() \
        if img_type == 9 else b""
    data = mk._tga(img_type, depth, w, h,
                   _random_tga_rle(rnd, w * h, depth // 8),
                   flags=int(rnd.choice([0, 0x10, 0x20, 0x30])), cmap=cmap,
                   cmap_depth=24 if cmap else 0)
    assert summary(tga.decode_tga(data)) == summary(
        iio.imread(data, extension=".tga"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("rle", [False, True])
def test_pillows_tga_files_decode_as_imageio(mode, rle):
    img = Image.fromarray(mk.terrain(21, 17, 9, 4)).convert(mode)
    data = _pillow(img, "TGA", rle=rle)
    assert summary(tga.decode_tga(data)) == summary(
        iio.imread(data, extension=".tga"))


@pytest.mark.parametrize("data,match", [
    (mk._tga(1, 8, 2, 1, bytes(2), cmap=bytes(8), cmap_depth=32),
     "a colour map of 32 bits"),
    (mk._tga(1, 8, 2, 1, bytes(2)), "without a colour map"),
    (mk._tga(1, 8, 2, 1, bytes(2), cmap=bytes(3 * 200), cmap_depth=24,
             start=57), "a colour map reaching entry 257"),
    (mk._tga(2, 8, 2, 1, bytes(2)), "image type 2 at 8 bits"),
    (mk._tga(2, 15, 2, 1, bytes(4)), "not a TGA file"),
    (mk._tga(4, 8, 2, 1, bytes(2)), "image type 4"),
    (mk._tga(11, 1, 8, 1, bytes([0x80, 0xFF])), "run-length 1-bit"),
    (mk._tga(11, 8, 2, 2, bytes([0x83, 7])), "crosses the end of a row"),
    (mk._tga(10, 24, 2, 2, bytes([0x81, 1, 2, 3])), "cut short"),
    (mk._tga(10, 24, 2, 1, bytes([0x81, 1, 2])), "cut short"),
    (mk._tga(2, 24, 2, 2, bytes(11)), "cut short"),
    (b"\x00" * 12, "header is cut short")])
def test_damaged_tga_raises_value_error(data, match):
    with pytest.raises(Exception):
        iio.imread(data, extension=".tga")
    with pytest.raises(ValueError, match=match):
        tga.decode_tga(data)


def test_a_pgm_and_tga_pair_gives_terrain_tpus_crops(tmp_path, monkeypatch):
    h, w = 140, 170
    tex = mk.terrain(h, w, 33)
    hm = np.where(tex[..., 0] > 40, tex[..., 1].astype(np.uint16) * 257, 0)
    hp, tp = tmp_path / "hm.pgm", tmp_path / "tex.tga"
    hp.write_bytes(mk._pnm(b"P5", w, h, 65535, hm.astype(">u2").tobytes()))
    tp.write_bytes(mk._tga(10, 24, w, h, mk._tga_rle(
        tex[::-1, :, ::-1].reshape(-1, 3), 3), flags=0))
    same_first_batches(f"{hp},{tp}", monkeypatch)


@pytest.mark.parametrize("kind", ["pnm", "tga"])
def test_committed_fixtures_match_the_script(kind, tmp_path):
    rerun(kind, tmp_path)


def test_a_header_that_pillow_cannot_read_is_found_before_decoding():
    head = struct.pack("<BBBHHBHHHHBB", 0, 1, 1, 0, 2, 32, 0, 0, 2, 1, 8,
                       0x20)
    with pytest.raises(ValueError, match="colour map of 32 bits"):
        tga.read_header(head)

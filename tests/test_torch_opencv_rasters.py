"""The rasters imageio reads through OpenCV, decoded by the port
(terrain_tpu_torch/data/pnm.py's PFM and PAM readers, data/hdr.py with
data/csrc/raster_decode.cpp's hdr_pixels, data/sun.py's OpenCV reading of a
*.sr path, data/cvread.py) against imageio on the CPU: every committed
fixture of tests/data/pfm_pam and tests/data/hdr
(tests/make_raster_fixtures.py) to imageio's shape, dtype and SHA-256 from
its bytes and its path, files OpenCV writes here from seeded arrays,
files cut at many offsets (imageio's array or ValueError where imageio
raises), imageio's choice of plugin by extension and for bytes, OpenCV's
float-to-byte rounding, and what the port refuses by name.  Images are a
few dozen pixels a side."""

import numpy as np
import pytest

from raster_cases import check_fixture, digests, rerun, script, summary
from terrain_tpu_torch.data import cvread, hdr, pnm, sun
from terrain_tpu_torch.data.raster import check_header, format_of, read_raster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
cv2 = pytest.importorskip("cv2")
mk = script()


def _imageio(src):
    """imageio's array of bytes or a path, or None where it raises."""
    try:
        return iio.imread(src)
    except Exception:  # noqa: BLE001 -- imageio raises many kinds
        return None


def _same_or_value_error(decode, src):
    want = _imageio(src)
    if want is None:
        with pytest.raises(ValueError):
            decode(src)
        return 0
    assert summary(decode(src)) == summary(want)
    return 1


def _encode(img, ext, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("name", sorted(digests("pfm_pam")))
def test_each_pfm_pam_fixture_decodes_to_imageios_array(name):
    check_fixture("pfm_pam", name, pnm.decode_pnm)


@pytest.mark.parametrize("name", sorted(digests("hdr")))
def test_each_hdr_fixture_decodes_to_imageios_array(name):
    check_fixture("hdr", name, hdr.decode_hdr)


@pytest.mark.parametrize("kind", ["pfm_pam", "hdr"])
def test_committed_fixtures_match_the_script(kind, tmp_path):
    rerun(kind, tmp_path)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("scale", [None, -1.0, 2.5, -0.3])
def test_pfm_files_decode_as_imageio(seed, bands, scale, tmp_path):
    """OpenCV's own PFM (scale -1) and the script's at other scales and
    byte orders: values at .5 ties, negative and past 255, by bytes (Pf
    through Pillow: float32) and at a *.pfm path (OpenCV: uint8)."""
    rnd = np.random.RandomState(seed)
    shape = (int(rnd.randint(1, 12)), int(rnd.randint(1, 20)))
    v = (rnd.randint(-40, 700, shape + (bands,)) / 2).astype(np.float32)
    v = v[..., 0] if bands == 1 else v
    if scale is None:
        data = _encode(v, ".pfm")
    else:
        data = mk._pfm(b"PF" if bands == 3 else b"Pf", v * abs(scale),
                       scale)
    path = tmp_path / "a.pfm"
    path.write_bytes(data)
    assert summary(pnm.decode_pnm(data)) == summary(iio.imread(data))
    assert summary(read_raster(str(path))) == summary(iio.imread(path))


@pytest.mark.parametrize("tupltype", ["BLACKANDWHITE", "GRAYSCALE", "RGB"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("ext", [".pam", ".pgm", ".ppm", ".pnm"])
def test_opencvs_pam_files_decode_as_imageio(tupltype, bits, ext, tmp_path):
    """OpenCV's PAM of each tuple type it reads back, at 8 and 16 bits: P7
    bytes, and P7 at a *.pam path and at the paths where Pillow is tried
    first, go to OpenCV."""
    rnd = np.random.RandomState(bits)
    img = rnd.randint(0, 256, (7, 9, 3 if tupltype == "RGB" else 1))
    img = img.astype(np.uint8 if bits == 8 else np.uint16) * (
        1 if bits == 8 else 257)
    data = _encode(img, ".pam", (cv2.IMWRITE_PAM_TUPLETYPE,
                                 getattr(cv2, "IMWRITE_PAM_FORMAT_"
                                         + tupltype)))
    path = tmp_path / f"a{ext}"
    path.write_bytes(data)
    assert summary(pnm.decode_pnm(data)) == summary(iio.imread(data))
    assert summary(read_raster(str(path))) == summary(iio.imread(path))


@pytest.mark.parametrize("maxval", [1, 2, 100, 255, 256, 1000, 65535])
@pytest.mark.parametrize("depth", [1, 3])
def test_random_pam_samples_decode_as_imageio(maxval, depth):
    """maxval unscaled, 16-bit samples shifted right by 8, and at maxval 1
    each row's first bytes read as packed bits."""
    rnd = np.random.RandomState(maxval + depth)
    w, h = int(rnd.randint(1, 23)), int(rnd.randint(1, 6))
    n = w * h * depth
    body = (rnd.randint(0, 65536, n).astype(">u2").tobytes() if maxval > 255
            else rnd.randint(0, 256, n).astype(np.uint8).tobytes())
    for tt in (None, b"GRAYSCALE" if depth == 1 else b"RGB"):
        data = mk._pam(w, h, depth, maxval, tt, body)
        _same_or_value_error(pnm.decode_pnm, data)


@pytest.mark.parametrize("name,header", [
    ("comments and blank lines", b"P7\n#c\n\nWIDTH 2\nHEIGHT 1\nDEPTH 1\n"
     b"MAXVAL 255\nENDHDR\n"),
    ("CR line ends", b"P7\rWIDTH 2\rHEIGHT 1\rDEPTH 1\rMAXVAL 255\rENDHDR\r"),
    ("CRLF (the LF is a sample)", b"P7\r\nWIDTH 2\r\nHEIGHT 1\r\nDEPTH 1\r\n"
     b"MAXVAL 255\r\nENDHDR\r\n"),
    ("lower-case names", b"P7\nwidth 2\nheight 1\ndepth 1\nmaxval 255\n"
     b"endhdr\n"),
    ("a hex width", b"P7\nWIDTH 0x2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
     b"ENDHDR\n"),
    ("a signed width", b"P7\nWIDTH +2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
     b"ENDHDR\n"),
    ("a width given twice", b"P7\nWIDTH 2\nWIDTH 2\nHEIGHT 1\nDEPTH 1\n"
     b"MAXVAL 255\nENDHDR\n"),
    ("the last TUPLTYPE kept", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255"
     b"\nTUPLTYPE RGB\nTUPLTYPE\nENDHDR\n"),
    ("an unknown name", b"P7\nFOO 2\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255"
     b"\nENDHDR\n"),
    ("a value after ENDHDR", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
     b"ENDHDR x\n"),
    ("a space after ENDHDR", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
     b"ENDHDR \n"),
    ("no MAXVAL", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nENDHDR\n"),
    ("maxval 0", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 0\nENDHDR\n"),
    ("depth 2 without a type", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 2\nMAXVAL 255"
     b"\nENDHDR\n"),
])
def test_pam_headers_are_read_as_opencv_reads_them(name, header):
    data = header + bytes([5, 6, 7, 8])
    _same_or_value_error(pnm.decode_pnm, data)


@pytest.mark.parametrize("name,data", [
    ("one space between tokens", b"Pf\n2 1\n-1\n"),
    ("two spaces", b"Pf\n2  1\n-1\n"),
    ("newlines", b"Pf\n2\n1\n-1\n"),
    ("a fraction", b"Pf\n2.7 1\n-1\n"),
    ("an exponent", b"Pf\n1e1 1\n-1\n"),
    ("a comment", b"Pf\n# c\n2 1\n-1\n"),
    ("hex", b"Pf\n0x2 1\n-1\n"),
    ("a scale with a tail", b"Pf\n2 1\n-2xyz\n"),
    ("an infinite scale", b"Pf\n2 1\n-inf\n"),
    ("a zero scale", b"Pf\n2 1\n0\n"),
    ("CRLF after the magic", b"Pf\r\n2 1\n-1\n"),
    ("a byte past 127", b"Pf\n2\xff 1\n-1\n"),
])
def test_pfm_headers_are_read_as_opencv_reads_them(name, data, tmp_path):
    path = tmp_path / "a.pfm"
    path.write_bytes(data + np.array([3, 4, 5, 6, 7], "<f4").tobytes())
    _same_or_value_error(read_raster, str(path))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("compression", ["RLE", "NONE"])
def test_opencvs_hdr_files_decode_as_imageio(seed, compression, tmp_path):
    rnd = np.random.RandomState(seed)
    img = rnd.uniform(0, 1.3, (int(rnd.randint(1, 9)),
                               int(rnd.randint(1, 40)), 3)).astype(
        np.float32)
    data = _encode(img, ".hdr", (cv2.IMWRITE_HDR_COMPRESSION, getattr(
        cv2, "IMWRITE_HDR_COMPRESSION_" + compression)))
    path = tmp_path / "a.hdr"
    path.write_bytes(data)
    assert summary(hdr.decode_hdr(data)) == summary(iio.imread(data))
    assert summary(read_raster(str(path))) == summary(iio.imread(path))


@pytest.mark.parametrize("seed", range(6))
def test_random_rgbe_scanlines_decode_as_imageio(seed):
    """Every exponent class, flat scanlines, new-style run-length ones,
    and run-length ones followed by flat ones (the rest of the image then
    read flat)."""
    rnd = np.random.RandomState(seed)
    w, h = int(rnd.choice([3, 7, 8, 9, 31])), int(rnd.randint(1, 6))
    px = mk._rgbe_pixels(h, w, rnd)
    rle = int(rnd.randint(0, h + 1)) if w >= 8 else 0
    body = b"".join(mk._rgbe_rle(px[y], rnd) for y in range(rle))
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
            + body + px[rle:].tobytes())
    assert summary(hdr.decode_hdr(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("kind", ["pf", "pam", "hdr_rle", "hdr_flat",
                                  "sun_sr"])
def test_files_cut_anywhere_decode_or_raise_as_imageio(kind, tmp_path):
    """Each cut: imageio's array where imageio decodes it (a Radiance file
    cut inside its last scanline fails; a Sun raster at a *.sr path needs
    every row's padding), ValueError where imageio raises."""
    rnd = np.random.RandomState(3)
    img = rnd.uniform(0, 1.3, (5, 11, 3)).astype(np.float32)
    if kind == "pf":
        data, ext = _encode(img * 200, ".pfm"), ".pfm"
    elif kind == "pam":
        data, ext = _encode((img * 150).astype(np.uint8), ".pam"), ".pam"
    elif kind == "sun_sr":
        data, ext = _encode((img * 150).astype(np.uint8), ".sr"), ".sr"
    else:
        data, ext = _encode(img, ".hdr", (
            cv2.IMWRITE_HDR_COMPRESSION,
            cv2.IMWRITE_HDR_COMPRESSION_RLE if kind == "hdr_rle"
            else cv2.IMWRITE_HDR_COMPRESSION_NONE)), ".hdr"
    path = tmp_path / f"a{ext}"
    read = {".pfm": pnm.read_pnm, ".pam": pnm.read_pnm, ".sr": sun.read_sun,
            ".hdr": lambda p: hdr.decode_hdr(open(p, "rb").read())}[ext]
    decoded = 0
    for k in sorted(set(np.linspace(0, len(data), 40).astype(int))):
        path.write_bytes(data[:k])
        decoded += _same_or_value_error(read, str(path))
    assert decoded >= 1  # the whole file at least


@pytest.mark.parametrize("depth,ftype,cmap", [
    (1, 1, 0), (8, 0, 0), (8, 1, 6), (8, 1, 768), (24, 1, 0), (32, 0, 0),
    (24, 3, 0), (8, 2, 0), (4, 1, 0), (1, 1, 6)])
def test_a_sun_raster_at_a_sr_path_decodes_as_opencv(depth, ftype, cmap,
                                                     tmp_path):
    """A *.sr path through OpenCV's reader: (H, W, 3) for depths 1, 8, 24
    and 32 of types 0 and 1, colour maps planar; the rest raise."""
    rnd = np.random.RandomState(depth + ftype)
    w, h = 11, 5
    stride = ((w * depth + 15) // 16) * 2
    body = rnd.randint(0, 256, stride * h).astype(np.uint8).tobytes()
    cm = rnd.randint(0, 256, cmap).astype(np.uint8).tobytes()
    path = tmp_path / "a.sr"
    path.write_bytes(mk._sun(w, h, depth, body, ftype, 1 if cmap else 0, cm))
    _same_or_value_error(sun.read_sun, str(path))
    assert cvread.reader(str(path), True) == "opencv"


def _plugin(src):
    try:
        with iio.imopen(src, "r") as f:
            return {"PillowPlugin": "pillow",
                    "OpenCVPlugin": "opencv"}.get(type(f).__name__)
    except Exception:  # noqa: BLE001 -- no plugin opens it
        return None


@pytest.mark.parametrize("ext", sorted(cvread.READERS) + [".raster", None])
@pytest.mark.parametrize("magic", ["P5", "P7", "Pf", "PF", "sun", "hdr"])
def test_the_reader_table_is_imageios_choice(ext, magic, tmp_path):
    """cvread.reader gives the plugin imageio opens a file with, for each
    extension in the table, another one, and bytes: Pillow first where the
    extension's list or the fallback puts it first and it opens the file,
    OpenCV otherwise."""
    data = {"P5": mk._pnm(b"P5", 2, 1, 255, b"\x01\x02"),
            "P7": mk._pam(2, 1, 1, 255, None, b"\x01\x02"),
            "Pf": mk._pfm(b"Pf", np.ones((1, 2), np.float32), -1.0),
            "PF": mk._pfm(b"PF", np.ones((1, 2, 3), np.float32), -1.0),
            "sun": mk._sun(3, 1, 8, b"\x01\x02\x03\x00"),
            "hdr": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n"
                   + bytes(8)}[magic]
    src = data if ext is None else str(tmp_path / f"a{ext}")
    if ext is not None:
        (tmp_path / f"a{ext}").write_bytes(data)
    pillow = magic in ("P5", "Pf", "sun")
    assert cvread.reader(None if ext is None else src, pillow) == \
        _plugin(src)


@pytest.mark.parametrize("value", [
    0.5, 1.5, 2.5, 254.5, 255.5, 256.0, -0.4, -0.5, -0.6, 127.49999,
    0.49999997, 1.4999999, 2147483520.0, 2147483648.0, 3e9, -3e9, 1e30,
    float("nan"), float("inf"), float("-inf")])
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_float_to_byte_is_opencvs(value, scale, tmp_path):
    """OpenCV's convertTo: half to even, saturated, and 0 wherever the
    product does not fit an int32."""
    v = np.array([[value * scale]], np.float32)
    path = tmp_path / "a.pfm"
    path.write_bytes(mk._pfm(b"Pf", v, -scale))
    want = iio.imread(path)
    assert cvread.to_u8(v, None if scale == 1.0 else 1.0 / scale).tolist() \
        == want.tolist()


@pytest.mark.parametrize("name,data,match", [
    ("a.pam", mk._pam(1, 1, 2, 255, b"GRAYSCALE_ALPHA", b"\x01\x02"),
     "tuple type GRAYSCALE_ALPHA"),
    ("a.pam", mk._pam(1, 1, 4, 255, b"RGB_ALPHA", b"\x01\x02\x03\x04"),
     "tuple type RGB_ALPHA"),
    ("a.pfm", mk._pnm(b"P5", 2, 1, 255, b"\x01\x02"),
     r"a \*.pfm path holding P5"),
    ("a.pfm", mk._pnm(b"P6", 1, 1, 255, b"\x01\x02\x03"),
     r"a \*.pfm path holding P6"),
])
def test_what_opencv_leaves_undefined_is_refused_by_name(name, data, match,
                                                         tmp_path):
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=match):
        check_header(str(path), format_of(str(path)))
    with pytest.raises(NotImplementedError, match=match):
        read_raster(str(path))


def test_another_format_at_an_opencv_path_is_refused(tmp_path):
    """imageio reads a *.hdr, *.pic or *.sr path through OpenCV whatever it
    holds; OpenCV's reading of another format is not the port's."""
    path = tmp_path / "a.hdr"
    path.write_bytes(mk.png_bytes(np.zeros((2, 2), np.uint8), 8, 0))
    assert _plugin(str(path)) == "opencv"
    with pytest.raises(NotImplementedError, match=r"a \*.hdr path through"):
        format_of(str(path))

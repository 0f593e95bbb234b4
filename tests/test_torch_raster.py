"""terrain_tpu_torch's raster input path (TERRAIN_RASTER, TERRAIN_EPOCH_CROPS)
against terrain_tpu's on the CPU: the crop iterator cuts the same crops
from the same seed, byte for byte (both draw their offsets from
`np.random.RandomState`); the three host helpers give the JAX package's
native library's bytes; the port's PNG decoder undoes every filter type as
its per-byte plain version does and reads other encoders' files;
`_get_data` gives terrain_tpu's first batches from the same PNG pair, a
lossy WebP texture with 16-bit PGM heights and a TGA pair; a JPEG, TIFF,
BMP, WebP (an animation's first frame too), PNM (PFM and PAM too), TGA,
JPEG 2000, Radiance, Sun raster or DDS is decoded (tests/test_torch_jpeg.py,
test_torch_tiff.py, test_torch_bmp.py, test_torch_webp.py,
test_torch_pnm_tga.py, test_torch_jp2.py, test_torch_opencv_rasters.py and
test_torch_dds_sun.py hold the decoders), a GIF and the variants the port
does not take refused by name before either file is decoded; and
smoke_synthetic trains from a raster through the CLI.
Rasters are a few hundred pixels a side.
"""

import math
import os
import zlib

import numpy as np
import pytest

from terrain_tpu.data import native as jnative
from terrain_tpu.data.crops import RasterCropIterator as JRasterCropIterator
from terrain_tpu_torch import cli, experiments
from terrain_tpu_torch.data import RasterCropIterator, native
from terrain_tpu_torch.serve import png
from terrain_tpu_torch.train.losses import TRAIN_KEYS
from tiny_cfg import csv_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _half_ocean(rng, size=600, dtype=np.uint8, hi=255):
    """tests/test_native_crops.py's raster: the left half ocean (zeros),
    the right half land, and a random texture."""
    hm = np.zeros((size, size), dtype)
    hm[:, size // 2:] = rng.randint(1, hi, size=(size, size // 2))
    tex = rng.randint(0, 255, size=(size, size, 3)).astype(np.uint8)
    return hm, tex


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dtype,hi", [(np.uint8, 255), (np.uint16, 65535)])
def test_crops_equal_terrain_tpus(rng, seed, dtype, hi):
    """Byte-equal crops and equal normalized batches for the same seed,
    through the ocean filter; a uint16 heightmap wraps modulo 256 in both
    (zeros mod 256 then count as ocean too)."""
    hm, tex = _half_ocean(rng, dtype=dtype, hi=hi)
    kw = dict(bs=4, crop=128, epoch_size=8, seed=seed)
    mine, ref = RasterCropIterator(hm, tex, **kw), JRasterCropIterator(
        hm, tex, **kw)
    for _ in range(3):
        (x, y), (jx, jy) = mine.next_uint8(), ref.next_uint8()
        assert x.dtype == np.uint8 and x.shape == (4, 128, 128, 1)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert (native.zero_fraction(x) <= 0.9).all()
    (x, y), (jx, jy) = next(mine), next(ref)
    assert x.dtype == np.float32 and y.shape == (4, 128, 128, 3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert mine.N == ref.N == 8


def test_all_ocean_raises_and_bad_rasters_are_refused():
    hm = np.zeros((300, 300), np.uint8)
    tex = np.zeros((300, 300, 3), np.uint8)
    it = RasterCropIterator(hm, tex, bs=2, crop=64, epoch_size=4,
                            max_tries=3)
    with pytest.raises(RuntimeError, match="non-ocean"):
        next(it)
    assert it.drawn == 3 * 4  # max(need * 2, 4) offsets a try
    with pytest.raises(ValueError, match="differ"):
        RasterCropIterator(hm, tex[:200], bs=2, crop=64)
    with pytest.raises(ValueError, match="window"):
        RasterCropIterator(hm, tex, bs=2, crop=512)


def test_host_helpers_equal_terrain_tpus(rng):
    raster = rng.randint(0, 255, size=(300, 400, 3)).astype(np.uint8)
    ys = rng.randint(0, 300 - 64 + 1, 8)
    xs = rng.randint(0, 400 - 64 + 1, 8)
    got = native.crop_batch_u8(raster, ys, xs, 64)
    np.testing.assert_array_equal(got, jnative.crop_batch_u8(raster, ys, xs,
                                                             64))
    np.testing.assert_array_equal(
        native.crop_batch_u8(raster[..., 0], ys, xs, 64), got[..., :1])
    x = rng.randint(0, 256, size=(3, 16, 16, 3)).astype(np.uint8)
    x[0, :4] = 0
    for gray in (True, False):
        a, b = native.normalize_u8_f32(x, gray), jnative.normalize_u8_f32(
            x, gray)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    # every byte value, both formulas
    every = np.arange(256, dtype=np.uint8)
    for gray in (True, False):
        assert (native.normalize_u8_f32(every, gray).tobytes()
                == jnative.normalize_u8_f32(every, gray).tobytes())
    masks = (rng.rand(5, 7, 9, 1) > rng.rand(5, 1, 1, 1)).astype(np.uint8)
    a, b = native.zero_fraction(masks), jnative.zero_fraction(masks)
    assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("y,x", [(300 - 63, 0), (0, 400 - 63), (-1, 0),
                                 (0, -1)])
def test_a_window_off_the_raster_raises(y, x):
    raster = np.zeros((300, 400, 1), np.uint8)
    with pytest.raises(ValueError, match="leaves"):
        native.crop_batch_u8(raster, np.array([y]), np.array([x]), 64)
    with pytest.raises(AssertionError):  # terrain_tpu refuses it too
        jnative.crop_batch_u8(raster, np.array([y]), np.array([x]), 64)


def _filtered(img, filters):
    """(PNG bytes, inflated data, stride, bpp) of img written with the given
    per-row filter types."""
    data = png.encode_png(img, level=1, filters=filters)
    w, h, depth, _, _ = png.read_header(data)
    bpp = img.shape[-1] * depth // 8
    n = int.from_bytes(data[33:37], "big")
    assert data[37:41] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    return data, raw, w * bpp, bpp


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decoder_undoes_every_filter_as_the_plain_version(rng, channels,
                                                          dtype):
    """Filter types 0-4, each on every row and all five mixed, at 8 and 16
    bits, gray, gray+alpha, RGB, RGBA: the C++ unfilter equals the per-byte
    plain version, and decoding gives the image back."""
    img = rng.randint(0, np.iinfo(dtype).max + 1,
                      size=(9, 13, channels)).astype(dtype)
    for filters in (0, 1, 2, 3, 4, np.arange(9) % 5):
        data, raw, stride, bpp = _filtered(img, filters)
        rows = raw.reshape(9, stride + 1)
        np.testing.assert_array_equal(rows[:, 0],
                                      np.broadcast_to(filters, (9,)))
        np.testing.assert_array_equal(
            png.unfilter(raw, 9, stride, bpp),
            png.unfilter_reference(raw, 9, stride, bpp))
        back = png.decode_png(data)
        assert back.dtype == dtype
        np.testing.assert_array_equal(back, img)
    bad = raw.copy()
    bad[3 * (stride + 1)] = 5
    with pytest.raises(ValueError, match="filter type 5 in row 3"):
        png.unfilter(bad, 9, stride, bpp)
    with pytest.raises(ValueError, match="expected"):
        png.unfilter(raw[:-1], 9, stride, bpp)


@pytest.mark.parametrize("mode,shape,dtype", [
    ("L", (37, 53), np.uint8), ("LA", (37, 53, 2), np.uint8),
    ("RGB", (37, 53, 3), np.uint8), ("RGBA", (37, 53, 4), np.uint8),
    ("I;16", (37, 53), np.uint16)])
def test_decoder_reads_pngs_pil_wrote(rng, mode, shape, dtype):
    """PIL picks its own filter for each row; the decoder reads its files."""
    Image = pytest.importorskip("PIL.Image")
    import io

    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (np.sin(y / 5.0) * np.cos(x / 7.0) + 1) * 0.5  # mixes filters
    img = smooth.reshape(smooth.shape + (1,) * (len(shape) - 2))
    img = img + 0.2 * rng.rand(*shape)
    img = (img / img.max() * np.iinfo(dtype).max).astype(dtype)
    buf = io.BytesIO()
    pil = Image.fromarray(img)
    assert pil.mode == mode
    pil.save(buf, format="PNG")
    got = png.decode_png(buf.getvalue())
    np.testing.assert_array_equal(got.reshape(shape), img)


def _write_pair(tmp_path, rng, size=(160, 200), hm_dtype=np.uint8):
    h, w = size
    hm = np.zeros((h, w), hm_dtype)
    hm[:, w // 3:] = rng.randint(1, np.iinfo(hm_dtype).max,
                                 size=(h, w - w // 3))
    tex = rng.randint(0, 256, size=(h, w, 4)).astype(np.uint8)  # RGBA
    rows = np.arange(h) % 5
    hp, tp = tmp_path / "hm.png", tmp_path / "tex.png"
    hp.write_bytes(png.encode_png(hm, level=1, filters=rows))
    tp.write_bytes(png.encode_png(tex, level=1, filters=rows))
    return f"{hp},{tp}", hm, tex


def _write_other_pair(tmp_path, rng, kind):
    """A raster pair in other formats, as Pillow writes them: "webp_pgm16"
    a lossy WebP texture with 16-bit PGM heights (int32 from imageio),
    "tga" an 8-bit gray TGA heightmap with a run-length RGB texture."""
    from PIL import Image

    h, w = 160, 200
    hm = np.zeros((h, w), np.uint16)
    hm[:, w // 3:] = rng.randint(1, 65535, size=(h, w - w // 3))
    tex = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
    if kind == "webp_pgm16":
        hp, tp = tmp_path / "hm.pgm", tmp_path / "tex.webp"
        Image.fromarray(hm).save(hp, "PPM")
        Image.fromarray(tex).save(tp, "WEBP", quality=80)
    else:
        hp, tp = tmp_path / "hm.tga", tmp_path / "tex.tga"
        Image.fromarray((hm >> 8).astype(np.uint8)).save(hp, "TGA")
        Image.fromarray(tex).save(tp, "TGA", rle=True)
    return f"{hp},{tp}", hp, tp


@pytest.mark.parametrize("hm_dtype", [np.uint8, np.uint16, "webp_pgm16",
                                      "tga"])
def test_get_data_gives_terrain_tpus_first_batches(tmp_path, rng, hm_dtype,
                                                   monkeypatch):
    iio = pytest.importorskip("imageio.v3")
    from terrain_tpu import experiments as jexp

    if isinstance(hm_dtype, str):  # imageio's decodes, as terrain_tpu's
        value, hp, tp = _write_other_pair(tmp_path, rng, hm_dtype)
        hm, tex = iio.imread(hp), iio.imread(tp)
    else:
        value, hm, tex = _write_pair(tmp_path, rng, hm_dtype=hm_dtype)
    got_hm, got_tex = experiments.read_raster_pair(value)
    assert got_hm.dtype == hm.dtype
    np.testing.assert_array_equal(got_hm, hm)
    np.testing.assert_array_equal(got_tex, tex[..., :3])
    for k, v in {"TERRAIN_RASTER": value, "TERRAIN_BS": "2",
                 "TERRAIN_EPOCH_CROPS": "30", "TERRAIN_FAST": "1",
                 "TERRAIN_SYNTHETIC": "1"}.items():
        monkeypatch.setenv(k, v)
    mine = experiments._get_data(64, device="cpu")
    ref = jexp._get_data(64)
    for it, jit, n in zip(mine, ref, (30, 3)):
        assert isinstance(it, RasterCropIterator)  # TERRAIN_FAST ignored
        assert it.N == jit.N == n
        for _ in range(2):
            for a, b in zip(next(it), next(jit)):
                np.testing.assert_array_equal(a, b)


def _pil_save(path, img, fmt, **kw):
    from PIL import Image

    Image.fromarray(img).save(path, fmt, **kw)


@pytest.mark.parametrize("name,fmt", [
    ("b.jpg", "JPEG"),                 # by extension
    ("b.png", "JPEG"),                 # a JPEG's bytes under another name
    ("b.tif", "TIFF"),
    ("b.bmp", "BMP"),
    ("b.webp", "WEBP"),
    ("b.jpg", "WEBP"),                 # a WebP's bytes under another name
    ("b.pgm", "PPM-L"),
    ("b.ppm", "PPM"),
    ("b.pbm", "PPM-1"),                # imageio reads the path via OpenCV
    ("b.tga", "TGA"),
    ("b.jp2", "JPEG2000-jp2"),         # JPEG 2000 by name
    ("b.j2k", "JPEG2000-j2k"),         # a bare codestream by name
    ("b.raster", "JPEG2000-jp2"),      # by the JP2 signature box
    ("b.png", "JPEG2000-j2k"),         # by the codestream's SOC and SIZ
    ("b.webp", "WEBP-animated"),       # an animation's first frame
    ("b.pfm", "CV-pfm"),               # colour floats through OpenCV
    ("b.pgm", "CV-pam"),               # P7 at a *.pgm path: OpenCV
    ("b.hdr", "CV-hdr"),               # Radiance through OpenCV
    ("b.sr", "CV-sr"),                 # a Sun raster's *.sr path: OpenCV
    ("b.ras", "CV-sr"),                # the same bytes at *.ras: Pillow
    ("b.dds", "DDS-DXT1"),             # a DDS through Pillow's BCn
    ("b.raster", "DDS-DXT5"),          # by the DDS magic
])
def test_a_raster_that_is_not_a_png_is_decoded(tmp_path, rng, name, fmt):
    """A JPEG, TIFF, BMP, WebP, PNM (PFM and PAM among them), TGA, JPEG
    2000, Radiance, Sun raster or DDS texture, named so or starting so, is
    decoded by the port's codec to imageio's bytes (for all but a JPEG,
    TIFF or BMP, imageio's decode of the path, as the JAX package reads it,
    through the plugin imageio takes for that name; for an animated WebP,
    its first frame)."""
    iio = pytest.importorskip("imageio.v3")
    from PIL import Image

    value, hm, _ = _write_pair(tmp_path, rng)
    other = tmp_path / name
    tex = rng.randint(0, 256, size=(48, 40, 3)).astype(np.uint8)
    fmt, _, mode = fmt.partition("-")
    if fmt == "CV":  # what OpenCV writes, the texture as floats for PFM
        cv2 = pytest.importorskip("cv2")
        img = {"pfm": tex.astype(np.float32) * 1.25 - 20.0,
               "hdr": tex.astype(np.float32) / 200.0}.get(mode, tex)
        ok, buf = cv2.imencode(".pam" if mode == "pam" else f".{mode}", img)
        assert ok
        other.write_bytes(buf.tobytes())
        fmt = mode = ""
    kw = {"quality": 85} if fmt == "JPEG" else (
        {"compression": "tiff_lzw"} if fmt == "TIFF" else {})
    if fmt == "JPEG2000":  # a 9/7 texture, as a JP2 file or a codestream
        kw, mode = {"irreversible": True, "no_jp2": mode == "j2k"}, ""
    elif mode == "animated":
        kw, mode = {"save_all": True, "append_images": [
            Image.fromarray(tex[::-1])], "quality": 80}, ""
    if fmt == "DDS":
        Image.fromarray(tex).save(other, "DDS", pixel_format=mode)
    elif mode:
        Image.fromarray(tex).convert(mode).save(other, fmt)
    elif fmt:
        _pil_save(other, tex, fmt, **kw)
    got_hm, got_tex = experiments.read_raster_pair(
        f"{value.split(',')[0]},{other}")
    np.testing.assert_array_equal(got_hm, hm)
    if fmt in ("JPEG", "TIFF", "BMP"):
        want = iio.imread(other.read_bytes())
    else:
        want = iio.imread(other)[..., :3]
    assert got_tex.dtype == want.dtype
    np.testing.assert_array_equal(got_tex, want)


def _jp2_with_poc(path):
    """A codestream with a POC marker, a JPEG 2000 feature no fixture
    holds (tests/data/jp2/refused_poc.j2k)."""
    from raster_cases import DATA

    with open(os.path.join(DATA, "jp2", "refused_poc.j2k"), "rb") as f:
        path.write_bytes(f.read())


def _subsampled_ycbcr(path):
    """YCbCr with 2x2 chroma: imageio's tifffile plugin raises at a *.tif
    path ("chroma subsampling not supported")."""
    from raster_cases import script

    path.write_bytes(script().tiff_bytes(
        np.zeros((16, 16, 3), np.uint8), "<", 6, 5,
        more_tags={530: (3, [2, 2])}))


def _fixture(name):
    from raster_cases import DATA

    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _cmyk4(path):
    """CMYK of 4-bit samples, outside Pillow's table of modes."""
    from raster_cases import script

    path.write_bytes(script().tiff_bytes(
        np.zeros((16, 16, 4), np.uint8), photometric=5, bits=4))


@pytest.mark.parametrize("name,make,match", [
    ("b.raster", lambda p: p.write_bytes(b"GIF89a" + bytes(64)),
     "is GIF; imageio gives a GIF a frame axis"),
    ("b.gif", None, "is GIF; imageio gives a GIF a frame axis"),
    ("b.j2k", _jp2_with_poc, "JPEG 2000: POC progression changes"),
    ("b.pam", lambda p: p.write_bytes(
        b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\n"
        b"TUPLTYPE GRAYSCALE_ALPHA\nENDHDR\n\x01\x02"),
     r"PNM: a PAM of tuple type GRAYSCALE_ALPHA"),
    ("b.pfm", lambda p: p.write_bytes(b"P5\n1 1\n255\n\x00"),
     r"PNM: a \*.pfm path holding P5"),
    ("b.hdr", lambda p: _pil_save(p, np.zeros((4, 4, 3), np.uint8), "PNG"),
     r"holds PNG; imageio reads a \*.hdr path through OpenCV"),
    ("b.pbm", lambda p: p.write_bytes(b"P5\n1 1\n255\n\x00"),
     r"PNM: a \*.pbm path holding P5"),
    ("b.tif", lambda p: _pil_save(p, np.zeros((16, 16, 3), np.uint8),
                                  "TIFF", compression="jpeg"),
     r"TIFF: compression 7 \(JPEG\)"),
    ("b.tif", _subsampled_ycbcr, r"TIFF: YCbCr subsampled \(2, 2\)"),
    ("b.tiff", _cmyk4, r"TIFF: CMYK samples \(4, 4, 4, 4\)"),
    ("b.qoi", lambda p: p.write_bytes(_fixture("qoi/width2_refused.qoi")),
     "QOI: a width of 1 or 2 makes Pillow try the file as a GIMP brush"),
    ("b.im", lambda p: p.write_bytes(_fixture("im/lstar12_refused.im")),
     "IM: the 12-bit samples"),
    ("b.ico", lambda p: p.write_bytes(_fixture(
        "ico/dib_top_down_refused.ico")), "ICO: a DIB entry .* top-down"),
])
def test_a_raster_that_is_not_a_png_is_refused(tmp_path, rng, name, make,
                                               match, monkeypatch):
    """What the port does not decode (the test above shows what it does):
    GIF by name and by magic, JPEG-in-TIFF, subsampled YCbCr at a *.tif
    path and 4-bit CMYK by their TIFF headers, a JPEG 2000 POC marker by
    the codestream's main header, a PAM with alpha by its header, a *.pbm
    holding gray and a *.pfm holding P5 by their magic, and a PNG at a
    *.hdr path (which imageio reads through OpenCV) by its magic, a QOI
    of width 2 (which Pillow tries as a GIMP brush first) by its header,
    an IM of Pillow's bit-packed floats by its image type and a top-down
    DIB icon by its entry's header -- NotImplementedError naming them,
    before either file is decoded."""
    value, hm, _ = _write_pair(tmp_path, rng)
    other = tmp_path / name
    if make is not None:
        make(other)
    decoded = []
    from terrain_tpu_torch.data import raster

    for fn in ("read_png", "decode_jpeg", "read_tiff", "decode_bmp",
               "decode_webp"):
        monkeypatch.setattr(raster, fn, lambda *a: decoded.append(1))
    monkeypatch.setattr(raster.pnm, "read_pnm",
                        lambda *a: decoded.append(1))
    monkeypatch.setattr(raster.sun, "read_sun",
                        lambda *a: decoded.append(1))
    for table in ("_DECODERS", "_PATH_DECODERS"):
        monkeypatch.setattr(raster, table, {
            k: (lambda *a, **kw: decoded.append(1))
            for k in getattr(raster, table)})
    with pytest.raises(NotImplementedError, match=match):
        experiments.read_raster_pair(f"{value.split(',')[0]},{other}")
    assert decoded == []  # neither file was decoded
    with pytest.raises(ValueError, match="heightmap.png,texture.jpg"):
        experiments.read_raster_pair(value.split(",")[0])


def _cmyk(path, rng):
    from PIL import Image

    Image.fromarray(rng.randint(0, 256, (48, 40, 4)).astype(np.uint8),
                    "CMYK").save(path, "TIFF")


def test_a_cmyk_tiff_texture_is_read_as_imageio_reads_its_path(tmp_path,
                                                               rng):
    """A CMYK texture named *.tiff: its samples as stored, as imageio's
    tifffile plugin (the JAX package's reader) gives them, the first
    three kept as for any texture."""
    iio = pytest.importorskip("imageio.v3")
    value, hm, _ = _write_pair(tmp_path, rng)
    other = tmp_path / "b.tiff"
    _cmyk(other, rng)
    got_hm, got_tex = experiments.read_raster_pair(
        f"{value.split(',')[0]},{other}")
    np.testing.assert_array_equal(got_hm, hm)
    want = iio.imread(other)
    assert want.shape == (48, 40, 4) and got_tex.dtype == want.dtype
    np.testing.assert_array_equal(got_tex, want[..., :3])


@pytest.mark.parametrize("which", ["heightmap", "texture"])
def test_a_gif_pair_fails_in_terrain_tpu_and_is_refused_here(
        tmp_path, rng, which, monkeypatch):
    """imageio gives a GIF a frame axis, which terrain_tpu's crop iterator
    asserts against; the port refuses the file by name."""
    pytest.importorskip("imageio")
    from terrain_tpu import experiments as jexp

    value, hm, tex = _write_pair(tmp_path, rng)
    gif = tmp_path / f"{which}.gif"
    _pil_save(gif, hm if which == "heightmap" else tex[..., :3], "GIF")
    paths = value.split(",")
    paths[0 if which == "heightmap" else 1] = str(gif)
    monkeypatch.setenv("TERRAIN_RASTER", ",".join(paths))
    monkeypatch.setenv("TERRAIN_BS", "2")
    monkeypatch.setenv("TERRAIN_EPOCH_CROPS", "4")
    with pytest.raises(AssertionError):
        jexp._get_data(64)
    with pytest.raises(NotImplementedError, match="is GIF"):
        experiments._get_data(64, device="cpu")


def test_smoke_synthetic_trains_from_a_raster(tmp_path, rng, monkeypatch):
    value, _, _ = _write_pair(tmp_path, rng)
    for k, v in {"TERRAIN_RASTER": value, "TERRAIN_EPOCH_CROPS": "8",
                 "TERRAIN_EPOCHS": "1", "TERRAIN_QUICK": "1",
                 "TERRAIN_OUT": str(tmp_path / "out"),
                 "TERRAIN_MODELS": str(tmp_path / "models")}.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["smoke_synthetic", "train", "--device", "cpu"]) == 0
    (row,) = csv_rows(str(tmp_path / "out" / "smoke_synthetic"
                          / "results.txt"))
    for s in ("train", "valid"):
        for k in TRAIN_KEYS:
            assert math.isfinite(float(row[f"{s}_{k}"])), (s, k)


def test_decoding_without_a_host_compiler_raises(tmp_path, rng, monkeypatch):
    """No quiet per-byte path: without the C++ unfilter decoding raises."""
    from terrain_tpu_torch.ops.kernels import _build

    data = png.encode_png(rng.randint(0, 256, (5, 6, 3)).astype(np.uint8))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    png._unfilter_fn.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            png.decode_png(data)
    finally:
        png._unfilter_fn.cache_clear()

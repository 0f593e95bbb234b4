"""The port's TIFF decoder (terrain_tpu_torch/data/tiff.py and the host C++
of data/csrc/raster_decode.cpp) against imageio, which decodes through
Pillow and libtiff (the JAX package's reader): every committed fixture of
tests/data/tiff (tests/make_raster_fixtures.py) to imageio's shape, dtype
and SHA-256, more layouts made here, the kinds it refuses by name, damaged
files, a TIFF pair's crops against terrain_tpu's `_get_data`, and the
full-width strips repeated as chip_smoke.py repeats them.  Images are a
few dozen pixels a side (the strips 21600 x 32)."""

import os

import numpy as np
import pytest

from raster_cases import (DATA, check_fixture, digests, rerun,
                          same_first_batches, script, summary)
from terrain_tpu_torch.data import tiff
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
mk = script()


@pytest.mark.parametrize("name", sorted(digests("tiff")))
def test_each_fixture_decodes_to_imageios_array(name):
    check_fixture("tiff", name, tiff.decode_tiff)


def _image(h, w, s, dtype, seed):
    rnd = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return rnd.randn(h, w, s).astype(dtype)
    info = np.iinfo(dtype)
    return rnd.randint(info.min, int(info.max) + 1, (h, w, s)).astype(dtype)


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("layout", [
    dict(rows_per_strip=3), dict(tile=(16, 16)), dict(tile=(32, 16)),
    dict(rows_per_strip=5, planar=2), dict(tile=(16, 32), planar=2)])
@pytest.mark.parametrize("compression,predictor", [
    (1, 1), (5, 1), (5, 2), (8, 2), (32946, 1), (32773, 1)])
def test_layouts_decode_to_imageios_array(bo, layout, compression,
                                          predictor):
    """RGB at 8 bits in every layout, order, compression and predictor."""
    img = _image(23, 35, 3, np.uint8, 7)
    img[:, :17] //= 8  # runs for PackBits and LZW
    data = mk.tiff_bytes(img, bo, 2, compression, predictor, **layout)
    want = iio.imread(data)
    assert summary(tiff.decode_tiff(data)) == summary(want)


@pytest.mark.parametrize("kind", ["gray16", "int16", "float32", "rgb16"])
@pytest.mark.parametrize("bo", ["<", ">"])
def test_wide_samples_decode_to_imageios_array(kind, bo):
    """16- and 32-bit samples with their predictors, either byte order."""
    img = {"gray16": _image(19, 33, 1, np.uint16, 1),
           "int16": _image(19, 33, 1, np.int16, 2),
           "float32": _image(19, 33, 1, np.float32, 3),
           "rgb16": _image(19, 33, 3, np.uint16, 4)}[kind]
    sf = {"int16": 2, "float32": 3}.get(kind)
    photometric = 2 if kind == "rgb16" else 1
    for comp, pred in ((5, 3 if kind == "float32" else 2), (8, 1)):
        data = mk.tiff_bytes(img, bo, photometric, comp, pred,
                             rows_per_strip=4, sample_format=sf)
        assert summary(tiff.decode_tiff(data)) == summary(iio.imread(data))


def test_lzw_codes_of_every_width_and_clear_codes():
    """An image long enough that the codes reach 12 bits and the table is
    cleared several times, by the fixture script's encoder and Pillow's
    (libtiff's)."""
    from PIL import Image
    import io

    rnd = np.random.RandomState(0)
    img = rnd.randint(0, 256, (120, 700)).astype(np.uint8)
    img[:60] //= 16
    for data in (mk.tiff_bytes(img, compression=5, rows_per_strip=60),
                 mk._pillow(Image.fromarray(img), "TIFF",
                            compression="tiff_lzw")):
        np.testing.assert_array_equal(tiff.decode_tiff(data), img)


def test_one_thread_gives_the_same_array(monkeypatch):
    data = mk.tiff_bytes(_image(64, 40, 3, np.uint8, 5), ">", 2, 5, 2,
                         rows_per_strip=2)
    many = tiff.decode_tiff(data)
    monkeypatch.setattr(tiff, "_THREADS", 1)
    np.testing.assert_array_equal(tiff.decode_tiff(data), many)


def _patched(tags):
    img = _image(8, 8, 3, np.uint8, 0)
    return mk.tiff_bytes(img, photometric=2, more_tags={
        k: (3, [v]) for k, v in tags.items()})


def _refused():
    from PIL import Image
    import io

    def pil(mode, **kw):
        buf = io.BytesIO()
        Image.new(mode, (8, 8)).save(buf, "TIFF", **kw)
        return buf.getvalue()

    return {
        "JPEG": (pil("RGB", compression="jpeg"), r"compression 7 \(JPEG\)"),
        "old-style JPEG": (_patched({259: 6}),
                           r"compression 6 \(old-style JPEG\)"),
        "JPEG 2000": (_patched({259: 34712}),
                      r"compression 34712 \(JPEG 2000\)"),
        "CCITT": (_patched({259: 4}), r"compression 4 \(CCITT Group 4\)"),
        # BigTIFF, CMYK, YCbCr and CIELab are read; their kinds that stay
        # refused: JPEG in a BigTIFF, 4-bit CMYK, compressed YCbCr with
        # subsampled chroma, 16-bit CIELab
        "BigTIFF": (mk.tiff_bytes(_image(8, 8, 3, np.uint8, 0), "<", 2, 7,
                                  big=True), r"compression 7 \(JPEG\)"),
        "CMYK": (mk.tiff_bytes(_image(8, 8, 4, np.uint8, 0) >> 4,
                               photometric=5, bits=4),
                 r"CMYK samples \(4, 4, 4, 4\)"),
        "YCbCr": (mk.tiff_bytes(_image(8, 8, 3, np.uint8, 0), "<", 6, 5,
                                more_tags={530: (3, [2, 2])}),
                  r"subsampled \(2, 2\)"),
        "CIELab": (mk.tiff_bytes(_image(8, 8, 3, np.uint16, 0),
                                 photometric=8), r"CIELab samples"),
        "two extra samples": (mk.tiff_bytes(
            _image(4, 4, 2, np.uint8, 1), extra=(0,)),
            "min-is-black samples"),
    }


@pytest.mark.parametrize("kind", list(_refused()))
def test_other_kinds_are_refused_by_name(kind):
    data, match = _refused()[kind]
    with pytest.raises(NotImplementedError, match=match):
        tiff.read_header(data)
    with pytest.raises(NotImplementedError, match=match):
        tiff.decode_tiff(data)


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _both_routes(tmp_path, data, name="x.tif"):
    """The port's arrays against imageio's, from the bytes (Pillow) and at a
    *.tif path (imageio's tifffile plugin)."""
    path = _write(tmp_path, name, data)
    assert summary(tiff.decode_tiff(data)) == summary(
        iio.imread(data, plugin="pillow"))
    assert summary(tiff.imread_like(path)) == summary(iio.imread(path))


@pytest.mark.parametrize("layout", [dict(rows_per_strip=5),
                                    dict(tile=(16, 32)),
                                    dict(rows_per_strip=4, planar=2)])
@pytest.mark.parametrize("compression,predictor", [
    (1, 1), (5, 2), (8, 1), (32773, 1)])
@pytest.mark.parametrize("bo", ["<", ">"])
def test_bigtiff_layouts_read_as_imageio_reads_them(bo, layout, compression,
                                                    predictor, tmp_path):
    """BigTIFF (20-byte entries, LONG8 offsets and counts) in every layout
    and compression.  Pillow cannot open a big-endian one ('Missing
    dimensions'): from bytes the port raises OSError as Pillow does; at a
    *.tif path both byte orders read as imageio's tifffile plugin reads
    them."""
    img = _image(21, 37, 3, np.uint8, 11)
    img[:, :20] //= 16
    data = mk.tiff_bytes(img, bo, 2, compression, predictor, big=True,
                         **layout)
    if bo == "<":
        _both_routes(tmp_path, data)
    else:
        with pytest.raises(OSError):
            iio.imread(data, plugin="pillow")
        with pytest.raises(OSError, match="big-endian BigTIFF"):
            tiff.decode_tiff(data)
        path = _write(tmp_path, "x.tif", data)
        assert summary(tiff.imread_like(path)) == summary(iio.imread(path))


@pytest.mark.parametrize("mode", ["CMYK", "YCbCr", "LAB"])
@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("layout", [dict(rows_per_strip=6),
                                    dict(tile=(16, 16))])
def test_cmyk_ycbcr_and_lab_read_as_imageio_reads_them(mode, bo, layout,
                                                       tmp_path):
    """LZW with predictor 2 in either byte order, strips and tiles: the
    samples as stored at a *.tif path; through Pillow CMYK and CIELab as
    stored, YCbCr (subsampling 1, 1) converted to RGB by libtiff's tables
    (YCbCr in tiles is refused on that route)."""
    from PIL import Image

    rgb = mk.terrain(23, 41, 9)
    samples = np.asarray(Image.fromarray(rgb).convert(mode))
    photo = {"CMYK": 5, "YCbCr": 6, "LAB": 8}[mode]
    tags = {530: (3, [1, 1])} if mode == "YCbCr" else None
    data = mk.tiff_bytes(samples, bo, photo, 5, 2, more_tags=tags, **layout)
    if mode == "YCbCr" and "tile" in layout:
        path = _write(tmp_path, "x.tif", data)
        assert summary(tiff.imread_like(path)) == summary(iio.imread(path))
        with pytest.raises(NotImplementedError, match="tiles or planes"):
            tiff.decode_tiff(data)
    else:
        _both_routes(tmp_path, data)


def test_ycbcr_to_rgb_is_libtiffs_for_every_value():
    """Every (Y, Cb, Cr) of 8 bits, deflated, converted through Pillow
    (libtiff's TIFFYCbCrtoRGB) and by the port, with the default
    ReferenceBlackWhite and a studio-range one and other luma weights."""
    v = np.arange(256 ** 3, dtype=np.uint32)
    ycc = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    for tags in ({530: (3, [1, 1])},
                 {530: (3, [1, 1]),
                  529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                  532: (5, [(16, 1), (235, 1), (128, 1), (240, 1),
                            (128, 1), (240, 1)])}):
        data = mk.tiff_bytes(ycc, "<", 6, 8, rows_per_strip=512,
                             more_tags=tags)
        np.testing.assert_array_equal(tiff.decode_tiff(data),
                                      iio.imread(data, plugin="pillow"))


def test_subsampled_ycbcr_as_imageio_meets_it(tmp_path):
    """2x2 subsampled YCbCr: imageio's tifffile plugin raises
    NotImplementedError at a *.tif path and the port refuses it by name;
    from bytes Pillow reads an uncompressed one 4 bytes a pixel and raises
    at the file's end (the port too), and a compressed one is refused."""
    ycc = _image(32, 40, 3, np.uint8, 4)  # 4 bytes a pixel reach the end
    tags = {530: (3, [2, 2])}
    for comp in (1, 5):
        data = mk.tiff_bytes(ycc, "<", 6, comp, more_tags=tags)
        path = _write(tmp_path, f"sub{comp}.tif", data)
        with pytest.raises(NotImplementedError, match="chroma subsampling"):
            iio.imread(path)
        with pytest.raises(NotImplementedError, match="chroma subsampling"):
            tiff.imread_like(path)
        with pytest.raises(NotImplementedError, match="chroma subsampling"):
            tiff.read_header(path, "tifffile")
        if comp == 1:
            with pytest.raises(OSError, match="truncated"):
                iio.imread(data, plugin="pillow")
            with pytest.raises(OSError, match="truncated"):
                tiff.decode_tiff(data)
        else:
            with pytest.raises(NotImplementedError, match="subsampled"):
                tiff.decode_tiff(data)


def test_uncompressed_ycbcr_is_read_four_bytes_a_pixel_as_pillow_does():
    """Where the bytes after a strip reach far enough, Pillow's RGBX raw
    mode reads them as pixels (no error): the port gives the same bytes."""
    ycc = _image(6, 9, 3, np.uint8, 5)
    data = mk.tiff_bytes(ycc, "<", 6, 1, rows_per_strip=2,
                         more_tags={530: (3, [1, 1])})
    data = data[:8] + data[8:] + bytes(512)  # room past the IFD
    np.testing.assert_array_equal(tiff.decode_tiff(data),
                                  iio.imread(data, plugin="pillow"))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["rgb8_lzw", "gray16_none", "bool_lzw",
                                  "float32_deflate"])
def test_orientation_as_imageio_reads_it(orientation, kind, tmp_path):
    """Orientation 1-8: stored at a *.tif path, transposed through Pillow
    (exif_transpose), and read_header's size along each route."""
    img = {"rgb8_lzw": _image(13, 22, 3, np.uint8, 1),
           "gray16_none": _image(13, 22, 1, np.uint16, 2),
           "bool_lzw": _image(13, 22, 1, np.uint8, 3) >> 7,
           "float32_deflate": _image(13, 22, 1, np.float32, 4)}[kind]
    comp = {"lzw": 5, "none": 1, "deflate": 8}[kind.split("_")[1]]
    data = mk.tiff_bytes(img, "<", 2 if img.shape[-1] == 3 else 1, comp,
                         bits=1 if kind.startswith("bool") else None,
                         sample_format=3 if kind.startswith("float") else
                         None, more_tags={274: (3, [orientation])})
    _both_routes(tmp_path, data)
    h, w = (22, 13) if orientation >= 5 else (13, 22)
    assert tiff.read_header(data)[:2] == (h, w)
    assert tiff.read_header(data, "tifffile")[:2] == (13, 22)


def test_jpeg_in_tiff_is_read_by_neither_package_at_its_path(tmp_path):
    """imageio reads JPEG in TIFF from bytes (Pillow, libtiff) but not at a
    *.tif path (its tifffile plugin: "cannot decompress JPEG"), which is
    how the JAX package reads TERRAIN_RASTER: the port refuses it by name
    on both routes, and read_raster before any pixel is decoded."""
    from terrain_tpu_torch.data import raster

    path = DATA + "/tiff/pillow_jpeg_refused.tif"
    with pytest.raises(ValueError, match="cannot decompress JPEG"):
        iio.imread(path)
    with open(path, "rb") as f:
        data = f.read()
    assert iio.imread(data).shape == (29, 37, 3)
    for read in (lambda: tiff.decode_tiff(data),
                 lambda: tiff.imread_like(path),
                 lambda: raster.check_header(path, "TIFF")):
        with pytest.raises(NotImplementedError,
                           match=r"compression 7 \(JPEG\).*cannot "
                                 r"decompress it either"):
            read()


def test_damaged_files_raise_value_error(tmp_path):
    img = _image(16, 16, 3, np.uint8, 2)
    good = mk.tiff_bytes(img, photometric=2, compression=5,
                         rows_per_strip=8)
    bo, tags = tiff._ifd(good)
    first, n = tags[273][0], tags[279][0]
    bad = bytearray(good)
    bad[first:first + n] = bytes([0x80, 0]) + bytes([0xFF] * (n - 2))
    with pytest.raises(ValueError, match="LZW"):
        tiff.decode_tiff(bytes(bad))
    # a strip cut short, and a strip past the file's end
    with pytest.raises(ValueError, match="holds 1 of its 384 bytes"):
        tiff.decode_tiff(mk.tiff_bytes(img, photometric=2, rows_per_strip=8,
                                       more_tags={279: (4, [1, 1])}))
    with pytest.raises(ValueError, match="past the file's end"):
        tiff.decode_tiff(mk.tiff_bytes(img, photometric=2, rows_per_strip=8,
                                       more_tags={279: (4, [384, 10**6])}))
    with pytest.raises(ValueError, match="not a TIFF"):
        tiff.decode_tiff(b"not a tiff at all" * 4)
    empty = tmp_path / "e.tif"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        tiff.decode_tiff(str(empty))


@pytest.mark.parametrize("hm_kind,tex_kind", [
    ("gray16_lzw_pred2_be.tif", "rgb8_lzw_pred2_strips_le.tif"),
    ("float32_lzw_pred3_le.tif", "rgba8_lzw_extra2_le.tif"),
    ("gray1_lzw_le.tif", "rgb16_deflate_tiles_be.tif"),
    ("palette8_lzw_le.tif", "rgbx8_packbits_le.tif"),
    ("gray2_minwhite_lzw_be.tif", "rgba8_deflate_extra1_le.tif")])
def test_a_tiff_pair_gives_terrain_tpus_crops(hm_kind, tex_kind, tmp_path,
                                              monkeypatch):
    """Bigger rasters of the fixtures' kinds, named *.tif as a user names
    them: the port's first batches are terrain_tpu's, which reads them
    through imageio's tifffile plugin (uint16 wrapped, float32 truncated,
    bool as 0/1, a palette's indices, 2-bit and min-is-white values as
    stored, 16-bit colour wrapped, associated alpha undivided)."""
    rnd = np.random.RandomState(3)
    h, w = 150, 190
    tex = mk.terrain(h, w, 21, 4)
    land = tex[..., 0] > 40
    hms = {"gray16_lzw_pred2_be.tif": lambda: mk.tiff_bytes(
               np.where(land, rnd.randint(1, 255, (h, w)) + 256 * 7, 0)
               .astype(np.uint16), ">", 1, 5, 2),
           "float32_lzw_pred3_le.tif": lambda: mk.tiff_bytes(
               np.where(land, rnd.rand(h, w) * 250 + 1, 0).astype(
                   np.float32), compression=5, predictor=3,
               sample_format=3),
           "gray1_lzw_le.tif": lambda: mk.tiff_bytes(
               land.astype(np.uint8), compression=5, bits=1),
           "palette8_lzw_le.tif": lambda: mk.tiff_bytes(
               np.where(land, tex[..., 2], 0), photometric=3,
               compression=5, colormap=rnd.randint(0, 65536, (256, 3))),
           "gray2_minwhite_lzw_be.tif": lambda: mk.tiff_bytes(
               np.where(land, 1 + tex[..., 2] % 3, 0), ">", 0, 5,
               bits=2)}
    texs = {"rgb8_lzw_pred2_strips_le.tif": lambda: mk.tiff_bytes(
                tex[..., :3], photometric=2, compression=5, predictor=2,
                rows_per_strip=16),
            "rgba8_lzw_extra2_le.tif": lambda: mk.tiff_bytes(
                tex, photometric=2, compression=5, extra=(2,),
                rows_per_strip=16),
            "rgb16_deflate_tiles_be.tif": lambda: mk.tiff_bytes(
                tex[..., :3].astype(np.uint16) * 300, ">", 2, 8,
                tile=(32, 48)),
            "rgbx8_packbits_le.tif": lambda: mk.tiff_bytes(
                tex, photometric=2, compression=32773, extra=(0,)),
            "rgba8_deflate_extra1_le.tif": lambda: mk.tiff_bytes(
                tex, photometric=2, compression=8, extra=(1,))}
    hp, tp = tmp_path / "hm.tif", tmp_path / "tex.TIFF"
    hp.write_bytes(hms[hm_kind]())
    tp.write_bytes(texs[tex_kind]())
    same_first_batches(f"{hp},{tp}", monkeypatch)


def test_a_planar_tiff_fails_in_terrain_tpu_and_not_in_the_port(
        tmp_path, monkeypatch):
    """imageio's tifffile plugin gives a planar *.tif as (S, H, W), which
    terrain_tpu's crop iterator asserts against; read_raster gives the same
    array, and the port's iterator refuses it as well."""
    from terrain_tpu import experiments as jexp
    from terrain_tpu_torch import experiments

    tex = mk.terrain(120, 130, 4, 3)
    hp, tp = tmp_path / "hm.tif", tmp_path / "tex.tif"
    hp.write_bytes(mk.tiff_bytes(tex[..., 0], compression=5))
    tp.write_bytes(mk.tiff_bytes(tex, photometric=2, compression=5,
                                 planar=2))
    assert summary(tiff.imread_like(tp)) == summary(iio.imread(tp))
    assert tiff.imread_like(tp).shape == (3, 120, 130)
    # by bytes (Pillow), the same file is interleaved
    assert tiff.decode_tiff(tp.read_bytes()).shape == (120, 130, 3)
    monkeypatch.setenv("TERRAIN_RASTER", f"{hp},{tp}")
    with pytest.raises(AssertionError):
        jexp._get_data(64)
    with pytest.raises(ValueError, match="differ in size"):
        experiments._get_data(64, device="cpu")


def test_the_full_width_strips_repeat_as_chip_smoke_repeats_them(tmp_path):
    """chip_smoke.py's `_tiff_repeat` turns each committed strip into a
    taller file (here 64 rows) whose every band is the strip's band, and
    imageio reads the same array from it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(DATA), "..",
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in (cs.TIFF_TEXTURE_STRIP, cs.TIFF_HEIGHT_STRIP):
        with open(os.path.join(DATA, "tiff", name), "rb") as f:
            strip_bytes = f.read()
        big, rps, kinds = cs._tiff_repeat(strip_bytes, 64)
        assert kinds == 4 and rps == 8
        path = tmp_path / name
        path.write_bytes(big)
        got = tiff.decode_tiff(str(path))
        assert summary(got) == summary(iio.imread(big))
        strip = tiff.decode_tiff(strip_bytes)
        for r in range(8):
            k = r % kinds
            np.testing.assert_array_equal(got[r * 8:(r + 1) * 8],
                                          strip[k * 8:(k + 1) * 8])


def test_decoding_without_a_host_compiler_raises(tmp_path, monkeypatch):
    """No quiet Python path: without the C++ library decoding raises."""
    from terrain_tpu_torch.ops.kernels import _build

    data = mk.tiff_bytes(_image(4, 4, 3, np.uint8, 0), photometric=2)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    tiff._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            tiff.decode_tiff(data)
    finally:
        tiff._lib.cache_clear()


def test_committed_fixtures_match_the_script(tmp_path):
    rerun("tiff", tmp_path)

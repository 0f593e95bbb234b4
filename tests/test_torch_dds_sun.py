"""The DDS and Sun raster decoders (terrain_tpu_torch/data/dds.py and
data/sun.py, with data/csrc/raster_decode.cpp's bcn_decode and sun_rle)
against imageio, which reads both through Pillow (a Sun raster at a *.sr
path through OpenCV, tests/test_torch_opencv_rasters.py): every committed
fixture of tests/data/dds and tests/data/sun (tests/make_raster_fixtures.py)
to imageio's shape, dtype and SHA-256 from its bytes and its path, files
Pillow writes here, seeded random BC1-BC7 blocks (every BC6H and BC7 mode),
channel masks, Sun rasters of every depth and type, files cut at many
offsets, the thread count, what is refused by name, and a PFM/DDS pair's
first batches against terrain_tpu's `_get_data`.  Images are a few dozen
pixels a side."""

import io

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, rerun, same_first_batches,
                          script, summary)
from terrain_tpu_torch.data import dds, sun
from terrain_tpu_torch.data.raster import read_raster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()


def _pillow(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "DDS", **kw)
    return buf.getvalue()


def _same_or_value_error(decode, src):
    try:
        want = iio.imread(src)
    except Exception:  # noqa: BLE001 -- imageio raises many kinds
        with pytest.raises(ValueError):
            decode(src)
        return 0
    assert summary(decode(src)) == summary(want)
    return 1


@pytest.mark.parametrize("name", sorted(digests("dds")))
def test_each_dds_fixture_decodes_to_imageios_array(name):
    check_fixture("dds", name, dds.decode_dds)


@pytest.mark.parametrize("name", sorted(digests("sun")))
def test_each_sun_fixture_decodes_to_imageios_array(name):
    check_fixture("sun", name, sun.decode_sun)


@pytest.mark.parametrize("kind", ["dds", "sun"])
def test_committed_fixtures_match_the_script(kind, tmp_path):
    rerun(kind, tmp_path)


@pytest.mark.parametrize("fmt", ["RGBA", "RGB", "L", "LA", "DXT1", "DXT3",
                                 "DXT5", "BC2", "BC3", "BC5"])
@pytest.mark.parametrize("size", [(4, 4), (5, 7), (17, 10), (1, 1)])
def test_pillows_dds_files_decode_as_imageio(fmt, size, tmp_path):
    w, h = size
    img = Image.fromarray(mk.terrain(h, w, w * h, 4))
    if fmt in ("RGBA", "RGB", "L", "LA"):
        data = _pillow(img.convert(fmt))
    else:
        data = _pillow(img.convert("RGB") if fmt == "BC5" else img,
                       pixel_format=fmt)
    path = tmp_path / "a.dds"
    path.write_bytes(data)
    assert summary(dds.decode_dds(data)) == summary(iio.imread(data))
    assert summary(read_raster(str(path))) == summary(iio.imread(path))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["BC1", "BC2", "BC3", "BC4", "BC5",
                                  "BC5_SNORM", "BC6H_UF16", "BC6H_SF16",
                                  "BC7"])
def test_random_blocks_decode_as_pillow(kind, seed):
    """Seeded random blocks through the DX10 header: any 16 bytes are a
    BC6H or BC7 block, and each reaches every mode (reserved ones too)."""
    rnd = np.random.RandomState(seed)
    w, h = int(rnd.randint(1, 40)), int(rnd.randint(1, 20))
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    body = mk._bc_blocks(rnd, nb, "BC6H" if kind.startswith("BC6H")
                         else kind.split("_")[0])
    data = mk._dds(w, h, body, dxgi=mk._DXGI[kind])
    assert summary(dds.decode_dds(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("fourcc", [b"DXT1", b"DXT3", b"DXT5", b"ATI1",
                                    b"BC4U", b"ATI2", b"BC5U", b"BC5S"])
def test_fourcc_blocks_decode_as_pillow(fourcc):
    rnd = np.random.RandomState(len(fourcc) + fourcc[3])
    w, h = 21, 11
    size = 8 if fourcc in (b"DXT1", b"ATI1", b"BC4U") else 16
    body = rnd.randint(0, 256, 6 * 3 * size).astype(np.uint8).tobytes()
    data = mk._dds(w, h, body, fourcc=fourcc)
    assert summary(dds.decode_dds(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("bits,masks,flags", [
    (16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
    (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
    (16, (0xF00, 0xF0, 0xF, 0xF000), 0x41),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 0x41),
    (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 0x41),
    (24, (0xFF, 0xFF00, 0xFF0000, 0), 0x40),
    (16, (0xA5, 0x5A00, 0, 0), 0x40),
    (8, (0xE0, 0x1C, 0x3, 0), 0x40)])
def test_uncompressed_masks_decode_as_pillow(bits, masks, flags):
    """Each channel int(v / (mask >> shift) * 255); a surface cut short
    reads as zeros, as Pillow's decoder reads it."""
    rnd = np.random.RandomState(bits + flags)
    w, h = 13, 7
    px = rnd.randint(0, 256, w * h * bits // 8).astype(np.uint8).tobytes()
    for body in (px, px[:len(px) // 2 + 1]):
        data = mk._dds(w, h, body, pfflags=flags, bitcount=bits,
                       masks=masks)
        assert summary(dds.decode_dds(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("kind", ["pillow_dxt5", "bc7", "bc6h", "rgb565",
                                  "palette", "luminance"])
def test_dds_cut_anywhere_decodes_or_raises_as_imageio(kind):
    rnd = np.random.RandomState(11)
    w, h = 10, 9
    if kind == "pillow_dxt5":
        data = _pillow(Image.fromarray(mk.terrain(h, w, 5, 4)),
                       pixel_format="DXT5")
    elif kind in ("bc7", "bc6h"):
        data = mk._dds(w, h, mk._bc_blocks(rnd, 9, kind.upper()),
                       dxgi=mk._DXGI["BC7" if kind == "bc7" else "BC6H_UF16"])
    elif kind == "rgb565":
        data = mk._dds(w, h, bytes(rnd.randint(0, 256, 2 * w * h).astype(
            np.uint8)), pfflags=0x40, bitcount=16,
            masks=(0xF800, 0x7E0, 0x1F, 0))
    elif kind == "palette":
        data = mk._dds(w, h, bytes(rnd.randint(0, 256, 1024 + w * h).astype(
            np.uint8)), pfflags=0x20, bitcount=8)
    else:
        data = _pillow(Image.fromarray(mk.terrain(h, w, 5, 1)[..., 0]))
    decoded = 0
    for k in sorted(set(np.linspace(0, len(data), 30).astype(int))):
        decoded += _same_or_value_error(dds.decode_dds, data[:k])
    assert decoded >= 1


def test_block_rows_on_threads_give_the_same_bytes(monkeypatch):
    rnd = np.random.RandomState(2)
    data = mk._dds(37, 61, mk._bc_blocks(rnd, 10 * 16, "BC7"), dxgi=98)
    many = dds.decode_dds(data)
    monkeypatch.setattr(dds, "_THREADS", 1)
    assert np.array_equal(dds.decode_dds(data), many)


@pytest.mark.parametrize("data,match", [
    (mk._dds(4, 4, bytes(16), dxgi=87), "DXGI format 87"),
    (mk._dds(4, 4, bytes(16), fourcc=b"RXGB"), "pixel format b'RXGB'"),
    (mk._dds(4, 4, bytes(32), pfflags=0x20000, bitcount=16),
     "a luminance surface of 16 bits"),
    (mk._dds(4, 4, bytes(16), pfflags=0), "pixel format flags"),
    (b"DDS " + bytes([124]) + bytes(23), "header is cut short"),
    (mk._dds(4, 4, bytes(15), dxgi=98), "blocks are cut short")])
def test_what_pillow_cannot_read_raises_value_error(data, match):
    with pytest.raises(Exception):
        iio.imread(data)
    with pytest.raises(ValueError, match=match):
        dds.decode_dds(data)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3])
def test_sun_rasters_decode_as_imageio(seed, depth, ftype, tmp_path):
    """By bytes and at a *.ras path through Pillow's rules, at a *.sr path
    through OpenCV's: odd widths, colour maps, byte-encoded runs."""
    rnd = np.random.RandomState(seed * 100 + depth + ftype)
    w, h = int(rnd.randint(3, 20)), int(rnd.randint(1, 7))
    cmap = b""
    if depth <= 8 and seed % 2:
        cmap = rnd.randint(0, 256, int(rnd.choice([6, 48, 768]))).astype(
            np.uint8).tobytes()
    row = (w * depth + 7) // 8
    if ftype == 2:
        raw = rnd.choice([0, 7, 0x80, 200], row * h).astype(np.uint8)
        raw[: min(len(raw), 40)] = 9  # a run crossing rows
        body = mk._sun_rle(raw.tobytes())
    else:
        body = rnd.randint(0, 256, ((w * depth + 15) // 16) * 2 * h).astype(
            np.uint8).tobytes()
    data = mk._sun(w, h, depth, body, ftype, 1 if cmap else 0, cmap)
    _same_or_value_error(sun.decode_sun, data)
    for ext in (".ras", ".sr"):
        path = tmp_path / f"a{ext}"
        path.write_bytes(data)
        _same_or_value_error(read_raster, str(path))


@pytest.mark.parametrize("ftype", [1, 2])
def test_sun_rasters_cut_anywhere_decode_or_raise_as_imageio(ftype):
    """Pillow needs no padding after the last row; cut inside a run or a
    row, it fails."""
    rnd = np.random.RandomState(ftype)
    w, h = 11, 6
    raw = rnd.choice([0, 7, 0x80, 200], 3 * w * h).astype(np.uint8)
    body = mk._sun_rle(raw.tobytes()) if ftype == 2 else rnd.randint(
        0, 256, ((w * 24 + 15) // 16) * 2 * h).astype(np.uint8).tobytes()
    data = mk._sun(w, h, 24, body, ftype)
    decoded = 0
    for k in sorted(set(range(0, len(data), 3)) | {len(data)}):
        decoded += _same_or_value_error(sun.decode_sun, data[:k])
    assert decoded >= 1


@pytest.mark.parametrize("width,length", [(1, 4), (2, 1), (2, 4)])
def test_a_sun_header_pillow_takes_for_a_gimp_brush_is_refused(width,
                                                               length):
    data = mk._sun(width, 3, 8, bytes(12), length=length)
    with pytest.raises(NotImplementedError, match="GIMP brush"):
        sun.decode_sun(data)
    with pytest.raises(NotImplementedError, match="GIMP brush"):
        sun.check_kind("a.ras", data[:32])
    sun.check_kind("a.sr", data[:32])  # OpenCV reads a *.sr path
    assert summary(sun.decode_sun(mk._sun(3, 3, 8, bytes(18), length=4)))


@pytest.mark.parametrize("texture", ["dxt1", "bc7"])
def test_a_pfm_and_dds_pair_gives_terrain_tpus_crops(texture, tmp_path,
                                                     monkeypatch):
    """The slice's path on the CPU: float heights at a *.pfm path (OpenCV:
    rounded, saturated) and a block-compressed texture, through both
    packages' `_get_data`."""
    h, w = 132, 148
    rnd = np.random.RandomState(12)
    heights = (rnd.randint(0, 601, (h, w)) / 2).astype(np.float32)
    heights[:, : w // 3] = 0  # ocean
    hp, tp = tmp_path / "hm.pfm", tmp_path / "tex.dds"
    hp.write_bytes(mk._pfm(b"Pf", heights, -1.0))
    if texture == "dxt1":
        tp.write_bytes(_pillow(Image.fromarray(mk.terrain(h, w, 13, 3)),
                               pixel_format="DXT1"))
    else:
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        tp.write_bytes(mk._dds(w, h, mk._bc_blocks(rnd, nb, "BC7"),
                               dxgi=98))
    same_first_batches(f"{hp},{tp}", monkeypatch)

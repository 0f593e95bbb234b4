"""The IM, ICO and ICNS decoders (terrain_tpu_torch/data/im.py, ico.py and
icns.py) and MPO through the JPEG decoder, against imageio, which reads
them all through Pillow: every committed fixture of
tests/data/{im,ico,icns,mpo} (tests/make_raster_fixtures.py) to imageio's
shape, dtype and SHA-256 from its bytes and its path (or the exception
imageio raises), Pillow's files of every mode it writes at random sizes,
Pillow's choice of icon entry, files cut at many offsets, the IM header's
sniffing beside the formats with a magic, and a PCX + ICNS pair's first
batches against terrain_tpu's `_get_data`.  Images are a few dozen pixels
a side (Pillow's ICNS entries reach 1024)."""

import io

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, exception, rerun,
                          same_first_batches, script, summary)
from terrain_tpu_torch.data import icns, ico, im, raster
from terrain_tpu_torch.data.jpeg import decode_jpeg
from terrain_tpu_torch.data.raster import read_raster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()
DECODERS = {"im": im.decode_im, "ico": ico.decode_ico,
            "icns": icns.decode_icns, "mpo": decode_jpeg}


def _pillow(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def same_as_imageio(decode, src):
    """decode(src) gives imageio.v3.imread(src)'s array, or raises the
    exception imageio raises there; 1 where it decoded."""
    try:
        want = iio.imread(src)
    except Exception as e:  # noqa: BLE001 -- imageio raises many kinds
        with pytest.raises(exception(mk.error_name(e))):
            decode(src)
        return 0
    assert summary(decode(src)) == summary(want)
    return 1


@pytest.mark.parametrize("kind,name", [(k, n) for k in DECODERS
                                       for n in sorted(digests(k))])
def test_each_fixture_decodes_to_imageios_array(kind, name):
    check_fixture(kind, name, DECODERS[kind])


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_committed_fixtures_match_the_script(kind, tmp_path):
    rerun(kind, tmp_path)


def _mode(tex, mode):
    img = Image.fromarray(tex)
    if mode == "P":
        return img.convert("RGB").quantize(25)
    if mode == "PA":
        return img.convert("RGB").quantize(25).convert("PA")
    if mode.startswith("I;16"):
        return Image.fromarray(tex[..., 0].astype(np.uint16) * 257).convert(
            mode)
    if mode in ("I", "F"):
        return Image.fromarray(tex[..., 0].astype(np.int32) * 70001 - 3
                               ).convert(mode)
    return img.convert(mode)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA",
                                  "RGBX", "CMYK", "YCbCr", "I", "I;16",
                                  "I;16B", "F"])
def test_pillows_im_files_decode_as_imageio(mode, seed, tmp_path):
    rnd = np.random.RandomState(seed)
    w, h = int(rnd.randint(1, 30)), int(rnd.randint(1, 20))
    data = _pillow(_mode(mk.terrain(h, w, seed, 4), mode), "IM")
    path = tmp_path / "a.im"
    path.write_bytes(data)
    same_as_imageio(im.decode_im, data)
    same_as_imageio(read_raster, str(path))


@pytest.mark.parametrize("bmp", [False, True])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA",
                                  "I;16"])
def test_pillows_icons_decode_as_imageio(mode, bmp, tmp_path):
    """PNG or DIB entries (Pillow writes a DIB for 1, L, P, RGB and RGBA),
    several sizes, one not square."""
    rnd = np.random.RandomState(len(mode) + bmp)
    w, h = int(rnd.randint(8, 40)), int(rnd.randint(8, 40))
    img = _mode(mk.terrain(h, w, 5, 4), mode)
    kw = {"sizes": [(w, h), (max(1, w // 2), max(1, h // 2))]}
    if bmp and mode in ("1", "L", "P", "RGB", "RGBA"):
        kw["bitmap_format"] = "bmp"
    data = _pillow(img, "ICO", **kw)
    path = tmp_path / "a.ico"
    path.write_bytes(data)
    same_as_imageio(ico.decode_ico, data)
    same_as_imageio(read_raster, str(path))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P"])
def test_pillows_icns_files_decode_as_imageio(mode):
    """Pillow writes PNG entries up to 1024x1024: RGBA is read as it is,
    RGB through Pillow's RGBA packing, other modes not at all."""
    tex = np.kron(mk.terrain(8, 8, len(mode), 4), np.ones((128, 128, 1),
                                                          np.uint8))
    same_as_imageio(icns.decode_icns, _pillow(_mode(tex, mode), "ICNS"))


def test_the_icon_entry_is_pillows_choice():
    """By colour depth, then area: of two 256x256 entries the 8-bit DIB is
    read, not the 32-bit one; a colour count stands for a missing bit
    count; a width byte of 0 is 256."""
    with open(f"{mk.DEFAULT_DIR}/ico/depth_choice_256.ico", "rb") as f:
        data = f.read()
    assert ico.entries(data)[0][2] == 8
    got = ico.decode_ico(data)
    assert summary(got) == summary(iio.imread(data))
    assert got.shape == (256, 256, 4)
    dirs = [(w, h, 0, bpp, bytes(4)) for w, h, bpp in (
        (16, 16, 32), (0, 0, 4), (0, 0, 24), (32, 16, 8), (16, 32, 1))]
    assert [e[:3] for e in ico.entries(mk.ico_bytes(dirs))] == [
        (256, 256, 4), (256, 256, 24), (16, 32, 1), (32, 16, 8),
        (16, 16, 32)]


@pytest.mark.parametrize("name", ["im/pillow_rgba.im", "im/b4_colour_lut.im",
                                  "im/pillow_i_16b.im", "ico/pillow_png_p.ico",
                                  "ico/pillow_bmp_p.ico", "ico/dib4_mask.ico",
                                  "icns/it32_t8mk.icns",
                                  "icns/il32_raw_l8mk.icns",
                                  "icns/ih32_raw_no_mask.icns"])
def test_files_cut_anywhere_decode_or_raise_as_imageio(name):
    kind = name.split("/")[0]
    with open(f"{mk.DEFAULT_DIR}/{name}", "rb") as f:
        data = f.read()
    decoded = 0
    for k in sorted(set(np.linspace(0, len(data), 30).astype(int))):
        decoded += same_as_imageio(DECODERS[kind], data[:k])
    assert decoded >= 1


def test_an_mpo_cut_anywhere_decodes_or_raises_as_imageio():
    """The JPEG decoder raises imageio's class wherever imageio fails:
    ValueError for a cut marker length before the first scan, OSError for
    cut segment data or a first frame cut before its EOI marker (which
    Pillow needs)."""
    with open(f"{mk.DEFAULT_DIR}/mpo/pillow_two_frames.mpo", "rb") as f:
        data = f.read()
    decoded = 0
    for k in sorted(set(np.linspace(0, len(data), 30).astype(int))):
        decoded += same_as_imageio(decode_jpeg, data[:k])
    assert decoded >= 1


@pytest.mark.parametrize("head,fmt", [
    (b"Image type: RGB image\r\nName: x\r\n", "IM"),
    (b"\r\rImage size (x*y): 3*4\n", "IM"),
    (b"Lut: 1\n", "IM"),
    (b"Foo: bar\nImage type: L image\n", None),
    (b"P6\n# Image type: x\n3 4\n255\n", "PNM"),
    (b"#?RADIANCE\nImage type: x\n", "HDR"),
    (b"qoif\0\0\0\x05\0\0\0\x05\x03\0", "QOI"),
    (b"icns\0\0\0\x10", "ICNS"), (b"\0\0\1\0\1\0", "ICO"),
    (b"\x0a\x05\x01\x08", "PCX"), (b"\x01\xda\x00\x01", "SGI")])
def test_formats_are_known_by_their_first_bytes(head, fmt):
    """IM, which has no magic, is sniffed after every format with one."""
    assert raster._sniff(head) == fmt


def test_a_pcx_and_icns_pair_gives_terrain_tpus_crops(tmp_path,
                                                      monkeypatch):
    """8-bit PCX heights and an it32 + t8mk icon texture (RGBA, cut to RGB
    by both packages) through both packages' `_get_data`."""
    tex = mk.terrain(128, 128, 31, 4)
    hp, tp = tmp_path / "hm.pcx", tmp_path / "tex.icns"
    hp.write_bytes(_pillow(Image.fromarray(tex[..., 0]), "PCX"))
    runs = b"".join(mk._icns_runs(tex[..., c].tobytes()) for c in range(3))
    tp.write_bytes(mk.icns_bytes([(b"it32", bytes(4) + runs),
                                  (b"t8mk", tex[..., 3].tobytes())]))
    same_first_batches(f"{hp},{tp}", monkeypatch)

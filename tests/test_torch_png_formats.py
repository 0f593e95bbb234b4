"""The port's PNG decoder (terrain_tpu_torch/serve/png.py) on every PNG
variant against imageio, which decodes through Pillow (the JAX package's
reader): every committed fixture of tests/data/png
(tests/make_raster_fixtures.py: gray at 1-16 bits, palettes at 1-8 bits,
gray+alpha and colour at 8 and 16 bits, tRNS, Adam7) to imageio's shape,
dtype and SHA-256 through `read_png`; `decode_png`'s (H, W, C) contract for
the serving codec; Adam7 at every small size against the image it was
made from; files cut in their image data against imageio; and
interlaced and palette pairs' crops against terrain_tpu's `_get_data`.  Images are a few dozen pixels a side."""

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, rerun, same_first_batches,
                          script, summary)
from terrain_tpu_torch.serve import png
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
mk = script()


@pytest.mark.parametrize("name", sorted(digests("png")))
def test_each_fixture_decodes_to_imageios_array(name):
    check_fixture("png", name, png.read_png)


@pytest.mark.parametrize("name", sorted(digests("png")))
def test_decode_png_keeps_its_channel_axis(name):
    """The serving codec's contract: (H, W, C), samples below 8 bits scaled
    to 0-255, a palette expanded to RGB, 16 bits kept; where imageio keeps
    the same samples (8 bits, palettes, 2- and 4-bit gray), its values."""
    import os

    from raster_cases import DATA

    data = open(os.path.join(DATA, "png", name), "rb").read()
    got = png.decode_png(data)
    img, depth, ctype, palette = png.decode_samples(data)
    if ctype == 3:
        want = palette[img[..., 0]]
    elif depth < 8:
        want = img * np.uint8(255 // ((1 << depth) - 1))
    else:
        want = img
    assert got.ndim == 3 and summary(got) == summary(want)
    if depth == 8 or ctype == 3 or depth in (2, 4):
        np.testing.assert_array_equal(
            got, np.asarray(png.read_png(data)).reshape(got.shape))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0),
                                         (16, 0), (1, 3), (2, 3), (4, 3),
                                         (8, 3), (8, 4), (16, 4), (8, 2),
                                         (16, 2), (8, 6), (16, 6)])
def test_adam7_at_every_small_size(depth, ctype):
    """Every size up to 9 x 9 (passes empty and not), interlaced, gives the
    image it was made from."""
    rnd = np.random.RandomState(depth * 10 + ctype)
    c = mk._PNG_CHANNELS[ctype]
    top = (1 << depth) - 1
    plte = rnd.randint(0, 256, (256, 3)) if ctype == 3 else None
    for h in range(1, 10):
        for w in range(1, 10):
            img = rnd.randint(0, top + 1, (h, w, c)).astype(
                np.uint16 if depth == 16 else np.uint8)
            data = mk.png_bytes(img, depth, ctype, plte=plte, interlace=1)
            got, d, t, _ = png.decode_samples(data)
            assert (d, t) == (depth, ctype)
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("name", ["gray1_1x1_adam7.png",
                                  "gray1_2x3_adam7.png",
                                  "rgb8_2x3_adam7.png", "palette4_adam7.png",
                                  "gray8.png"])
def test_a_png_cut_in_its_image_data_reads_as_imageio_reads_it(name):
    """Cut anywhere from its first IDAT's data on, a PNG decodes where
    imageio decodes it, to its array, and raises its class where it
    raises: Pillow's decoder stops once the rows are filled, inflating a
    row at a time while an IDAT's block lasts, then walks the chunks to
    IEND (these small files split their zlib stream over several IDATs)."""
    import os

    from raster_cases import DATA, exception

    with open(os.path.join(DATA, "png", name), "rb") as f:
        data = f.read()
    decoded = 0
    for k in range(data.index(b"IDAT") + 4, len(data) + 1):
        try:
            want = iio.imread(data[:k])
        except Exception as e:  # noqa: BLE001 -- imageio raises many kinds
            with pytest.raises(exception(mk.error_name(e))):
                png.read_png(data[:k])
            continue
        assert summary(png.read_png(data[:k])) == summary(want)
        decoded += 1
    assert decoded >= 1


def test_bad_files_raise_value_error():
    img = np.zeros((4, 4), np.uint8)
    data = mk.png_bytes(img, 8, 3, plte=None)
    with pytest.raises(ValueError, match="without its PLTE"):
        png.read_png(data)
    bad = bytearray(mk.png_bytes(img, 8, 0))
    bad[24] = 3  # depth 3
    with pytest.raises(ValueError, match="unsupported PNG: depth 3"):
        png.read_png(bytes(bad))


@pytest.mark.parametrize("kind", ["interlaced gray + palette",
                                  "1-bit + interlaced 16-bit colour",
                                  "4-bit palette + RGBA"])
def test_a_png_pair_gives_terrain_tpus_crops(kind, tmp_path, monkeypatch):
    h, w = 140, 170
    tex = mk.terrain(h, w, 41, 4)
    land = tex[..., 0] > 40
    rnd = np.random.RandomState(4)
    plte = rnd.randint(0, 256, (256, 3))
    hm8 = np.where(land, tex[..., 1], 0).astype(np.uint8)
    hms = {"interlaced gray + palette": lambda: mk.png_bytes(
               hm8, 8, 0, interlace=1),
           "1-bit + interlaced 16-bit colour": lambda: mk.png_bytes(
               land.astype(np.uint8), 1, 0),
           "4-bit palette + RGBA": lambda: mk.png_bytes(
               np.where(land, hm8 >> 4, 0), 4, 3, plte=plte[:16])}
    texs = {"interlaced gray + palette": lambda: mk.png_bytes(
                tex[..., 2], 8, 3, plte=plte),
            "1-bit + interlaced 16-bit colour": lambda: mk.png_bytes(
                tex[..., :3].astype(np.uint16) * 257, 16, 2, interlace=1),
            "4-bit palette + RGBA": lambda: mk.png_bytes(
                tex[..., [0, 3]], 8, 4, interlace=1)}
    hp, tp = tmp_path / "hm.png", tmp_path / "tex.png"
    hp.write_bytes(hms[kind]())
    tp.write_bytes(texs[kind]())
    same_first_batches(f"{hp},{tp}", monkeypatch)


def test_committed_fixtures_match_the_script(tmp_path):
    rerun("png", tmp_path)

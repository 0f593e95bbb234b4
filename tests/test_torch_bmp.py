"""The port's BMP decoder (terrain_tpu_torch/data/bmp.py and the RLE of
data/csrc/raster_decode.cpp) against imageio, which decodes through Pillow
(the JAX package's reader): every committed fixture of tests/data/bmp
(tests/make_raster_fixtures.py) to imageio's shape, dtype and SHA-256,
random run-length streams against Pillow's own decoder, the kinds it
refuses by name, damaged files, and a BMP pair's crops against
terrain_tpu's `_get_data`.  Images are a few dozen pixels a side."""

import struct

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, rerun, same_first_batches,
                          script, summary)
from terrain_tpu_torch.data import bmp
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
mk = script()


@pytest.mark.parametrize("name", sorted(digests("bmp")))
def test_each_fixture_decodes_to_imageios_array(name):
    check_fixture("bmp", name, bmp.decode_bmp)


def _random_rle(rnd, w, h, rle4):
    """A run-length stream Pillow decodes to a whole image: each row some
    encoded runs (some past the row's end, which Pillow clips), absolute
    runs (even lengths for RLE4: Pillow misreads odd ones), now and then
    a delta escape, then an end of line; an end of bitmap after the last."""
    out = bytearray()
    top = 15 if rle4 else 255
    for _ in range(h):
        out += bytes([rnd.randint(1, w + 3), rnd.randint(0, 256)])
        for _ in range(rnd.randint(0, 4)):
            k = rnd.randint(0, 3)
            if k == 0:
                out += bytes([rnd.randint(1, w), rnd.randint(0, 256)])
            elif k == 1:
                n = 2 * rnd.randint(2, 5) if rle4 else rnd.randint(3, 9)
                data = bytes(rnd.randint(0, 256 if rle4 else top + 1,
                                         (n + 1) // 2 if rle4 else n)
                             .tolist())
                out += bytes([0, n]) + data
                if len(data) % 2:
                    out += b"\x00"
            else:  # Pillow reads the delta's bytes, then moves by two more
                out += bytes([0, 2, 9, 9, rnd.randint(0, 3), 0])
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("seed", range(6))
def test_random_run_length_streams_decode_as_pillow(rle4, seed):
    rnd = np.random.RandomState(seed)
    w, h = rnd.randint(5, 30), rnd.randint(3, 20)
    pal = rnd.randint(0, 256, (16 if rle4 else 256, 3))
    img = np.zeros((h, w), np.uint8)
    data = mk.bmp_bytes(img, 4 if rle4 else 8, pal, 2 if rle4 else 1,
                        rle=_random_rle(rnd, w, h, rle4))
    assert summary(bmp.decode_bmp(data)) == summary(iio.imread(data))


@pytest.mark.parametrize("kind,match", [
    ("jpeg", r"compression 4 \(BI_JPEG\)"),
    ("png", r"compression 5 \(BI_PNG\)"),
    ("2 bits", "2 bits a pixel"),
    ("header", "a header of 20 bytes"),
    ("masks", "BI_BITFIELDS masks"),
    ("rle at 24 bits", "BI_RLE8 at 24 bits")])
def test_other_kinds_are_refused_by_name(kind, match):
    img = np.zeros((4, 4, 3), np.uint8)
    data = {
        "jpeg": lambda: mk.bmp_bytes(img, 24, compression=4),
        "png": lambda: mk.bmp_bytes(img, 24, compression=5),
        "2 bits": lambda: mk.bmp_bytes(img[..., 0], 2, np.zeros((4, 3))),
        "header": lambda: mk.bmp_bytes(img, 24)[:14] + struct.pack(
            "<I", 20) + bytes(40),
        "masks": lambda: mk.bmp_bytes(img, 32, compression=3,
                                      masks=(0xF00, 0xF0, 0xF)),
        "rle at 24 bits": lambda: mk.bmp_bytes(img, 24, compression=1,
                                               rle=b"\x00\x01"),
    }[kind]()
    with pytest.raises(NotImplementedError, match=match):
        bmp.read_header(data)
    with pytest.raises(NotImplementedError, match=match):
        bmp.decode_bmp(data)


def test_damaged_files_raise_value_error():
    good = mk.bmp_bytes(np.zeros((6, 7, 3), np.uint8), 24)
    with pytest.raises(ValueError, match="cut short"):
        bmp.decode_bmp(good[:-5])
    with pytest.raises(ValueError, match="not a BMP"):
        bmp.decode_bmp(b"GIF89a" + bytes(40))
    pal = mk.bmp_bytes(np.zeros((6, 7), np.uint8), 8, np.zeros((256, 3)))
    with pytest.raises(ValueError, match="palette is cut short"):
        bmp.decode_bmp(pal[:200])


@pytest.mark.parametrize("kind", ["gray ramp + 24-bit", "rle8 + bitfields",
                                  "1-bit + palette"])
def test_a_bmp_pair_gives_terrain_tpus_crops(kind, tmp_path, monkeypatch):
    h, w = 140, 170
    tex = mk.terrain(h, w, 31, 4)
    land = tex[..., 0] > 40
    gray = np.repeat(np.arange(256)[:, None], 3, 1)
    hm8 = np.where(land, tex[..., 1], 0).astype(np.uint8)
    pal = np.random.RandomState(2).randint(0, 256, (256, 3))
    hms = {"gray ramp + 24-bit": lambda: mk.bmp_bytes(hm8, 8, gray),
           "rle8 + bitfields": lambda: mk.bmp_bytes(
               hm8, 8, gray, 1, rle=mk._rle8(hm8[::-1], w)),
           "1-bit + palette": lambda: mk.bmp_bytes(
               land.astype(np.uint8), 1, np.array([[0] * 3, [255] * 3]))}
    texs = {"gray ramp + 24-bit": lambda: mk.bmp_bytes(tex[..., :3], 24),
            "rle8 + bitfields": lambda: mk.bmp_bytes(
                tex, 32, compression=3,
                masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124),
            "1-bit + palette": lambda: mk.bmp_bytes(tex[..., 2], 8, pal,
                                                    top_down=True)}
    hp, tp = tmp_path / "hm.bmp", tmp_path / "tex.bmp"
    hp.write_bytes(hms[kind]())
    tp.write_bytes(texs[kind]())
    same_first_batches(f"{hp},{tp}", monkeypatch)


def test_committed_fixtures_match_the_script(tmp_path):
    rerun("bmp", tmp_path)

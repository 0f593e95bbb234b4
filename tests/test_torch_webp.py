"""The port's WebP decoder (terrain_tpu_torch/data/webp.py and
data/csrc/webp_decode.cpp) against imageio, which decodes through Pillow
and libwebp (the JAX package's reader): every committed fixture of
tests/data/webp (tests/make_raster_fixtures.py: Pillow's files at every
quality and method, palettes, alpha, odd sizes, and the VP8 headers, token
partitions, ALPH chunks and VP8X layouts Pillow cannot write) to
imageio's shape, dtype and SHA-256; images Pillow writes here, files cut
or damaged anywhere (ValueError where imageio fails, else imageio's very
bytes, garbage included), an animation's first frame on its canvas, and a
WebP pair's crops against terrain_tpu's `_get_data`.  Images are a few
dozen pixels a side."""

import io
import os
import struct

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, rerun, same_first_batches,
                          script, summary)
from terrain_tpu_torch.data import webp
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()


def _save(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _fixture(name):
    with open(os.path.join(mk.DEFAULT_DIR, "webp", name), "rb") as f:
        return f.read()


def _imageio(data):
    """imageio's decode of the bytes, or the exception it raised."""
    try:
        return iio.imread(data)
    except Exception as e:  # noqa: BLE001 -- any failure of Pillow's
        return e


@pytest.mark.parametrize("name", sorted(digests("webp")))
def test_each_fixture_decodes_to_imageios_array(name):
    check_fixture("webp", name, webp.decode_webp)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["lossy", "lossless", "rgba_lossy",
                                  "rgba_lossless"])
def test_pillows_files_decode_as_imageio(kind, seed):
    rnd = np.random.RandomState(seed)
    h, w = rnd.randint(1, 70, 2)
    img = mk.terrain(h, w, seed, 4 if kind.startswith("rgba") else 3)
    if kind.startswith("rgba"):
        img[..., 3] = rnd.randint(0, 256, (h, w))
    kw = ({"lossless": True, "quality": int(rnd.randint(0, 101)),
           "method": int(rnd.randint(0, 7))} if kind.endswith("lossless")
          else {"quality": int(rnd.randint(0, 101)),
                "method": int(rnd.randint(0, 7))})
    data = _save(img, **kw)
    assert summary(webp.decode_webp(data)) == summary(iio.imread(data))


def _files():
    rgba = mk.terrain(33, 45, 7, 4)
    return {"lossy": _save(mk.terrain(40, 52, 5), quality=70),
            "lossless": _save(mk.terrain(40, 52, 6), lossless=True),
            "alpha": _save(rgba, quality=70)}


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_a_file_cut_anywhere_raises_value_error(kind):
    """Cut at any of 12 points: the RIFF size then runs past the end, and,
    with the chunk sizes mended, the bitstream itself ends early."""
    data = _files()[kind]
    chunks = mk._chunks(data)
    for n in np.linspace(13, len(data) - 1, 12).astype(int):
        with pytest.raises(ValueError):
            webp.decode_webp(data[:n])
    *head, (tag, payload) = chunks
    for n in np.linspace(10, len(payload) - 30, 12).astype(int):
        cut = mk._riff(head + [(tag, payload[:n])])
        assert isinstance(_imageio(cut), Exception)
        with pytest.raises(ValueError):
            webp.decode_webp(cut)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_damaged_bytes_decode_as_libwebp_does(kind):
    """A byte changed in the bitstream: where imageio fails the port raises
    ValueError; where libwebp decodes the damage the port gives its bytes."""
    data = _files()[kind]
    rnd = np.random.RandomState(3)
    start = len(data) - len(mk._chunks(data)[-1][1])
    raised = decoded = 0
    for _ in range(24):
        bad = bytearray(data)
        at = int(rnd.randint(start + 5, len(data)))
        bad[at] ^= 1 << int(rnd.randint(0, 8))
        want = _imageio(bytes(bad))
        if isinstance(want, Exception):
            with pytest.raises(ValueError):
                webp.decode_webp(bytes(bad))
            raised += 1
        else:
            assert summary(webp.decode_webp(bytes(bad))) == summary(want)
            decoded += 1
    assert raised + decoded == 24


def test_an_animation_is_refused_by_name():
    """The committed animations give imageio's first frame: the canvas and
    channels from read_header, the bytes from decode_webp."""
    want = digests("webp")
    for name in ("pillow_animated_2_frames.webp", "animated_1_frame.webp"):
        data = _fixture(name)
        assert list(webp.read_header(data)) == want[name]["shape"]
        assert summary(webp.decode_webp(data)) == [
            want[name]["shape"], want[name]["dtype"], want[name]["sha256"]]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["lossy", "lossless", "rgba_lossy",
                                  "rgba_lossless"])
def test_pillows_animations_give_imageios_first_frame(kind, seed):
    rnd = np.random.RandomState(seed + 10)
    h, w = rnd.randint(1, 50, 2)
    ch = 4 if kind.startswith("rgba") else 3
    frames = [Image.fromarray(mk.terrain(h, w, seed + k, ch))
              for k in range(int(rnd.randint(1, 4)))]
    kw = {"lossless": True} if kind.endswith("lossless") else {
        "quality": int(rnd.randint(0, 101))}
    data = _save_all(frames, **kw)
    assert summary(webp.decode_webp(data)) == summary(iio.imread(data))


def _save_all(frames, **kw):
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["animated_offset_lossy_alph.webp",
                                  "pillow_animated_lossy_rgba.webp"])
def test_an_animation_cut_anywhere_decodes_as_imageio_or_raises(name):
    """Cut at 16 points: ValueError where imageio fails (libwebp's demuxer
    takes no partial file), else imageio's bytes."""
    data = _fixture(name)
    for n in np.linspace(13, len(data) - 1, 16).astype(int):
        want = _imageio(data[:n])
        if isinstance(want, Exception):
            with pytest.raises(ValueError):
                webp.decode_webp(data[:n])
        else:
            assert summary(webp.decode_webp(data[:n])) == summary(want)


@pytest.mark.parametrize("what,match", [
    ("two_alph", "two ALPH chunks"),
    ("chunk_after_alph", "a chunk between ALPH and the image"),
    ("alph_vp8l", "an ALPH chunk with a VP8L image"),
    ("anim_flag", "animation flag without ANMF frames")])
def test_layouts_libwebp_rejects_raise_value_error(what, match):
    rgba = mk.terrain(16, 16, 8, 4)
    vp8x, alph, vp8 = mk._chunks(_save(rgba, quality=50))
    vp8l = mk._chunks(_save(rgba, lossless=True))[0]
    data = {
        "two_alph": lambda: mk._riff([vp8x, alph, alph, vp8]),
        "chunk_after_alph": lambda: mk._riff([vp8x, alph,
                                              (b"XYZW", b"\0\0"), vp8]),
        "alph_vp8l": lambda: mk._riff([vp8x, alph, vp8l]),
        "anim_flag": lambda: mk._riff([(b"VP8X", bytes([0x12]) + vp8x[1][1:]),
                                       alph, vp8]),
    }[what]()
    assert isinstance(_imageio(data), Exception)
    for call in (webp.read_header, webp.decode_webp):
        with pytest.raises(ValueError, match=match):
            call(data)


def test_damaged_containers_raise_value_error():
    good = _save(mk.terrain(8, 8, 9), quality=50)
    for bad, match in (
            (b"RIFX" + good[4:], "RIFF"),
            (good[:4] + struct.pack("<I", 4) + good[8:], "RIFF size"),
            (good[:12] + b"ZZZZ" + good[16:], "first chunk"),
            (mk._riff([(b"VP8 ", b"\x00" * 9)]), "cut short"),
            (mk._riff([(b"VP8L", b"\x2e" + bytes(8))]), "signature")):
        with pytest.raises(ValueError, match=match):
            webp.decode_webp(bad)


def test_the_header_names_the_frame():
    assert webp.read_header(_save(mk.terrain(5, 9, 1), quality=9)) == (
        5, 9, 3)
    assert webp.read_header(_save(mk.terrain(5, 9, 1, 4),
                                  lossless=True)) == (5, 9, 4)


def test_a_webp_pair_gives_terrain_tpus_crops(tmp_path, monkeypatch):
    h, w = 140, 170
    tex = mk.terrain(h, w, 31)
    hm = np.where(tex[..., 0] > 40, tex[..., 1], 0).astype(np.uint8)
    hp, tp = tmp_path / "hm.webp", tmp_path / "tex.webp"
    hp.write_bytes(_save(hm, lossless=True))
    tp.write_bytes(_save(tex, quality=85))
    same_first_batches(f"{hp},{tp}", monkeypatch)


def test_committed_fixtures_match_the_script(tmp_path):
    rerun("webp", tmp_path)

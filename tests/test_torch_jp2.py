"""The port's JPEG 2000 decoder (terrain_tpu_torch/data/jp2.py and
data/csrc/jp2_decode.cpp) against imageio, which decodes through Pillow
and openjpeg (the JAX package's reader): every committed fixture of
tests/data/jp2 (tests/make_raster_fixtures.py: Pillow's files over its
options, OpenCV's 16-bit files, codestreams rewritten there, cut files and
the kinds refused by name) to imageio's shape, dtype and SHA-256, by its
bytes and by its path; seeded Pillow files against imageio; files cut at
many offsets and bits flipped anywhere (imageio's array where it decodes
one, else ValueError); the bits against the thread count; the refusals before any pixel; and a JP2
pair's crops against terrain_tpu's `_get_data`.  Images are a few dozen
pixels a side, but for the two 1024x1024 tiles."""

import io
import os
import struct

import numpy as np
import pytest

from raster_cases import (DATA, check_fixture, digests, rerun,
                          same_first_batches, script, summary)
from terrain_tpu_torch.data import jp2
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()


def _fixture(name):
    with open(os.path.join(DATA, "jp2", name), "rb") as f:
        return f.read()


def _imageio(data):
    """imageio's decode of the bytes through Pillow, or the exception it
    raised."""
    try:
        return iio.imread(data, plugin="pillow")
    except Exception as e:  # noqa: BLE001 -- any failure of Pillow's
        return e


def _same_as_imageio(data, threads=jp2.THREADS):
    want = _imageio(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            jp2.decode_jp2(data, threads)
        return False
    assert summary(jp2.decode_jp2(data, threads)) == summary(want)
    return True


@pytest.mark.parametrize("name", sorted(digests("jp2")))
def test_each_fixture_decodes_to_imageios_array(name):
    check_fixture("jp2", name, jp2.decode_jp2)


def _options(seed):
    """A Pillow encoding drawn from `seed`: (mode, h, w, save options),
    within what Pillow's encoder writes without failing."""
    rnd = np.random.RandomState(seed)
    mode = ["L", "I;16", "LA", "RGB", "RGBA"][rnd.randint(5)]
    h, w = (int(v) for v in rnd.randint(8, 65, 2))
    kw = {"irreversible": bool(rnd.randint(2))}
    kw["num_resolutions"] = int(rnd.randint(
        1, min(4, int(np.log2(min(h, w)))) + 1))
    kw["codeblock_size"] = [(4, 4), (8, 16), (16, 8), (32, 32),
                            (64, 64)][rnd.randint(5)]
    if kw["num_resolutions"] <= 3 and rnd.randint(2):
        p = [16, 32, 64][rnd.randint(3)]
        kw["precinct_size"] = (p, p)
    if rnd.randint(3) == 0:  # tiles no narrower than the wavelet's levels
        t = 1 << kw["num_resolutions"]
        tw, th = (int(v) for v in rnd.randint(max(t, 8), 33, 2))
        if (w % tw == 0 or w % tw >= t) and (h % th == 0 or h % th >= t):
            kw["tile_size"] = (tw, th)
    kw["progression"] = ["LRCP", "RLCP", "RPCL", "PCRL",
                         "CPRL"][rnd.randint(5)]
    if rnd.randint(2):
        if rnd.randint(2):
            kw["quality_mode"] = "rates"
            kw["quality_layers"] = sorted((float(v) for v in rnd.randint(
                4, 60, rnd.randint(1, 4))), reverse=True)
        else:
            kw["quality_mode"] = "dB"
            kw["quality_layers"] = sorted(float(v) for v in rnd.randint(
                20, 60, rnd.randint(1, 4)))
    if mode in ("RGB", "RGBA") and rnd.randint(4) == 0:
        kw["mct"] = 0
    kw["no_jp2"] = bool(rnd.randint(2))
    kw["plt"] = bool(rnd.randint(4) == 0)
    return mode, h, w, kw


def _pillow_file(seed):
    mode, h, w, kw = _options(seed)
    c = {"L": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = mk.terrain(h, w, seed, c)
    arr = mk.heights16(h, w, seed) if mode == "I;16" else (
        img[..., 0] if c == 1 else img)
    buf = io.BytesIO()
    Image.fromarray(arr, None if c == 1 else mode).save(buf, "JPEG2000",
                                                        **kw)
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(24))
def test_pillows_files_decode_as_imageio(seed):
    data = _pillow_file(seed)
    assert _same_as_imageio(data, threads=1 + seed % 3)


def _sot_offsets(data):
    """Every tile-part's SOT marker offset in a JP2 file or codestream."""
    start = 0 if data[:2] == b"\xffO" else next(
        p + 8 for p in range(len(data) - 4) if data[p + 4:p + 8] == b"jp2c")
    main, parts, _ = mk.j2k_parts(data[start:])
    at, out = start + len(main), []
    for _, _, _, hdr, body in parts:
        out.append(at)
        at += 12 + len(hdr) + 2 + len(body)
    return out


@pytest.mark.parametrize("name", [
    "pillow_rgb_tiles_16x20.jp2", "pillow_rgb_97_tiles_offsets.jp2",
    "pillow_rgb_layers_rates_97.jp2", "pillow_gray16_tiles_offsets.j2k",
    "tileparts_split.j2k", "tileparts_tnsot0.j2k"])
def test_a_file_cut_anywhere_decodes_as_imageio_or_raises(name):
    """Cut at 30 points and around every tile-part's SOT marker: where
    openjpeg still decodes (right after an SOT marker code: the tiles
    completed by then, the rest zero) imageio's bytes, else ValueError."""
    data = _fixture(name)
    cuts = set(np.linspace(1, len(data) - 1, 30).astype(int).tolist())
    for at in _sot_offsets(data):
        cuts.update(range(at - 1, at + 5))
    decoded = sum(_same_as_imageio(data[:n], threads=2)
                  for n in sorted(cuts) if 0 < n < len(data))
    assert decoded >= 1  # some cuts give imageio's partial array


@pytest.mark.parametrize("name", [
    "pillow_rgb_tiles_16x20.jp2", "pillow_la_97.jp2",
    "pillow_rgb_rpcl_97.jp2", "pillow_gray16_tiles_offsets.j2k"])
def test_damaged_bytes_decode_as_openjpeg_does(name):
    """A bit flipped anywhere: where imageio fails the port raises
    ValueError, where openjpeg decodes the damage the port gives its bytes
    (garbage included); a flip that names a kind the port refuses
    (a code-block style, a marker) is refused by name."""
    data = _fixture(name)
    rnd = np.random.RandomState(len(data))
    for _ in range(24):
        bad = bytearray(data)
        bad[int(rnd.randint(len(data)))] ^= 1 << int(rnd.randint(8))
        want = _imageio(bytes(bad))
        try:
            got = jp2.decode_jp2(bytes(bad), 2)
        except NotImplementedError:
            continue
        except ValueError:
            assert isinstance(want, Exception)
            continue
        assert not isinstance(want, Exception)
        assert summary(got) == summary(want)


@pytest.mark.parametrize("name", [
    "pillow_rgb_97_tiles_offsets.jp2", "pillow_rgb_layers_dB_97.jp2",
    "tileparts_interleaved.j2k", "pillow_gray16_53_res7.jp2"])
def test_the_bits_do_not_depend_on_the_thread_count(name):
    data = _fixture(name)
    want = summary(jp2.decode_jp2(data, 1))
    for threads in (2, 3, 8):
        assert summary(jp2.decode_jp2(data, threads)) == want


REFUSED = sorted(n for n in digests("jp2") if n.startswith("refused_"))


@pytest.mark.parametrize("name", REFUSED)
def test_what_no_fixture_holds_is_refused_by_its_header(name):
    """The refusal comes from the boxes and the main header alone
    (read_header, before any tile is read), with the words
    digests.json names it by."""
    words = digests("jp2")[name]["refused"]
    with pytest.raises(NotImplementedError, match=words.replace("(", r"\(")
                       .replace(")", r"\)")):
        jp2.read_header(_fixture(name))


def test_the_header_names_imageios_array():
    for name, shape, dtype in (
            ("pillow_gray8_53.jp2", (37, 45), np.uint8),
            ("pillow_gray16_53.j2k", (37, 45), np.uint16),
            ("pillow_la_97.jp2", (37, 45, 2), np.uint8),
            ("pillow_rgb_53.jp2", (37, 45, 3), np.uint8),
            ("pillow_rgba_97.jp2", (29, 34, 4), np.uint8),
            ("opencv_rgb16.jp2", (70, 73, 3), np.uint8),
            ("pillow_gray16_tiles_offsets.j2k", (37, 45), np.uint16)):
        assert jp2.read_header(_fixture(name)) == (shape, np.dtype(dtype))


def test_damaged_headers_raise_value_error():
    good = _fixture("pillow_rgb_53.j2k")
    for bad, match in (
            (b"\x00\x00\x00\x0cjP  \r\n\x87\x0b" + bytes(40), "not a JP2"),
            (mk._cod(good, lambda x: x[:6] + bytes([9]) + x[7:]),
             "code-block size"),
            (good[:4] + struct.pack(">H", 1) + good[6:], "cut short"),
            (good[:60], "cut short"),
            (mk._edit(good, lambda segs: [(m, x) for m, x in segs
                                          if m != 0xFF5C]), "no QCD")):
        assert isinstance(_imageio(bad), Exception)
        with pytest.raises(ValueError, match=match):
            jp2.decode_jp2(bad)


def test_a_jp2_pair_gives_terrain_tpus_crops(tmp_path, monkeypatch):
    h, w = 140, 170
    tex = mk.terrain(h, w, 31)
    hm = mk.heights16(h, w, 32)
    hp, tp = tmp_path / "hm.jp2", tmp_path / "tex.j2k"
    Image.fromarray(hm).save(hp, "JPEG2000", tile_size=(64, 64),
                             progression="RPCL")
    Image.fromarray(tex).save(tp, "JPEG2000", irreversible=True,
                              quality_mode="dB", quality_layers=[30, 40])
    same_first_batches(f"{hp},{tp}", monkeypatch)


def test_committed_fixtures_match_the_script(tmp_path):
    rerun("jp2", tmp_path)

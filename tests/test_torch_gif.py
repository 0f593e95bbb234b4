"""The port's GIF writer and reader (terrain_tpu_torch/serve/gif.py and the
host C++ of serve/csrc/gif_encode.cpp) against imageio.v3.imwrite(...,
duration=40, loop=0) through Pillow 12.1.0 on the same frames: gray and
few-colour frames decode bit-equal, full-colour frames within 1.10 times
Pillow's mean error plus 0.25 grey levels (and here, bit-equal: the count
is asserted), the frame count after merging, durations, loop and screen
size equal, and read_gif equal to imageio's reader on imageio's files and
the port's.  The committed clips of tests/data/gif (tests/make_gif_fixtures.py)
against their digests, as chip_smoke.py holds them on the card.  Frames
are a few dozen pixels a side, and one pair 512 x 520 (Pillow compacts
palettes only below 512 x 512)."""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from terrain_tpu_torch.serve import gif
from terrain_tpu_torch.serve.png import read_png_path
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "gif")


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_gif_fixtures", os.path.join(HERE, "make_gif_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pillow(frames, **kw):
    buf = io.BytesIO()
    iio.imwrite(buf, frames, extension=".gif", **kw)
    return buf.getvalue()


def _meta(data):
    """Pillow's reading of a GIF: frames, durations, loop, screen size."""
    im = Image.open(io.BytesIO(data))
    durations = []
    for k in range(im.n_frames):
        im.seek(k)
        durations.append(im.info.get("duration"))
    return im.n_frames, durations, im.info.get("loop"), im.size


def _decode(data):
    return iio.imread(data, extension=".gif")


def _same_as_pillow(frames, duration=40):
    """The port's GIF and imageio's of `frames`: metadata equal, read_gif
    equal to imageio's reader on both files; returns both decodes."""
    ref = _pillow(frames, duration=duration, loop=0)
    mine = gif.encode_gif(frames, duration)
    assert _meta(mine) == _meta(ref)
    meta = gif.gif_meta(mine)
    n, durations, lp, size = _meta(ref)
    assert (len(meta["durations"]), meta["durations"], meta["loop"],
            meta["size"]) == (n, durations, lp, size)
    want, got = _decode(ref), _decode(mine)
    np.testing.assert_array_equal(gif.read_gif(ref), want)
    np.testing.assert_array_equal(gif.read_gif(mine), got)
    return want, got


def _within_bound(got, want, src):
    """Each source frame's mean error against its decoded frame: the
    port's at most 1.10 times Pillow's plus 0.25; returns how many decoded
    frames are bit-equal."""
    at = _script().expand(want, src)
    for i, f in enumerate(src):
        f = f if f.ndim == 3 else np.repeat(f[..., None], 3, -1)
        e_ref = np.abs(want[at[i]].astype(int) - f).mean()
        e_mine = np.abs(got[at[i]].astype(int) - f).mean()
        assert e_mine <= 1.10 * e_ref + 0.25, (i, e_mine, e_ref)
    return sum(np.array_equal(a, b) for a, b in zip(got, want))


def _terrain(h, w, seed):
    return _script()._terrain(h, w, seed)


@pytest.mark.parametrize("clip", ["rgb", "gray", "pal", "rgb512"])
def test_committed_clips_against_their_digests(clip):
    """The port's GIF of each committed clip: imageio's frame count,
    durations, loop and size, the decoded frames' SHA-256 (gray and
    60-colour clips exactly; the full-colour clips within the bound, and
    bit-equal here), as chip_smoke.py checks them on the card."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)[clip]
    src = (np.stack([read_png_path(os.path.join(FIXTURES, n))
                     for n in want["frames"]]) if want["frames"]
           else _script().frames(clip))
    data = gif.encode_gif(list(src), 40)
    meta = gif.gif_meta(data)
    assert (len(meta["durations"]), meta["durations"], meta["loop"],
            list(meta["size"])) == (want["n_frames"], want["durations"],
                                    want["loop"], want["size"])
    got = gif.read_gif(data)
    shas = [hashlib.sha256(g.tobytes()).hexdigest() for g in got]
    if not clip.startswith("rgb"):
        assert shas == want["decoded_sha256"]
    at = _script().expand(got, src)
    rgb = src if src.ndim == 4 else np.repeat(src[..., None], 3, -1)
    for i, e_ref in enumerate(want["pillow_mae"]):
        e = np.abs(got[at[i]].astype(int) - rgb[i]).mean()
        assert e <= 1.10 * e_ref + 0.25
    assert shas == want["decoded_sha256"]  # bit-equal, beyond the bound


@pytest.mark.parametrize("size", [(20, 30), (1, 1), (1, 9), (17, 33),
                                  (64, 16)])
def test_gray_frames_decode_bit_equal(size):
    rnd = np.random.RandomState(sum(size))
    frames = [rnd.randint(0, 256, size).astype(np.uint8) for _ in range(3)]
    frames[1][: size[0] // 2] = 7  # a frame that differs in part
    frames.insert(2, frames[1].copy())  # merged into the one before
    want, got = _same_as_pillow(frames)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 3


@pytest.mark.parametrize("colors", [1, 2, 60, 256])
def test_few_colour_frames_decode_bit_equal(colors):
    rnd = np.random.RandomState(colors)
    pal = rnd.randint(0, 256, (colors, 3)).astype(np.uint8)
    frames = [pal[rnd.randint(0, colors, (23, 31))] for _ in range(3)]
    frames[2][5:9, 3:20] = frames[1][5:9, 3:20]
    want, got = _same_as_pillow(frames)
    np.testing.assert_array_equal(got, want)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)  # exact colours


@pytest.mark.parametrize("kind", ["terrain", "noise", "gradient",
                                  "large"])
def test_full_colour_frames_within_the_bound(kind):
    """The median cut's palettes: each frame within the bound, and the
    count of bit-equal frames (all of them here)."""
    rnd = np.random.RandomState(5)
    if kind == "terrain":
        frames = [_terrain(40, 56, s) for s in range(3)]
        frames[2][10:20, 5:30] = frames[1][10:20, 5:30]
    elif kind == "noise":
        frames = [rnd.randint(0, 256, (37, 29, 3)).astype(np.uint8)
                  for _ in range(2)]
    elif kind == "gradient":  # more than 65536 colours: buckets coarsened
        y = np.linspace(0, 255, 300)[:, None]
        x = np.linspace(0, 255, 310)[None, :]
        g = np.stack([y + 0 * x, x + 0 * y, (x * y) / 255], -1)
        frames = [np.clip(g + rnd.uniform(0, 4, g.shape), 0, 255).astype(
            np.uint8), np.clip(g[::-1] + 2, 0, 255).astype(np.uint8)]
    else:  # 512 x 520: no palette compaction
        frames = [_terrain(512, 520, s) for s in range(2)]
    want, got = _same_as_pillow(frames)
    assert _within_bound(got, want, np.stack(frames)) == len(want)


def test_quantize_gives_pillows_adaptive_palette():
    """gif.quantize against Image.convert("P", palette=ADAPTIVE): the same
    palette entries in the same order and the same index of every pixel."""
    rnd = np.random.RandomState(9)
    for img in (_terrain(33, 47, 3), rnd.randint(0, 256, (40, 41, 3)).astype(
            np.uint8), _terrain(300, 260, 4)):
        pal, idx = gif.quantize(img)
        p = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE)
        ref_pal = np.frombuffer(p.palette.tobytes(), np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pal, ref_pal[:len(pal)])
        np.testing.assert_array_equal(idx, np.asarray(p))


def test_a_single_frame_is_interlaced_as_pillow_writes_it():
    """One frame (or frames that all merge): interlaced when both sides
    are at least 16, the merged duration in its one control block."""
    frame = _terrain(33, 40, 1)
    for frames, duration in (([frame], 40), ([frame] * 3, 120)):
        data = gif.encode_gif(frames, 40)
        ref = _pillow(frames, duration=40, loop=0)
        assert _meta(data) == _meta(ref) and _meta(data)[1] == [duration]
        desc = data.index(b",", data.index(b"NETSCAPE"))
        assert data[desc + 9] & 64 and ref[ref.index(b",", ref.index(
            b"NETSCAPE")) + 9] & 64
        np.testing.assert_array_equal(gif.read_gif(data), _decode(ref))
    # a gray frame on the full ramp: Pillow reads it as L, (1, H, W)
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    data = gif.encode_gif([ramp], 40)
    assert gif.read_gif(data).shape == (1, 16, 16)
    np.testing.assert_array_equal(gif.read_gif(data), _decode(data))


def test_lzw_round_trip_through_table_resets():
    """Index streams long enough to fill the code table many times, in
    small and full alphabets, decode to themselves."""
    rnd = np.random.RandomState(0)
    lib = gif._lib()
    for n, k in ((1, 2), (5000, 4), (300000, 256), (200000, 3)):
        idx = rnd.randint(0, k, n).astype(np.uint8)
        idx[: n // 3] = idx[0]  # a long run
        data = gif._lzw(idx)
        assert data[0] == 8
        payload, end = gif._sub_blocks(data, 1)
        assert end == len(data)
        out = np.zeros(n, np.uint8)
        buf = np.frombuffer(payload, np.uint8)
        assert lib.gif_lzw_decode(buf.ctypes.data, buf.size, 8,
                                  out.ctypes.data, n) == n
        np.testing.assert_array_equal(out, idx)


def test_what_the_writer_refuses():
    a = np.zeros((4, 5), np.uint8)
    with pytest.raises(ValueError):  # np.stack of mixed shapes
        gif.encode_gif([a, np.zeros((5, 4), np.uint8)], 40)
    with pytest.raises(ValueError, match="no frames"):
        gif.encode_gif([], 40)
    with pytest.raises(NotImplementedError, match="float32"):
        gif.encode_gif([a.astype(np.float32)], 40)
    for shape in ((4, 5, 1), (4, 5, 2), (4, 5, 4)):
        with pytest.raises(NotImplementedError, match="shape"):
            gif.encode_gif([np.zeros(shape, np.uint8)], 40)
    with pytest.raises(ValueError, match="not a GIF"):
        gif.read_gif(b"GIF00a" + bytes(20))


def test_writing_without_a_host_compiler_raises(tmp_path, monkeypatch):
    """No quiet Python path: without the C++ library encoding raises."""
    from terrain_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    gif._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            gif.encode_gif([np.zeros((3, 3, 3), np.uint8)], 40)
    finally:
        gif._lib.cache_clear()


def test_committed_fixtures_match_the_script(tmp_path):
    got = _script().main(str(tmp_path))
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        assert got == json.load(f)
    for name in os.listdir(FIXTURES):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == (tmp_path / name).read_bytes(), name

"""Write the GIF writer's fixtures, tests/data/gif/, and their digests.

    python tests/make_gif_fixtures.py [directory]   # default tests/data/gif

Three small clips of PNG frames, seeded: `rgb` (full-colour terrain
frames: a heightmap beside its texture, with noise, so each frame has far
more than 256 colours), `gray` (8-bit gray) and `pal` (RGB of 60 colours);
in each, one frame repeats the frame before it.  And `rgb512`, three
full-colour frames of the clip's full size, 512 x 1024 (the second a part
of the first changed, the third the second again), which are not stored:
`frames("rgb512")` makes them from integers alone, the same bytes on any
machine.  digests.json holds, for each clip, what `imageio.v3.imwrite(path, frames, duration=40, loop=0)`
writes through Pillow: the frame count after merging, each frame's
duration, the loop count and screen size, the SHA-256 of each frame
imageio decodes from that file, and for every source frame the mean
absolute error of its decoded frame (the bound of a full-colour frame is
1.10 times that plus 0.25 grey levels); and under "reference" the Pillow
and imageio versions.  Pillow and imageio are needed here, not on the
card: chip_smoke.py's `artifacts` phase holds the port's writer to the
committed digests, and tests/test_torch_gif.py re-runs this script.
"""

import hashlib
import io
import json
import os
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(HERE, "data", "gif")
DURATION = 40
# clip -> (frame count before merging, index of the frame that repeats the
# one before it)
CLIPS = {"rgb": (5, 2), "gray": (4, 3), "pal": (3, 1), "rgb512": (3, 2)}
STORED = ("rgb", "gray", "pal")  # clips whose frames are committed PNGs


def _terrain(h, w, seed):
    """(h, w, 3) uint8: a few waves coloured like land and sea, plus noise
    of a few levels."""
    rnd = np.random.RandomState(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for _ in range(4):
        fy, fx, py, px = rnd.uniform(1, 9, 4)
        f += np.sin(fy * 6.2832 * y + py) * np.cos(fx * 6.2832 * x + px)
    t = np.clip((f - f.min()) / (f.max() - f.min()), 0, 1)
    land = t > 0.3
    img = np.stack([np.where(land, 90 + 150 * t, 20),
                    np.where(land, 110 + 120 * t, 60 + 60 * t),
                    np.where(land, 60 + 90 * t, 150 + 80 * t)], -1)
    img = img + rnd.randint(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _full_size(seed):
    """(512, 1024, 3) uint8 from integer arithmetic and RandomState's
    integers only (no floating-point function whose last bit could differ
    between machines): gradients, a pattern and noise of 24 levels."""
    rnd = np.random.RandomState(seed)
    h, w = 512, 1024
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    img = np.stack([y * 200 // h + x * 40 // w + 0 * x,
                    x * 180 // w + (y * x) % 37,
                    (h - y) * 150 // h + 60 + 0 * x], -1)
    return np.clip(img + rnd.randint(0, 24, (h, w, 3)), 0, 255).astype(
        np.uint8)


def frames(clip):
    """The clip's frames, (n, H, W[, 3]) uint8."""
    n, rep = CLIPS[clip]
    if clip == "rgb512":
        first = _full_size(40)
        second = first.copy()
        second[100:260, 300:700] = _full_size(41)[100:260, 300:700]
        return np.stack([first, second, second])
    rnd = np.random.RandomState({"rgb": 1, "gray": 2, "pal": 3}[clip])
    out = []
    for i in range(n):
        if i == rep:
            out.append(out[-1].copy())
            continue
        if clip == "rgb":
            tex = _terrain(48, 48, 10 + i)
            hm = np.repeat(tex[..., :1], 3, -1)
            out.append(np.concatenate([hm, tex], 1))
        elif clip == "gray":
            out.append(_terrain(40, 56, 20 + i)[..., 1])
        else:
            pal = np.random.RandomState(7).randint(0, 256, (60, 3))
            idx = (_terrain(33, 45, 30 + i)[..., 2].astype(int) * 60) // 256
            out.append(pal[idx].astype(np.uint8))
    return np.stack(out)


def _png(img):
    """A plain PNG (no filters) of a uint8 gray or RGB image."""
    import struct

    a = img if img.ndim == 3 else img[..., None]
    h, w, c = a.shape
    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def expand(decoded, src):
    """For each source frame, the index of its decoded frame (a frame equal
    to the one before it is merged into it)."""
    at, out = 0, []
    for i in range(len(src)):
        if i and not np.array_equal(src[i], src[i - 1]):
            at += 1
        out.append(at)
    assert at == len(decoded) - 1
    return out


def pillow_clip(src):
    """imageio's GIF of the frames, and what its reader makes of it."""
    import imageio.v3 as iio
    from PIL import Image

    buf = io.BytesIO()
    iio.imwrite(buf, list(src), extension=".gif", duration=DURATION, loop=0)
    data = buf.getvalue()
    decoded = iio.imread(data, extension=".gif")
    im = Image.open(io.BytesIO(data))
    durations = []
    for k in range(im.n_frames):
        im.seek(k)
        durations.append(im.info.get("duration"))
    return data, decoded, {"n_frames": im.n_frames, "durations": durations,
                           "loop": im.info.get("loop"),
                           "size": list(im.size)}


def reference():
    import imageio
    import PIL

    return {"pillow": PIL.__version__, "imageio": imageio.__version__}


def main(out_dir=DEFAULT_DIR):
    """Write every clip's frames and digests.json under out_dir; returns the
    digests."""
    os.makedirs(out_dir, exist_ok=True)
    digests = {"reference": reference()}
    for clip in CLIPS:
        src = frames(clip)
        names = []
        for i, f in enumerate(src if clip in STORED else ()):
            name = f"{clip}_{i}.png"
            with open(os.path.join(out_dir, name), "wb") as fh:
                fh.write(_png(f))
            names.append(name)
        data, decoded, meta = pillow_clip(src)
        at = expand(decoded, src)
        rgb = src if src.ndim == 4 else np.repeat(src[..., None], 3, -1)
        digests[clip] = {
            "frames": names, "gif_bytes": len(data), **meta,
            "decoded_sha256": [hashlib.sha256(d.tobytes()).hexdigest()
                               for d in decoded],
            "pillow_mae": [float(np.abs(decoded[at[i]].astype(np.int64)
                                        - rgb[i]).mean())
                           for i in range(len(src))]}
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


if __name__ == "__main__":
    main(*sys.argv[1:])

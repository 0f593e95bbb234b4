"""Write the JPEG fixtures of tests/data/jpeg/ and their digests.

    python tests/make_jpeg_fixtures.py [directory]   # default tests/data/jpeg

Seeded terrain-like textures (a smooth field of waves, land and ocean
colours, a little noise), written by Pillow as baseline JPEGs:
  texture_2048x1024_420.jpg  4:2:0, quality 92 (the trained texture's kind)
  texture_512x256_444.jpg    4:4:4, quality 90
  heightmap_512x256_gray.jpg grayscale, quality 95
  strip_21600x32_420_rst.jpg a full-width strip of the NASA texture's size
                             (21600 columns), 4:2:0, a restart marker after
                             every MCU row, so chip_smoke.py can repeat its
                             restart intervals into a 21600x10800 texture
and as progressive JPEGs (Pillow's scan script, libjpeg's
jpeg_simple_progression: 10 scans in colour, 6 in gray, every coefficient
refined to its last bit):
  progressive_2048x1024_420.jpg   4:2:0, quality 85
  progressive_512x256_444.jpg     4:4:4, quality 90
  progressive_512x256_422.jpg     4:2:2, quality 90
  progressive_512x256_gray.jpg    grayscale, quality 95
  progressive_strip_21600x32_420_rst.jpg   the strip's kind, progressive: a
                             DRI of one MCU row (1350 MCUs in the
                             interleaved DC scans, 2700 or 1350 blocks in
                             a component's AC scans) before every scan
  progressive_2048x1024_420_cut2.jpg, _cut3.jpg   the 2048x1024 file cut
                             after its second and third scan (EOI spliced
                             after a whole scan): coefficients still
                             unrefined, so libjpeg-turbo smooths its blocks
digests.json holds, for each, the shape and the SHA-256 of the bytes that
imageio.v3.imread decodes from it (libjpeg-turbo through Pillow, the JAX
package's reader), and under "reference" the Pillow and libjpeg-turbo
versions that decoded them (the digests were made with Pillow 12.1.0 and
libjpeg-turbo 3.1.3).  Pillow and imageio are needed here, not on the card:
chip_smoke.py holds the port's decoder to the committed digests, and
tests/test_torch_jpeg.py re-runs this script and checks them.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(HERE, "data", "jpeg")


def terrain_texture(h, w, seed):
    """(h, w, 3) uint8: a few separable waves, ~30% ocean, coloured like
    land and sea, with a noise of one level."""
    rnd = np.random.RandomState(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for _ in range(5):
        fy, fx, py, px = rnd.uniform(1, 12, 4)
        f += np.sin(fy * 6.2832 * y + py) * np.cos(fx * 6.2832 * x + px)
    f -= np.quantile(f, 0.3)
    land = f > 0
    t = np.clip(f / f.max(), 0, 1)
    r = np.where(land, 90 + 110 * t, 20 + 10 * (1 + f / -f.min()))
    g = np.where(land, 110 + 60 * t, 50 + 20 * (1 + f / -f.min()))
    b = np.where(land, 60 + 40 * t, 110 + 60 * (1 + f / -f.min()))
    img = np.stack([r, g, b], -1) + rnd.randint(0, 2, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


FIXTURES = {  # name -> (height, width, seed, Pillow's save options, gray)
    "texture_2048x1024_420.jpg": (1024, 2048, 0,
                                  dict(quality=92, subsampling=2), False),
    "texture_512x256_444.jpg": (256, 512, 1,
                                dict(quality=90, subsampling=0), False),
    "heightmap_512x256_gray.jpg": (256, 512, 2, dict(quality=95), True),
    "strip_21600x32_420_rst.jpg": (32, 21600, 3,
                                   dict(quality=90, subsampling=2,
                                        restart_marker_rows=1), False),
    "progressive_2048x1024_420.jpg": (1024, 2048, 0,
                                      dict(quality=85, subsampling=2,
                                           progressive=True), False),
    "progressive_512x256_444.jpg": (256, 512, 1,
                                    dict(quality=90, subsampling=0,
                                         progressive=True), False),
    "progressive_512x256_422.jpg": (256, 512, 4,
                                    dict(quality=90, subsampling=1,
                                         progressive=True), False),
    "progressive_512x256_gray.jpg": (256, 512, 2,
                                     dict(quality=95, progressive=True), True),
    "progressive_strip_21600x32_420_rst.jpg": (
        32, 21600, 3, dict(quality=90, subsampling=2, progressive=True,
                           restart_marker_rows=1), False),
}
CUTS = {  # name -> (the fixture it is cut from, the scans it keeps)
    "progressive_2048x1024_420_cut2.jpg": ("progressive_2048x1024_420.jpg", 2),
    "progressive_2048x1024_420_cut3.jpg": ("progressive_2048x1024_420.jpg", 3),
}


def cut_after_scan(data, k):
    """JPEG bytes ending after their k-th scan: EOI spliced in at the
    marker that follows it (a later scan's tables or SOS)."""
    starts, i = [], data.find(b"\xff\xda")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\xff\xda", i + 2)
    if k >= len(starts):
        raise ValueError(f"the file has {len(starts)} scans, not more than "
                         f"{k}")
    j = starts[k - 1]
    m = j + 2 + int.from_bytes(data[j + 2:j + 4], "big")
    while not (data[m] == 0xFF and data[m + 1] != 0x00
               and not 0xD0 <= data[m + 1] <= 0xD7):
        m += 1
    return data[:m] + b"\xff\xd9"


def encode(name):
    """The fixture's JPEG bytes."""
    from PIL import Image, ImageFile

    if name in CUTS:
        source, k = CUTS[name]
        return cut_after_scan(encode(source), k)
    # a progressive file is written whole into Pillow's buffer
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 24)
    h, w, seed, opts, gray = FIXTURES[name]
    img = terrain_texture(h, w, seed)
    if gray:
        img = img[..., 1]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def digest(pixels):
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def reference(data):
    """imageio's decode of JPEG bytes: (shape, SHA-256 of its bytes)."""
    import imageio.v3 as iio

    pixels = np.asarray(iio.imread(data))
    return list(pixels.shape), digest(pixels)


def main(out_dir=DEFAULT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    from PIL import __version__, features

    digests = {"reference": {
        "pillow": __version__,
        "libjpeg_turbo": features.version("libjpeg_turbo")}}
    for name in [*FIXTURES, *CUTS]:
        data = encode(name)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        shape, sha = reference(data)
        digests[name] = {"shape": shape, "sha256": sha, "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, decodes to {shape}")
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


if __name__ == "__main__":
    main(*sys.argv[1:])

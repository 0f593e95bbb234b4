"""Builds the paired dataset offline (tools/build_dataset.py's port, the
script form of the reference's notebooks/prototype_cropping_code.ipynb):
the same arguments, filter, split and subsets, and the same arrays, with
the port's own raster decoders (data/raster.py: PNG, JPEG with MPO, TIFF,
BMP, WebP, PNM with PFM and PAM, TGA, JPEG 2000, Radiance HDR, Sun raster,
DDS, SGI, PCX, QOI, IM, ICO, ICNS) and h5 writer (data/h5.py), so it
needs neither imageio nor h5py.

Pipeline (notebook cells 11-19, 27-48):
  1. load the NASA Visible Earth raster pair -- gebco_08_rev_elev heightmap
     PNG + world.200412 texture JPG, both 21600x10800 -- from disk;
  2. slide a crop_size window (512) at `stride` (100) over both rasters,
     discarding crops whose heightmap is >90% zeros (ocean) -- the
     `comparator` of cell 11;
  3. shuffle (RandomState(42)) and write a 90/10 train/valid split as
     uint8 NHWC xt/yt/xv/yv, each crop streamed into the file's memmap
     (cells 17-19, 27);
  4. optional color subsetting (cells 38-48): rank crops by mean-RGB MSE
     against a reference image and keep the top-k ("green500" /
     "brown500"); `--subset-valid-split` reproduces brown500_with_valid,
     while the default reproduces brown500's xv==xt quirk (cell 43).
A heightmap of another type than uint8 (a 16-bit PNG) is clipped to
0..255, as HDF5 converts it into the reference tool's uint8 datasets.

Usage:
  python -m terrain_tpu_torch.tools.build_dataset --heightmap elev.png \
      --texture tex.jpg --out textures_v2.h5 [--crop 512 --stride 100]
  python -m terrain_tpu_torch.tools.build_dataset --subset-from \
      textures_v2.h5 --ref-img brown_ref.png --top-k 240 \
      --out textures_v2_brown500.h5
"""

import argparse
import os
import sys

import numpy as np

from terrain_tpu_torch.data import h5
from terrain_tpu_torch.data.raster import read_raster


def comparator(heightmap_chunk):
    """Keep a crop unless >90% of its heightmap is zero (ocean), cell 11."""
    frac_black = float((heightmap_chunk == 0).sum()) / heightmap_chunk.size
    return frac_black <= 0.9


def get_chunks(texture, heightmap, crop_size=512, stride=100, max_n=None):
    """Yield (texture_crop (s,s,3), heightmap_crop (s,s,1)) pairs, cell 12."""
    assert texture.shape[:2] == heightmap.shape[:2]
    ctr = 0
    for y in range(0, texture.shape[0], stride):
        for x in range(0, texture.shape[1], stride):
            tex = texture[y:y + crop_size, x:x + crop_size]
            hm = heightmap[y:y + crop_size, x:x + crop_size]
            if tex.shape != (crop_size, crop_size, 3):
                continue
            if hm.ndim == 2:
                hm = hm[:, :, None]
            if not comparator(hm):
                continue
            yield tex, hm
            ctr += 1
            if max_n is not None and ctr == max_n:
                return


def _uint8(a):
    return a if a.dtype == np.uint8 else np.clip(a, 0, 255).astype(np.uint8)


def build(heightmap_path, texture_path, out_path, crop_size=512, stride=100,
          max_n=None, seed=42):
    texture = read_raster(texture_path)[..., :3]
    heightmap = read_raster(heightmap_path)
    if heightmap.ndim == 3:
        heightmap = heightmap[..., 0]
    texture, heightmap = _uint8(texture), _uint8(heightmap)
    crops = list(get_chunks(texture, heightmap, crop_size, stride, max_n))
    n = len(crops)
    print(f"number of patches detected: {n}")
    rnd = np.random.RandomState(seed)
    idxs = rnd.permutation(n)
    n_train = int(n * 0.9)
    out_dir = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(out_dir, exist_ok=True)
    s = crop_size
    f = h5.create(out_path, {
        "xt": ((n_train, s, s, 1), np.uint8),
        "yt": ((n_train, s, s, 3), np.uint8),
        "xv": ((n - n_train, s, s, 1), np.uint8),
        "yv": ((n - n_train, s, s, 3), np.uint8)})
    for j, i in enumerate(idxs):
        tex, hm = crops[i]
        if j < n_train:
            f["xt"][j], f["yt"][j] = hm, tex
        else:
            f["xv"][j - n_train], f["yv"][j - n_train] = hm, tex
    for m in f.values():
        if isinstance(m, np.memmap):
            m.flush()
    print(f"wrote {out_path}: {n_train} train / {n - n_train} valid")


def get_idxs_close_to_img(some_img, textures):
    """Rank dataset crops by mean-RGB MSE vs a reference image (cell 38)."""
    ref_rgb = np.mean(np.asarray(some_img, np.float64), axis=(0, 1),
                      keepdims=True)
    dists = [
        float(np.sum((ref_rgb - np.mean(np.asarray(textures[i], np.float64),
                                        axis=(0, 1), keepdims=True)) ** 2))
        for i in range(textures.shape[0])
    ]
    return dists, np.argsort(dists)


def build_subset(src_path, ref_img_path, out_path, top_k=240,
                 valid_split=False, seed=42):
    """Color-similarity subset (cells 39-48).  Default reproduces
    brown500's xv==xt quirk; valid_split makes a real 90/10 split."""
    ref = read_raster(ref_img_path)[..., :3]
    with h5.File(src_path) as g:
        # rank by the train textures (the notebook ranked the full db)
        _, order = get_idxs_close_to_img(ref, g["yt"])
        chosen = sorted(order[:top_k].tolist())
        xt = g["xt"][chosen]
        yt = g["yt"][chosen]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if valid_split:
        rnd = np.random.RandomState(seed)
        perm = rnd.permutation(top_k)
        n_train = int(0.9 * top_k)
        tr = sorted(perm[:n_train].tolist())
        va = sorted(perm[n_train:].tolist())
        h5.write(out_path, {"xt": xt[tr], "yt": yt[tr], "xv": xt[va],
                            "yv": yt[va]})
    else:  # xv == xt, cell 43 quirk
        h5.write(out_path, {"xt": xt, "yt": yt, "xv": xt, "yv": yt})
    print(f"wrote {out_path}: top-{top_k} subset (valid_split={valid_split})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--heightmap")
    ap.add_argument("--texture")
    ap.add_argument("--out", required=True)
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--stride", type=int, default=100)
    ap.add_argument("--max-n", type=int, default=None)
    ap.add_argument("--subset-from")
    ap.add_argument("--ref-img")
    ap.add_argument("--top-k", type=int, default=240)
    ap.add_argument("--subset-valid-split", action="store_true")
    args = ap.parse_args(argv)
    if args.subset_from:
        build_subset(args.subset_from, args.ref_img, args.out, args.top_k,
                     args.subset_valid_split)
    else:
        build(args.heightmap, args.texture, args.out, args.crop, args.stride,
              args.max_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())

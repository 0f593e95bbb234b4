"""Tile the first k*k generated samples into one contact sheet
(tools/make_gen_sheet.py's port: the same arguments, messages and exit
codes, on the port's PNG codec, serve/png.py).

Usage: python -m terrain_tpu_torch.tools.make_gen_sheet <gen_dir>
           <out.png> [--k 5]
"""

import argparse
import glob
import os

import numpy as np

from terrain_tpu_torch.serve.png import read_png_path, write_png_path


def sheet(imgs, cols, rows):
    """imgs of one shape into a rows x cols grid, row by row; cells past
    the last image stay zero."""
    h, w = imgs[0].shape[:2]
    out = np.zeros((rows * h, cols * w) + imgs[0].shape[2:], imgs[0].dtype)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        out[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gen_dir")
    ap.add_argument("out")
    ap.add_argument("--k", type=int, default=5)
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.gen_dir, "*.png")))
    files = files[: args.k * args.k]
    if not files:
        raise SystemExit(f"no PNGs under {args.gen_dir}")
    imgs = [read_png_path(f) for f in files]
    for f, im in zip(files, imgs):
        if im.shape != imgs[0].shape:
            raise SystemExit(
                f"{f}: shape {im.shape} != first tile's {imgs[0].shape} "
                f"({files[0]}) — mixed-size/channel gen dir")
    write_png_path(args.out, sheet(imgs, args.k, args.k))
    print(f"gen sheet: {len(imgs)} tiles -> {args.out}")


if __name__ == "__main__":
    main()

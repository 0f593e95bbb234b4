"""Assemble a filmstrip PNG from interpolation-clip frames
(tools/make_filmstrip.py's port: the same arguments, picks, messages and
exit codes, on the port's PNG codec, serve/png.py).

Usage: python -m terrain_tpu_torch.tools.make_filmstrip <frames_dir>
           <out.png> [--k 8] [--pattern "concat_*.png"]
k evenly spaced frames side by side; an unreadable frame (a truncated one
from an interrupted run) is skipped.
"""

import argparse
import glob
import os

import numpy as np

from terrain_tpu_torch.serve.png import read_png_path, write_png_path


def picks(files, k):
    """k of `files`, evenly spaced, the first and last among them."""
    k = min(k, len(files))
    return [files[round(i * (len(files) - 1) / max(k - 1, 1))]
            for i in range(k)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("out")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--pattern", default="concat_*.png")
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.frames_dir, args.pattern)))
    if not files:
        raise SystemExit(f"no frames matching {args.pattern} in "
                         f"{args.frames_dir}")
    imgs = []
    for f in picks(files, args.k):
        try:
            imgs.append(read_png_path(f))
        except Exception:  # truncated frame from an interrupted run
            pass
    if not imgs:
        raise SystemExit("no readable frames")
    strip = np.concatenate(imgs, axis=1)
    write_png_path(args.out, strip)
    print(f"filmstrip: {len(imgs)} of {len(files)} frames -> {args.out}")


if __name__ == "__main__":
    main()

"""Quality anchor against the reference's PUBLISHED samples
(tools/compare_published.py's port: the same arguments and table rows).

The reference ships its publication-epoch ground truth: 20 real 512px DCGAN
heightmap samples (test1_repeatnod_fixp2p_nobn/dump_a_bakup_593ish/
0..19.png of its output, grayscale replicated to RGB, saved at ~epoch 593
of 1000).  This tool computes the SWD pyramid (eval/swd.py) and the
terrain W1 statistics (eval/terrain.py) between a directory of generated
heightmap PNGs and those files, at matched scale, on the card (`--device
cpu` or TERRAIN_PLATFORM=cpu for the CPU).  The PNGs are decoded by
serve/png.py, the scale is matched by eval/resize.py (jax.image.resize's
antialiased bilinear), and `--real-h5` is read by data/h5.py, so it needs
neither imageio, h5py nor JAX.  Those files are not part of this
repository: `--ref-dir` names the directory that holds them, and has no
default.

Caveats (print with any table):
  * training data differs -- the reference trained on real NASA 512px
    crops, the repo's 512px runs train on synthetic terrain and the
    earth256* runs on real 256px crops;
  * 20 published samples is a small set -- the same-size generated subset
    is used, and a split of each set against itself is printed as a noise
    floor.

Usage:
  python -m terrain_tpu_torch.tools.compare_published <gen_dir>
      --ref-dir <published PNGs> [--scale 512|256]
      [--real-h5 data/earth256.h5] [--seed 0] [--device cuda|cpu]
"""

import argparse
import glob
import os
import sys

import numpy as np
import torch

from terrain_tpu_torch.data import h5
from terrain_tpu_torch.device import platform_device, resolve_device
from terrain_tpu_torch.eval.resize import resize_bilinear
from terrain_tpu_torch.eval.swd import swd_pyramid
from terrain_tpu_torch.eval.terrain import terrain_stats
from terrain_tpu_torch.serve.png import decode_png

def load_gray_pngs(path, limit=None):
    """(N, H, W, 1) float32 in [0,1] from a dir of PNGs (RGB -> first
    channel; the published files replicate gray to RGB)."""
    files = sorted(glob.glob(os.path.join(path, "*.png")),
                   key=lambda p: (len(os.path.basename(p)), p))
    if limit:
        files = files[:limit]
    if not files:
        raise SystemExit(f"no PNGs under {path}")
    imgs = []
    for f in files:
        with open(f, "rb") as fh:
            im = decode_png(fh.read())[..., 0]
        imgs.append(im.astype(np.float32) / 255.0)
    shapes = {i.shape for i in imgs}
    if len(shapes) != 1:
        raise SystemExit(f"mixed sample shapes under {path}: {shapes}")
    return np.stack(imgs)[..., None]


def to_scale(x, size, device):
    """(N, H, W, C) numpy -> an fp32 tensor on `device` at size x size."""
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if x.shape[1] == size:
        return x
    return resize_bilinear(x, size, size)


def metrics(a, b, seed):
    out = dict(swd_pyramid(a, b, seed=seed))
    out.update(terrain_stats(a, b, seed=seed))
    return out


def row(label, a, b, seed):
    m = metrics(a, b, seed)
    print(f"{label:38s} swd_mean={m['swd_mean']:.4f} "
          f"elev_w1={m['elev_w1']:.4f} slope_w1={m['slope_w1']:.4f} "
          f"levels=[" + ", ".join(
              f"{m[f'swd_level{i}']:.4f}"
              for i in range(sum(1 for k in m if k.startswith('swd_level')))
          ) + "]")
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gen_dir", help="dir of repo-generated heightmap PNGs")
    ap.add_argument("--ref-dir", required=True,
                    help="dir of the published heightmap PNGs")
    ap.add_argument("--scale", type=int, default=512,
                    help="compare at this resolution (downscales both)")
    ap.add_argument("--real-h5", default=None,
                    help="optional h5 with xt heightmaps for real-data rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=platform_device(),
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ref = to_scale(load_gray_pngs(args.ref_dir), args.scale, device)
    gen = to_scale(load_gray_pngs(args.gen_dir), args.scale, device)
    n = min(len(ref), len(gen))
    print(f"# repo-vs-published anchor @ {args.scale}px, n={n} per side")
    print("# caveat: training data differs (published = real NASA 512px; "
          "repo 512px = synthetic terrain, earth256* = real 256px crops)")
    row("published-ref vs repo-gen", ref[:n], gen[:n], args.seed)
    # noise floors: split each set against itself (half vs half)
    h = max(2, n // 2)
    if len(gen) >= 2 * h:
        row("repo-gen split (noise floor)", gen[:h], gen[h:2 * h], args.seed)
    row("published split (noise floor)", ref[:10], ref[10:20], args.seed)
    if args.real_h5:
        with h5.File(args.real_h5) as f:
            xt = f["xt"][:2 * n].astype(np.float32) / 255.0
        if xt.ndim == 3:
            xt = xt[..., None]
        elif xt.shape[-1] != 1:
            xt = xt[..., :1]
        xt = to_scale(xt, args.scale, device)
        row("published-ref vs real-data crops", ref[:n], xt[:n], args.seed)
        row("repo-gen vs real-data crops", gen[:n], xt[:n], args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Collect the artifacts of a training run that a reader looks at
(tools/pack_artifacts.py's port: the same arguments, picks and messages,
on the port's PNG codec, serve/png.py).

Copies results.txt and swd.txt (the last row of each epoch, sorted, torn
rows dropped: byte-equal to the repository tool's), the arch_*.png
diagrams, the first, middle and last out_<e>.png, and assembles the
(up to 20) dump_a samples into dump_a_final.png, 5 to a row.

Usage: python -m terrain_tpu_torch.tools.pack_artifacts output/<name>
           <dst_dir>
"""

import glob
import os
import re
import shutil
import sys

from terrain_tpu_torch.serve.png import read_png_path, write_png_path
from terrain_tpu_torch.tools.make_gen_sheet import sheet


def _copy_dedup(src, dst):
    """Copy an epoch-keyed CSV keeping the LAST row per epoch, sorted.

    `resume='auto'` appends from the checkpoint epoch, so a restart can
    re-log epochs already present (e.g. ckpt at e90, rows to e109): the
    resumed trajectory's rows are the authoritative ones."""
    with open(src) as f:
        lines = f.read().splitlines()
    header = [ln for ln in lines if not ln[:1].isdigit()]
    n_cols = len(header[0].split(",")) if header else None
    rows = {}
    for ln in lines:
        first = ln.split(",", 1)[0]
        # torn appends (a killed writer's partial row interleaved with the
        # resumed writer's) show up as wrong column counts / junk epochs
        if (first.isdigit() and int(first) < 10 ** 6
                and (n_cols is None or len(ln.split(",")) == n_cols)):
            rows[int(first)] = ln
    with open(dst, "w") as f:
        f.write("\n".join(header + [rows[e] for e in sorted(rows)]) + "\n")


def _epochs(pattern):
    out = []
    for p in glob.glob(pattern):
        m = re.search(r"(\d+)", os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def _grid_from_dir(d, dst):
    """Assemble the per-epoch dump_a samples (single PNGs) into one sheet."""
    files = sorted(glob.glob(os.path.join(d, "*.png")))[:20]
    if not files:
        return False
    imgs = [read_png_path(f) for f in files]
    cols = 5
    write_png_path(dst, sheet(imgs, cols, (len(imgs) + cols - 1) // cols))
    return True


def main(src, dst):
    os.makedirs(dst, exist_ok=True)
    for name in ("results.txt", "swd.txt"):
        p = os.path.join(src, name)
        if os.path.exists(p):
            _copy_dedup(p, os.path.join(dst, name))
    for p in glob.glob(os.path.join(src, "arch_*.png")):
        shutil.copy2(p, dst)
    outs = _epochs(os.path.join(src, "out_*.png"))
    # dict.fromkeys dedupes when <3 grids exist (first==mid==last)
    for e, p in dict.fromkeys(
            [outs[0], outs[len(outs) // 2], outs[-1]] if outs else []):
        shutil.copy2(p, dst)
    # dump_a is flat (20 samples, overwritten every epoch): pack the final
    # state as one sheet
    ok = _grid_from_dir(os.path.join(src, "dump_a"),
                        os.path.join(dst, "dump_a_final.png"))
    print(f"packed {src} -> {dst} (dump_a sheet: {ok})")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

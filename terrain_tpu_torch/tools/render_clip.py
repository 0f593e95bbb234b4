"""Assemble interpolation frames into an animated GIF
(tools/render_clip.py's port: the same arguments, messages and exit codes,
on the port's PNG codec and GIF writer, serve/png.py and serve/gif.py).

  python -m terrain_tpu_torch.tools.render_clip output/<name>/interp_clip \
      clip.gif --fps 25

An unreadable frame (a truncated one from an interrupted run) is skipped.
The frames are read on host threads, in order.
An .mp4 needs ffmpeg, which the port does not ship: it is refused by name
after the frames are read, where the repository tool fails without an
ffmpeg backend.
"""

import argparse
import concurrent.futures
import glob
import os

from terrain_tpu_torch.serve.gif import write_gif
from terrain_tpu_torch.serve.png import read_png_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("out", help=".gif (an .mp4 needs ffmpeg, which the "
                                "port does not ship)")
    ap.add_argument("--fps", type=int, default=25)
    ap.add_argument("--pattern", default="concat_*.png")
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.frames_dir, args.pattern)))
    if not files:
        raise SystemExit(f"no frames matching {args.pattern} in "
                         f"{args.frames_dir}")
    def read(f):
        try:
            return read_png_path(f)
        except Exception:  # truncated frame from an interrupted run
            return None

    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        read_all = list(pool.map(read, files))
    frames = [f for f in read_all if f is not None]
    skipped = len(files) - len(frames)
    if skipped:
        print(f"skipped {skipped} unreadable frame(s)")
    if not frames:
        raise SystemExit("no readable frames")
    if not args.out.endswith(".gif"):
        raise NotImplementedError(
            f"{args.out}: the port writes .gif clips only; a video needs "
            f"ffmpeg (imageio's ffmpeg or pyav plugin), which the port does "
            f"not ship")
    write_gif(args.out, frames, 1000 // args.fps)
    print(f"wrote {args.out} ({len(frames)} frames @ {args.fps} fps)")


if __name__ == "__main__":
    main()

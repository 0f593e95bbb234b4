"""Print the quality-best checkpoint of a run, from its swd.txt
(tools/pick_epoch.py's port: the same output and exit codes, on
train/checkpoint.pick_best_epoch, the picker the gen and interp modes use
under TERRAIN_PICK=swd).

Usage: python -m terrain_tpu_torch.tools.pick_epoch <out_dir> <model_dir>
           [--metric swd_mean|p2p_swd_mean|both]
Prints the checkpoint's path on stdout (details on stderr); exits 1 if the
run has no usable swd.txt or checkpoints.
"""

import argparse
import sys

from terrain_tpu_torch.train.checkpoint import pick_best_epoch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="run output dir (holds swd.txt)")
    ap.add_argument("model_dir", help="run model dir (holds <epoch>.model)")
    ap.add_argument("--metric", default="swd_mean",
                    choices=("swd_mean", "p2p_swd_mean", "both"))
    args = ap.parse_args(argv)
    pick = pick_best_epoch(args.out_dir, args.model_dir, metric=args.metric)
    if pick is None:
        print(f"no usable swd.txt/checkpoints under {args.out_dir} / "
              f"{args.model_dir}", file=sys.stderr)
        return 1
    path, ckpt_epoch, best_epoch, value = pick
    print(f"{args.metric} best @e{best_epoch} = {value:.4f} -> "
          f"checkpoint e{ckpt_epoch}", file=sys.stderr)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

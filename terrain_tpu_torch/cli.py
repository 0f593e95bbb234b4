"""CLI: `python -m terrain_tpu_torch <experiment> <mode> [--device cpu]`
with mode in {train, interp, gen}, terrain_tpu's two-argument interface
(terrain_tpu/cli.py).  Runs on the card unless `--device cpu` is given (or
TERRAIN_PLATFORM=cpu, terrain_tpu's switch), and raises without one.
Turns TF32 off, as the fp32 path needs."""

import argparse
import sys


def main(argv=None):
    from terrain_tpu_torch.device import platform_device
    from terrain_tpu_torch.experiments import EXPERIMENTS

    ap = argparse.ArgumentParser(
        prog="python -m terrain_tpu_torch",
        description="Train a two-stage terrain GAN, or sample from a "
                    "trained one.")
    ap.add_argument("experiment", choices=sorted(EXPERIMENTS))
    ap.add_argument("mode", choices=("train", "interp", "gen"))
    ap.add_argument("--device", default=platform_device(),
                    choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import run

    strict_fp32()
    run(args.experiment, args.mode, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

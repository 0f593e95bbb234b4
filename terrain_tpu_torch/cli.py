"""CLI: `python -m terrain_tpu_torch <experiment> <mode> [--device cpu]`
with mode in {train, interp, gen}, terrain_tpu's two-argument interface
(terrain_tpu/cli.py).  Runs on the card unless `--device cpu` is given (or
TERRAIN_PLATFORM=cpu, terrain_tpu's switch), and raises without one.
Sets the fp32 path's numerics (device.strict_fp32).  Under torchrun
(`torchrun --nproc_per_node=N -m terrain_tpu_torch <experiment> train`)
it joins the process group (parallel.initialize: NCCL on the card, gloo on
the CPU) and trains data-parallel; alone it runs one process."""

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
    from terrain_tpu_torch.parallel import initialize

    strict_fp32()
    initialize(device=args.device)
    run(args.experiment, args.mode, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

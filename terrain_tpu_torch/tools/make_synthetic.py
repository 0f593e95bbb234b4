"""Write a synthetic reference-layout dataset for smoke runs and benchmarks
(tools/make_synthetic.py's port: the same arguments, the same arrays),
with data/h5.py's writer.

Usage: python -m terrain_tpu_torch.tools.make_synthetic out.h5 [--n 240]
           [--n-valid 24] [--size 512] [--seed 0]
"""

import argparse
import sys

from terrain_tpu_torch.data.synthetic import write_h5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=240)
    ap.add_argument("--n-valid", type=int, default=24)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_h5(args.out, n_train=args.n, n_valid=args.n_valid, size=args.size,
             seed=args.seed)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

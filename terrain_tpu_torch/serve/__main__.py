"""CLI: `python -m terrain_tpu_torch.serve <experiment> [checkpoint] [options]`.

Builds the named experiment's generators on the card, loads a
terrain_tpu/v1 checkpoint (default: the latest `<epoch>.model` in the
experiment's model dir, or epoch N with TERRAIN_PICK=N, resolved as the
training CLI's gen/interp modes resolve it), turns TF32 off and serves them.
Options:

  --device D      cuda (default; raises without a card) or cpu (the
                  default under TERRAIN_PLATFORM=cpu)
  --host H        bind address (default 127.0.0.1)
  --port P        port (default 7642; 0 = ephemeral)
  --max-batch N   device batch ceiling / bucket cap (default 8)
  --wait-ms W     micro-batch coalescing window (default 2.0)
  --no-weights    serve the seeded random weights (smoke/benchmark)
  --png-level N   zlib effort for "enc": "png" responses (default 3)
  --warmup        run every bucket once before serving
"""

import argparse
import os


def main(argv=None):
    from terrain_tpu_torch.device import platform_device
    from terrain_tpu_torch.experiments import EXPERIMENTS

    ap = argparse.ArgumentParser(
        prog="python -m terrain_tpu_torch.serve",
        description="Serve a two-stage terrain GAN over TCP on the card.")
    ap.add_argument("experiment", choices=EXPERIMENTS)
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--device", default=platform_device(),
                    choices=("cuda", "cpu"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7642)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--wait-ms", type=float, default=2.0)
    ap.add_argument("--no-weights", action="store_true")
    ap.add_argument("--png-level", type=int, default=3)
    ap.add_argument("--warmup", action="store_true")
    args = ap.parse_args(argv)

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import _resolve_model, build_model
    from terrain_tpu_torch.serve import TerrainServer

    strict_fp32()
    model, name = build_model(args.experiment, args.device)
    if not args.no_weights:
        path = args.checkpoint or _resolve_model(os.path.join(
            os.environ.get("TERRAIN_MODELS", "models"), name))
        print(f"loading weights: {path}")
        model.load_model(path)
    server = TerrainServer(model, args.host, args.port,
                           max_batch=args.max_batch, wait_ms=args.wait_ms,
                           png_level=args.png_level)
    if args.warmup:
        server.warmup(verbose=True)
    print(f"serving {args.experiment} on {server.host}:{server.port} "
          f"({model.device}, max_batch={args.max_batch})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

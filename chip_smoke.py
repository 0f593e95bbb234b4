#!/usr/bin/env python3
"""Drive terrain_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):
  1. card: its name and power limit (nvidia-smi), torch/CUDA versions, and
     the nvcc build of every kernel from csrc/ (timed);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, in fp32 and bf16, at the main path's shapes and a small ragged
     one; max-abs error against a stated tolerance, and times (CUDA
     events, median of 30 launches after warm-up) of the kernel, the plain
     version and one PyTorch library call for the same function, beside
     the least time the card could take;
  3. the slice: test1_nobn_bilin_both's generators at full width (512px,
     latent 1000) with seeded random weights -- the repository holds no
     trained checkpoint, so this is the server's --no-weights mode --
     behind the port's TerrainServer, warmed up on every bucket, answering
     gz/atob/interp requests (npy and png, det and stoch, streamed, and
     concurrent clients that the batcher coalesces) through the port's
     TerrainClient; the launch counters, reset just before, must show
     bilinear_conv twice and conv_thin once per two-stage dispatch;
  4. agreement: one fixed z (N=1, det, fp32) through the slice on the card
     and through the same weights on the CPU (plain versions).
The last lines are the `kernels` JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EXPERIMENT = "test1_nobn_bilin_both"
F32_PEAK = 67e12     # H100 SXM fp32 CUDA cores, FLOP/s
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12     # H100 SXM HBM3, bytes/s
F32_TOL = 1e-4       # x max|ref|: fp32 sums in another order
BF16_TOL = 2e-2      # x max|ref|: both round an fp32 sum to bf16 (2^-8
                     # relative); a differing last bit is one ulp
AGREE_TOL = 1e-3     # card vs CPU, full width: fp32 through ~20 layers,
                     # outputs bounded to [0,1] and [-1,1]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=30, warm=3):
    """Median of per-launch CUDA-event times, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
def kernel_cases(torch):
    """(kernel, shape label, input maker, kernel fn, plain fn, library fn,
    flops, bytes) for every shape checked; the first case of each kernel is
    the main path's shape."""
    import torch.nn.functional as F

    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_thin as ct

    def thin(n, h, w, c, f):
        def make(dt, g):
            x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dt)
            wt = (torch.randn((3, 3, c, f), generator=g, device="cuda")
                  / (9 * c) ** 0.5).to(dt)
            return (x, wt)

        def lib(x, wt):
            return F.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                            padding=1)

        def nbytes(dt):
            es = torch.finfo(dt).bits // 8
            return es * (n * h * w * c + 9 * c * f + n * h * w * f)

        return ("conv_thin", (n, h, w, c, f), make, ct.conv_thin,
                ct.conv_thin_plain, lib, 2.0 * n * h * w * 9 * c * f, nbytes)

    def bil(n, h, w, c, f):
        def make(dt, g):
            x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dt)
            wt = (torch.randn((3, 3, c, f), generator=g, device="cuda")
                  / (9 * c) ** 0.5).to(dt)
            b = torch.randn((f,), generator=g, device="cuda") * 0.1
            return (x, wt, b)

        def lib(x, wt, b):
            up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                               mode="bilinear", align_corners=False)
            return F.conv2d(up, wt.permute(3, 2, 0, 1), b.to(x.dtype),
                            padding=1)

        def nbytes(dt):
            es = torch.finfo(dt).bits // 8
            return (es * (n * h * w * c + 9 * c * f + n * 4 * h * w * f)
                    + 4 * f)

        return ("bilinear_conv", (n, h, w, c, f), make, bc.bilinear_conv,
                bc.bilinear_conv_plain, lib,
                2.0 * n * 4 * h * w * 9 * c * f, nbytes)

    return [thin(4, 256, 256, 64, 4), thin(3, 37, 45, 24, 3),
            bil(4, 64, 64, 512, 128), bil(4, 128, 128, 256, 64),
            bil(2, 21, 27, 24, 16)]


def check_kernels(torch):
    results = {}
    g = torch.Generator(device="cuda").manual_seed(1234)
    for name, shape, make, kern, plain, lib, flops, nbytes in \
            kernel_cases(torch):
        for dt, peak, tol in ((torch.float32, F32_PEAK, F32_TOL),
                              (torch.bfloat16, BF16_PEAK, BF16_TOL)):
            args = make(dt, g)
            ref = plain(*args).float()
            out = kern(*args)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dt:
                fail(f"{name} {shape}: {tuple(out.shape)} {out.dtype}")
            err = (out.float() - ref).abs().max().item()
            lim = tol * ref.abs().max().item()
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args))
            lib_ms = time_ms(lambda: lib(*args))
            t_ops, t_bytes = flops / peak * 1e3, nbytes(dt) / HBM_BW * 1e3
            row = dict(shape=shape, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, tol=lim, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
            print(f"kernel {name} {shape} {row['dtype']}: max_abs_err "
                  f"{err:.3e} (tol {lim:.3e}) ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
            if not err <= lim:
                fail(f"{name} {shape} {dt}: error {err} > {lim}")
            results.setdefault(name, []).append(row)
    return results


# ------------------------------------------------------------------ phase 3
def serve_slice(torch, card):
    import numpy as np

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_model
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.serve import TerrainServer

    strict_fp32()
    t0 = time.perf_counter()
    pipe, _ = build_model(EXPERIMENT, "cuda", seed=0,
                          compute_dtype=torch.float32)
    calls = {"two_stage": 0, "atob": 0}

    def counted(fn, key):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    for attr, key in (("two_stage_det", "two_stage"),
                      ("two_stage_stoch", "two_stage"),
                      ("atob_det", "atob"), ("atob_stoch", "atob")):
        setattr(pipe, attr, counted(getattr(pipe, attr), key))
    server = TerrainServer(pipe, port=0, max_batch=8).start_background()
    try:
        server.warmup()
        torch.cuda.synchronize()
        print(f"slice: built and warmed buckets 1..8 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ct.KERNEL.launches = bc.KERNEL.launches = 0
        calls.update(two_stage=0, atob=0)
        lat, n_req, n_img, t_run = _requests(server, np, pipe)
        launches = {"conv_thin": ct.KERNEL.launches,
                    "bilinear_conv": bc.KERNEL.launches}
        stats = dict(calls)
    finally:
        server.shutdown()
    print(f"slice: {n_req} requests, {n_img} images, two-stage dispatches "
          f"{stats['two_stage']}, atob dispatches {stats['atob']}, "
          f"launches {launches}", flush=True)
    if stats["two_stage"] == 0 or stats["atob"] == 0:
        fail("the requests did not reach both samplers")
    if launches["conv_thin"] != stats["two_stage"]:
        fail("conv_thin: expected one launch per two-stage dispatch")
    if launches["bilinear_conv"] != 2 * (stats["two_stage"] + stats["atob"]):
        fail("bilinear_conv: expected two launches per U-Net forward")
    p50 = statistics.median(lat)
    print(f"slice [{card}]: p50 latency of a 1-image det npy gz request "
          f"{p50 * 1e3:.1f} ms; {n_img / t_run:.2f} images/s over the "
          f"whole request phase; concurrency burst in the line above",
          flush=True)
    return pipe, launches


def _check_pair(np, h, t, n, size):
    if h.shape != (n, size, size, 1) or t.shape != (n, size, size, 3):
        fail(f"bad shapes {h.shape} {t.shape}")
    for a, lo, hi in ((h, 0.0, 1.0), (t, -1.0, 1.0)):
        if not np.isfinite(a).all() or a.min() < lo or a.max() > hi:
            fail(f"values outside [{lo}, {hi}] or not finite")


def _requests(server, np, pipe):
    from terrain_tpu_torch.serve import TerrainClient

    size = pipe.in_shp
    lat, n_req, n_img = [], 0, 0
    t_start = time.perf_counter()
    with TerrainClient(server.host, server.port) as cl:
        for _ in range(8):  # latency: sequential 1-image requests
            t0 = time.perf_counter()
            h, t = cl.generate(1, seed=11)
            lat.append(time.perf_counter() - t0)
            _check_pair(np, h, t, 1, size)
            n_req, n_img = n_req + 1, n_img + 1
        for n, det, enc in ((4, True, "npy"), (1, False, "npy"),
                            (4, False, "npy"), (1, True, "png"),
                            (4, True, "png"), (4, False, "png")):
            h, t = cl.generate(n, seed=5, deterministic=det, enc=enc)
            _check_pair(np, h, t, n, size)
            n_req, n_img = n_req + 1, n_img + n
        h_ref, t_ref = cl.generate(2, seed=7)
        t_png = cl.generate(2, seed=7, enc="png")[1]
        if np.abs(t_png - t_ref).max() > 0.5 / 127.5 + 1e-6:
            fail("png texture beyond its documented u8 quantization")
        tex = cl.texture_for(h_ref)
        _check_pair(np, h_ref, tex, 2, size)
        if np.abs(tex - t_ref).max() > 1e-5:
            fail("atob of the gz heightmaps differs from the gz textures")
        frames = list(cl.iter_interpolate(seed=3, steps=10))
        hs = np.concatenate([f[1] for f in frames])
        ts = np.concatenate([f[2] for f in frames])
        _check_pair(np, hs, ts, 10, size)
        n_req, n_img = n_req + 4, n_img + 16
    # concurrency burst: 8 clients x 2 requests of 1 image
    errs, res = [], []
    barrier = threading.Barrier(8)

    def worker(i):
        try:
            with TerrainClient(server.host, server.port) as c:
                barrier.wait(timeout=60)
                for k in range(2):
                    res.append(c.generate(1, seed=100 + 2 * i + k))
        except Exception as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    b0 = server.batcher.snapshot()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    burst = time.perf_counter() - t0
    b1 = server.batcher.snapshot()
    if errs or len(res) != 16 or any(th.is_alive() for th in ths):
        fail(f"concurrent clients: {errs[:1]}")
    for h, t in res:
        _check_pair(np, h, t, 1, size)
    batches = b1["batches"] - b0["batches"]
    print(f"slice: burst of 16 one-image requests from 8 clients ran in "
          f"{batches} batches, {16 / burst:.2f} images/s", flush=True)
    if batches >= 16:
        fail("the batcher coalesced no concurrent requests")
    n_req, n_img = n_req + 16, n_img + 16
    return lat, n_req, n_img, time.perf_counter() - t_start


def device_breakdown(torch, pipe, card):
    """Device time of the samplers per bucket (CUDA events, median of 10),
    and one profiled bucket-8 two-stage dispatch: kernel time by name and
    the device's busy share of the dispatch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(5)
    for n in (1, 4, 8):
        z = torch.rand((n, pipe.latent_dim), generator=g, device="cuda")
        x = torch.rand((n, pipe.in_shp, pipe.in_shp, 1), generator=g,
                       device="cuda")
        two = time_ms(lambda: pipe.two_stage_det(z), reps=10, warm=2)
        dc = time_ms(lambda: pipe.z_det(z), reps=10, warm=2)
        un = time_ms(lambda: pipe.atob_det(x), reps=10, warm=2)
        print(f"device [{card}] bucket {n}: two-stage det {two:.3f} ms "
              f"({n / two * 1e3:.1f} images/s), DCGAN G {dc:.3f} ms, "
              f"U-Net G {un:.3f} ms", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.two_stage_det(z)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only: CPU ops carry their kernels' time too
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if dev > 0:
            rows.append((dev, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    print(f"profile bucket 8 two-stage det: wall {wall:.3f} ms, device "
          f"kernels {busy:.3f} ms (busy share {busy / wall:.3f})", flush=True)
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev:9.3f} ms  x{count:<4d} {key[:100]}")


# ------------------------------------------------------------------ phase 4
def agreement(torch, pipe):
    import numpy as np

    from terrain_tpu_torch.experiments import build_model

    cpu, _ = build_model(EXPERIMENT, "cpu", seed=1,
                         compute_dtype=torch.float32)
    cpu.dcgan_gen.load_state_dict(pipe.dcgan_gen.state_dict())
    cpu.p2p_gen.load_state_dict(pipe.p2p_gen.state_dict())
    z = np.random.RandomState(2024).rand(1, pipe.latent_dim) \
        .astype(np.float32)
    a_g, b_g = pipe.two_stage_det(torch.from_numpy(z).cuda())
    a_c, b_c = cpu.two_stage_det(torch.from_numpy(z))
    errs = [(x.cpu() - y).abs().max().item() for x, y in
            ((a_g, a_c), (b_g, b_c))]
    print(f"agreement card vs CPU (N=1, det, fp32): heightmap max_abs_err "
          f"{errs[0]:.3e}, texture {errs[1]:.3e} (tol {AGREE_TOL}); "
          f"heightmap range [{a_c.min():.4f}, {a_c.max():.4f}], texture "
          f"[{b_c.min():.4f}, {b_c.max():.4f}]", flush=True)
    if not max(errs) <= AGREE_TOL:
        fail("card and CPU outputs disagree")


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    sys.path.insert(0, HERE)
    try:
        from terrain_tpu_torch.device import strict_fp32
        from terrain_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"FAIL: terrain_tpu_torch is not beside this script ({e})")
        return 3
    strict_fp32()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {', '.join(report)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (path, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    rows = check_kernels(torch)
    pipe, launches = serve_slice(torch, card)
    device_breakdown(torch, pipe, card)
    agreement(torch, pipe)

    replaces = {
        "conv_thin": "terrain_tpu/ops/pallas/conv_thin.py:182",
        "bilinear_conv": "terrain_tpu/ops/pallas/bilinear_conv.py:145",
    }
    kernels = []
    for name in ("bilinear_conv", "conv_thin"):
        main_row = rows[name][0]  # main path shape, fp32 (the served dtype)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"terrain_tpu_torch/ops/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               if r["dtype"] == "float32"),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

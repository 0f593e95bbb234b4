#!/usr/bin/env python3
"""Drive terrain_tpu_torch's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py kernels train   # some phases only, no result lines

Phases (any failure exits non-zero and prints no result line):
  1. card: its name and power limit (nvidia-smi), torch/CUDA versions, and
     the nvcc build of every kernel from csrc/ (timed, one nvcc per source,
     all started together);
  2. kernels: each of the seven CUDA kernels against its plain PyTorch
     version on the card, in fp32 and bf16, at the main paths' shapes and
     small ragged ones; max-abs error against a stated tolerance, and times
     (CUDA events, median of 30 launches after warm-up) of the kernel, the
     plain version and one PyTorch library call for the same function,
     beside the least time the card could take.  Then the three
     differentiable ops (conv_thin, conv_stem, bilinear_conv) on CUDA
     tensors against autograd of their plain versions: the gradients must
     exist and agree; and the bilinear_conv backward (PyTorch ops, as it is
     XLA code in the JAX package) timed as an op;
  3. serve: test1_nobn_bilin_both's generators at full width (512px,
     latent 1000) with seeded random weights -- the repository holds no
     trained checkpoint, so this is the server's --no-weights mode --
     behind the port's TerrainServer, warmed up on every bucket, answering
     gz/atob/interp requests (npy and png, det and stoch, streamed, and
     concurrent clients that the batcher coalesces) through the port's
     TerrainClient; the launch counters, reset just before, must show
     bilinear_conv twice and conv_thin once per two-stage dispatch; then
     one fixed z (N=1, det, fp32) through the samplers on the card and
     through the same weights on the CPU (plain versions);
  4. train: the flagship four-network train step built through
     experiments.build_train at full width (512px, latent 1000, batch 4,
     seeded weights and a seeded synthetic batch), in fp32 and with bf16
     compute over fp32 parameters: a warm-up step, then timed steps with
     the launch counters set to 0 just before and read just after (per
     step: conv_stem fwd 2, dW 1, dX 1; conv_thin fwd, dX, dW 1 each;
     bilinear_conv 2 and its backward 2), finite losses, every parameter of
     all four networks changed, step time, images/s, peak memory, and a
     profiled step by kernel; then one step of the 256px configuration on
     the card (kernels) and on the CPU (plain versions) from the same
     weights and batch: losses, gradients and updated weights.
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
AGREE_EXPERIMENT = "earth256"
# Two images: with one, every BatchNorm over a 1x1 map (the U-Net's
# bottleneck, the DCGAN generator's dense layer) normalises a single value,
# and the gradients in front of it are rounding noise times 1/sqrt(eps).
AGREE_BATCH = 2
AGREE_LOSS_TOL = 1e-3   # relative, each of the five losses, fp32
# One rmsprop step from zero state moves a weight by lr*g/sqrt(0.1*g^2+1e-6),
# about lr*3.16*sign(g) = 3.16e-4 whatever |g| is, so a gradient that is
# zero up to rounding may flip its sign between the card and the CPU and
# move its weight the other way.  The updated weights are therefore held to
# a share (few may differ by more than 1e-5), and the gradients' magnitudes
# are compared through the optimizer state, as a relative L2 difference over
# each network.  Its tolerance is what fp32 rounding alone does to this step
# (random weights, BatchNorm over a handful of values in the U-Net's
# innermost blocks): the `conditioning` phase measured 4.0e-3 between the
# CPU in fp32 and in fp64, 6.2e-3 between the card and the CPU, and 1.9e-3
# between the kernels and their plain versions on one card.
AGREE_PARAM_TOL = 1e-5
AGREE_FRAC_TOL = 2e-2
AGREE_GRAD_TOL = 3e-2
TRAIN_BATCH = 4
TRAIN_STEPS = 3
# launches per train step of the flagship (the generator path through the
# discriminators needs dX only, the discriminator path dW+db only)
TRAIN_LAUNCHES = {"conv_stem_fwd": 2, "conv_stem_dw": 1, "conv_stem_dx": 1,
                  "conv_thin": 1, "conv_thin_dx": 1, "conv_thin_dw": 1,
                  "bilinear_conv": 2, "bilinear_conv_backward": 2}
PHASES = {"kernels", "serve", "train", "conditioning"}


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
def _rand(torch, g, shape, dt, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)


def kernel_cases(torch):
    """One dict per kernel and shape: name, shape, make(dtype, generator) ->
    args, the kernel's wrapper, its plain version, one library call for the
    same function, the operations and (per dtype) the bytes of the work.
    The first case of each kernel is the main path's shape.  `f32_out`
    marks outputs that are fp32 whatever the input type (dW, db)."""
    import torch.nn.functional as F
    from torch.nn import grad as ng

    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct

    def es(dt):
        return torch.finfo(dt).bits // 8

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(w):
        return w.permute(3, 2, 0, 1)

    def thin(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, c), dt),
                    _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5))

        return dict(
            name="conv_thin", shape=(n, h, w, c, f), make=make,
            kern=ct.conv_thin_fwd, plain=ct.conv_thin_plain,
            lib=lambda x, wt: F.conv2d(nchw(x), oihw(wt), padding=1),
            flops=2.0 * n * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (c + f) + 9 * c * f))

    def thin_dx(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, f), dt),
                    _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5))

        return dict(
            name="conv_thin_dx", shape=(n, h, w, c, f), make=make,
            kern=ct.conv_thin_dx, plain=ct.conv_thin_dx_plain,
            lib=lambda gg, wt: ng.conv2d_input((n, c, h, w), oihw(wt),
                                               nchw(gg), padding=1),
            flops=2.0 * n * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (c + f) + 9 * c * f))

    def thin_dw(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, c), dt),
                    _rand(torch, g, (n, h, w, f), dt))

        return dict(
            name="conv_thin_dw", shape=(n, h, w, c, f), make=make,
            kern=ct.conv_thin_dw, plain=ct.conv_thin_dw_plain, f32_out=True,
            lib=lambda x, gg: ng.conv2d_weight(nchw(x), (f, c, 3, 3),
                                               nchw(gg), padding=1),
            flops=2.0 * n * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * n * h * w * (c + f) + 4 * 9 * c * f)

    def stem_args(dt, g, n, h, w, f, slope):
        x = _rand(torch, g, (n, h, w, 1), dt)
        wt = _rand(torch, g, (5, 5, 1, f), dt, 0.2)
        b = _rand(torch, g, (f,), torch.float32, 0.1)
        y = cs.conv_stem_fwd_plain(x, wt, b, slope)
        return x, wt, b, y, _rand(torch, g, (n, h, w, f), dt)

    def stem_fwd(n, h, w, f, slope):
        def make(dt, g):
            return stem_args(dt, g, n, h, w, f, slope)[:3]

        return dict(
            name="conv_stem_fwd", shape=(n, h, w, f, slope), make=make,
            kern=lambda x, wt, b: cs.conv_stem_fwd(x, wt, b, slope),
            plain=lambda x, wt, b: cs.conv_stem_fwd_plain(x, wt, b, slope),
            # the conv alone; the activation would be a second call
            lib=lambda x, wt, b: F.conv2d(nchw(x), oihw(wt), b.to(x.dtype),
                                          padding=2),
            flops=2.0 * n * h * w * 25 * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (1 + f) + 25 * f) + 4 * f)

    def stem_dw(n, h, w, f, slope):
        k = 2 if slope is not None else 1

        def make(dt, g):
            x, _, _, y, gg = stem_args(dt, g, n, h, w, f, slope)
            return (x, gg, y)

        return dict(
            name="conv_stem_dw", shape=(n, h, w, f, slope), make=make,
            kern=lambda x, gg, y: cs.conv_stem_dw(x, gg, y, slope),
            plain=lambda x, gg, y: cs.conv_stem_dw_plain(x, gg, y, slope),
            f32_out=True,
            # dW alone, on the unmasked cotangent
            lib=lambda x, gg, y: ng.conv2d_weight(nchw(x), (f, 1, 5, 5),
                                                  nchw(gg), padding=2),
            flops=2.0 * n * h * w * 26 * f,
            nbytes=lambda dt: es(dt) * n * h * w * (1 + k * f) + 4 * 26 * f)

    def stem_dx(n, h, w, f, slope):
        k = 2 if slope is not None else 1

        def make(dt, g):
            _, wt, _, y, gg = stem_args(dt, g, n, h, w, f, slope)
            return (gg, wt, y)

        return dict(
            name="conv_stem_dx", shape=(n, h, w, f, slope), make=make,
            kern=lambda gg, wt, y: cs.conv_stem_dx(gg, wt, y, slope),
            plain=lambda gg, wt, y: cs.conv_stem_dx_plain(gg, wt, y, slope),
            lib=lambda gg, wt, y: ng.conv2d_input((n, 1, h, w), oihw(wt),
                                                  nchw(gg), padding=2),
            flops=2.0 * n * h * w * 25 * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (1 + k * f) + 25 * f))

    def bil(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, c), dt),
                    _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5),
                    _rand(torch, g, (f,), torch.float32, 0.1))

        def lib(x, wt, b):
            up = F.interpolate(nchw(x), scale_factor=2, mode="bilinear",
                               align_corners=False)
            return F.conv2d(up, oihw(wt), b.to(x.dtype), padding=1)

        return dict(
            name="bilinear_conv", shape=(n, h, w, c, f), make=make,
            kern=bc.bilinear_conv_fwd, plain=bc.bilinear_conv_plain, lib=lib,
            flops=2.0 * n * 4 * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (c + 4 * f) + 9 * c * f)
            + 4 * f)

    return [bil(4, 64, 64, 512, 128), bil(4, 128, 128, 256, 64),
            bil(2, 21, 27, 24, 16),
            thin(4, 256, 256, 64, 4), thin(3, 37, 45, 24, 3),
            thin_dx(4, 256, 256, 64, 4), thin_dx(3, 37, 45, 24, 1),
            thin_dw(4, 256, 256, 64, 4), thin_dw(3, 37, 45, 24, 1),
            stem_fwd(8, 512, 512, 64, 0.2), stem_fwd(4, 512, 512, 64, 0.2),
            stem_fwd(2, 37, 45, 8, None),
            stem_dw(8, 512, 512, 64, 0.2), stem_dw(2, 37, 45, 8, 0.2),
            stem_dw(1, 21, 70, 64, None),
            stem_dx(4, 512, 512, 64, 0.2), stem_dx(2, 37, 45, 8, 0.2),
            stem_dx(1, 21, 70, 64, None)]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def check_kernels(torch):
    results = {}
    g = torch.Generator(device="cuda").manual_seed(1234)
    for case in kernel_cases(torch):
        name, shape = case["name"], case["shape"]
        big = case["flops"] > 1e9
        for dt, peak, tol in ((torch.float32, F32_PEAK, F32_TOL),
                              (torch.bfloat16, BF16_PEAK, BF16_TOL)):
            if case.get("f32_out"):
                tol = F32_TOL  # fp32 sums of the same rounded inputs
            args = case["make"](dt, g)
            refs = _as_tuple(case["plain"](*args))
            outs = _as_tuple(case["kern"](*args))
            torch.cuda.synchronize()
            err = lim = 0.0
            for out, ref in zip(outs, refs, strict=True):
                if out.shape != ref.shape or out.dtype != ref.dtype:
                    fail(f"{name} {shape}: {tuple(out.shape)} {out.dtype} vs "
                         f"{tuple(ref.shape)} {ref.dtype}")
                e = (out.float() - ref.float()).abs().max().item()
                bound = tol * ref.float().abs().max().item()
                if not e <= bound:
                    fail(f"{name} {shape} {dt}: error {e} > {bound}")
                if e >= err:
                    err, lim = e, bound
            ms = time_ms(lambda: case["kern"](*args))
            plain_ms = time_ms(lambda: case["plain"](*args),
                               reps=10 if big else 30)
            lib_ms = time_ms(lambda: case["lib"](*args),
                             reps=10 if big else 30)
            t_ops = case["flops"] / peak * 1e3
            t_bytes = case["nbytes"](dt) / HBM_BW * 1e3
            row = dict(shape=shape, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, tol=lim, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
            print(f"kernel {name} {shape} {row['dtype']}: max_abs_err "
                  f"{err:.3e} (tol {lim:.3e}) ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
            results.setdefault(name, []).append(row)
            del args, refs, outs
    return results


def check_autograd(torch):
    """The three differentiable ops on CUDA tensors against autograd of
    their plain versions: gradients must exist (a wrapper that launches
    through ctypes into a fresh tensor returns one without a grad_fn, and
    training would stop there without any error) and agree.  Also
    the bilinear_conv backward as an op, timed at the flagship shapes."""
    import torch.nn.functional as F

    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct

    g = torch.Generator(device="cuda").manual_seed(99)

    def leaves(dt, *shapes_scales):
        return [_rand(torch, g, s, dt if i != "b" else torch.float32, sc)
                .requires_grad_() for s, sc, i in shapes_scales]

    def compare(label, dt, op, plain, args, tol):
        y = op(*args)
        if y.grad_fn is None:
            fail(f"{label}: the output has no grad_fn")
        cot = _rand(torch, g, tuple(y.shape), y.dtype)
        got = torch.autograd.grad(y, args, cot)
        want = torch.autograd.grad(plain(*args), args, cot)
        worst = 0.0
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"{label}: gradient {a.dtype} {tuple(a.shape)}")
            e = (a.float() - b.float()).abs().max().item()
            lim = tol * b.float().abs().max().item()
            if not e <= lim:
                fail(f"{label} {dt}: gradient error {e} > {lim}")
            worst = max(worst, e / max(lim / tol, 1e-30))
        print(f"autograd {label} {str(dt).split('.')[-1]}: largest relative "
              f"gradient error {worst:.3e} (tol {tol})", flush=True)

    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for n, h, w, c, f in ((4, 256, 256, 64, 4), (2, 19, 23, 24, 1)):
            compare(f"conv_thin {(n, h, w, c, f)}", dt, ct.conv_thin,
                    ct.conv_thin_plain,
                    leaves(dt, ((n, h, w, c), 1.0, "x"),
                           ((3, 3, c, f), (9 * c) ** -0.5, "w")), tol)
        for n, h, w, f, slope in ((2, 256, 256, 64, 0.2),
                                  (2, 37, 45, 8, None)):
            compare(f"conv_stem {(n, h, w, f, slope)}", dt,
                    lambda x, wt, b: cs.conv_stem(x, wt, b, slope),
                    lambda x, wt, b: cs.conv_stem_fwd_plain(x, wt, b, slope),
                    leaves(dt, ((n, h, w, 1), 1.0, "x"),
                           ((5, 5, 1, f), 0.2, "w"), ((f,), 0.1, "b")), tol)
        for n, h, w, c, f in ((4, 64, 64, 512, 128), (4, 128, 128, 256, 64),
                              (2, 22, 26, 24, 16)):
            args = leaves(dt, ((n, h, w, c), 1.0, "x"),
                          ((3, 3, c, f), (9 * c) ** -0.5, "w"),
                          ((f,), 0.1, "b"))
            # bf16: dx_conv6 rounds the combined 6x6 kernel and the
            # cotangent to bf16 where the plain composite stays in fp32
            compare(f"bilinear_conv {(n, h, w, c, f)}", dt, bc.bilinear_conv,
                    bc.bilinear_conv_plain, args,
                    tol if dt == torch.float32 else 2 * tol)
            if h < 64:
                continue
            x, wt, b = (a.detach() for a in args)
            cot = _rand(torch, g, (n, 2 * h, 2 * w, f), dt)

            def bwd_op():
                return bc.dx_conv6(cot, wt), bc.dw_db(x, cot, wt.shape)

            yp = bc.bilinear_conv_plain(*args)
            up = F.interpolate(args[0].permute(0, 3, 1, 2), scale_factor=2,
                               mode="bilinear", align_corners=False)
            yl = F.conv2d(up, args[1].permute(3, 2, 0, 1),
                          args[2].to(dt), padding=1).permute(0, 2, 3, 1)
            ms = time_ms(bwd_op, reps=10)
            plain_ms = time_ms(lambda: torch.autograd.grad(
                yp, args, cot, retain_graph=True), reps=10)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                yl, args, cot, retain_graph=True), reps=10)
            print(f"op bilinear_conv backward {(n, h, w, c, f)} "
                  f"{str(dt).split('.')[-1]}: ms {ms:.4f} (dx_conv6 + dW/db, "
                  f"PyTorch ops as in the JAX package) plain_ms "
                  f"{plain_ms:.4f} library_ms {lib_ms:.4f} (autograd of the "
                  f"plain and of the library forward)", flush=True)
            del yp, yl, up


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
        _reset_counters()
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
    profile_once(torch, lambda: pipe.two_stage_det(z),
                 "bucket 8 two-stage det")


def profile_once(torch, fn, label, top=10):
    """One profiled call: device kernel time by name and the device's busy
    share of the call's wall time.  Returns (wall ms, busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"profile {label}: wall {wall:.3f} ms, device kernels {busy:.3f} "
          f"ms (busy share {busy / wall:.3f}), {sum(r[1] for r in rows)} "
          f"kernel launches", flush=True)
    for dev, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {dev:9.3f} ms  x{count:<4d} {key[:100]}")
    return wall, busy


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


# ------------------------------------------------------------------ phase 5
def _counters():
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct

    return {"bilinear_conv": bc.KERNEL, "conv_thin": ct.KERNEL,
            "conv_thin_dx": ct.KERNEL_DX, "conv_thin_dw": ct.KERNEL_DW,
            "conv_stem_fwd": cs.KERNEL_FWD, "conv_stem_dw": cs.KERNEL_DW,
            "conv_stem_dx": cs.KERNEL_DX}


def _reset_counters():
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc

    for k in _counters().values():
        k.launches = 0
    bc.BACKWARD.calls = 0


def _read_counters():
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc

    out = {name: k.launches for name, k in _counters().items()}
    out["bilinear_conv_backward"] = bc.BACKWARD.calls
    return out


def _train_batch(torch, n, size, latent, seed):
    """A seeded synthetic batch on the card: X in [0,1], Y in [-1,1], z
    uniform in [0,1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Z = torch.rand((n, latent), generator=g, device="cuda")
    X = torch.rand((n, size, size, 1), generator=g, device="cuda")
    Y = torch.rand((n, size, size, 3), generator=g, device="cuda") * 2 - 1
    return Z, X, Y


def train_slice(torch, card):
    """The flagship four-network train step at full width, batch 4, in
    fp32 and with bf16 compute over fp32 parameters: one warm-up step, then
    TRAIN_STEPS timed steps with the launch counters set to 0 just before
    and read just after.  Returns the fp32 run's counts."""
    import math

    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.models import param_count

    counts = None
    for label, cd in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        ts = build_train(EXPERIMENT, "cuda", seed=0, compute_dtype=cd)
        batch = _train_batch(torch, TRAIN_BATCH, ts.in_shp, ts.latent_dim, 7)
        before = {n: [p.detach().clone() for p in net.parameters()]
                  for n, net in ts.nets.items()}
        ts.train_step(ts.opt_states, batch, None, ts.lr)  # warm-up
        torch.cuda.synchronize()
        print(f"train {label}: built {EXPERIMENT} (params "
              f"{ {n: param_count(m) for n, m in ts.nets.items()} }) and "
              f"took the warm-up step in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        evs, losses = [], None
        w0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            losses = ts.train_step(ts.opt_states, batch, None, ts.lr)
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3 / TRAIN_STEPS
        got = _read_counters()
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(s.elapsed_time(e) for s, e in evs)
        lv = {k: float(v) for k, v in losses.items()}
        print(f"train {label} [{card}]: batch {TRAIN_BATCH}, {ts.in_shp}px: "
              f"step {ms:.3f} ms (CUDA events, median of {TRAIN_STEPS}), "
              f"{wall:.3f} ms wall per step, "
              f"{TRAIN_BATCH / wall * 1e3:.2f} images/s, peak memory "
              f"{peak / 2**20:.1f} MiB; losses {lv}", flush=True)
        print(f"train {label}: launches over {TRAIN_STEPS} steps {got}",
              flush=True)
        if not all(math.isfinite(v) for v in lv.values()):
            fail(f"train {label}: a loss is not finite")
        for name, per_step in TRAIN_LAUNCHES.items():
            if got[name] != per_step * TRAIN_STEPS:
                fail(f"train {label}: {name} launched {got[name]} times in "
                     f"{TRAIN_STEPS} steps, expected {per_step} per step")
        for n, net in ts.nets.items():
            same = [i for i, (p, q) in enumerate(
                zip(net.parameters(), before[n])) if torch.equal(p, q)]
            if same:
                fail(f"train {label}: {len(same)} parameters of {n} did not "
                     f"change")
        profile_once(torch, lambda: ts.train_step(
            ts.opt_states, batch, None, ts.lr), f"train step {label}", top=12)
        if counts is None:
            counts = got
        del ts, before, batch
        torch.cuda.empty_cache()
    return counts


def train_agreement(torch):
    """One train step of the 256px configuration (all three kernels'
    regimes engage) with the same weights and batch on the card (kernels)
    and on the CPU (plain versions), fp32."""
    from terrain_tpu_torch.experiments import build_train

    card = build_train(AGREE_EXPERIMENT, "cuda", seed=3,
                       compute_dtype=torch.float32)
    cpu = build_train(AGREE_EXPERIMENT, "cpu", seed=4,
                      compute_dtype=torch.float32)
    for n in card.nets:
        cpu.nets[n].load_state_dict(card.nets[n].state_dict())
    batch = _train_batch(torch, AGREE_BATCH, card.in_shp, card.latent_dim,
                         11)
    _reset_counters()
    lg = card.train_step(card.opt_states, batch, None, card.lr)
    torch.cuda.synchronize()
    got = _read_counters()
    for name, per_step in TRAIN_LAUNCHES.items():
        if got[name] != per_step:
            fail(f"agreement: {name} launched {got[name]} times, expected "
                 f"{per_step}")
    t0 = time.perf_counter()
    lc = cpu.train_step(cpu.opt_states, tuple(t.cpu() for t in batch), None,
                        cpu.lr)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for k in lc:
        a, b = float(lg[k]), float(lc[k])
        worst = max(worst, abs(a - b) / max(abs(b), 1e-6))
    # the gradients, read back from the rmsprop state (accu = 0.1*g^2 after
    # the first step), and the updated weights
    def mags(ts):
        return {n: [(a * 10).sqrt() for a in ts.opt_states[n]["accu"]]
                for n in ts.nets}

    gl2, gworst, where = _grad_errors(mags(card), mags(cpu), cpu.nets)
    moved = total = 0
    for n in card.nets:
        for p, q in zip(card.nets[n].parameters(), cpu.nets[n].parameters()):
            d = (p.detach().cpu() - q.detach()).abs()
            moved += int((d > AGREE_PARAM_TOL).sum())
            total += d.numel()
    frac = moved / total
    print(f"agreement train step card vs CPU ({AGREE_EXPERIMENT}, batch "
          f"{AGREE_BATCH}, fp32): largest relative loss difference "
          f"{worst:.3e} (tol {AGREE_LOSS_TOL}); gradient magnitudes: largest "
          f"relative L2 difference over a network {gl2:.3e} (tol "
          f"{AGREE_GRAD_TOL}), largest difference in one tensor relative to "
          f"its largest entry {gworst:.3e} at {where}; share of updated "
          f"weights that differ by more than {AGREE_PARAM_TOL}: {frac:.3e} "
          f"(tol {AGREE_FRAC_TOL}); the CPU step took {cpu_s:.1f} s; losses "
          f"on the card { {k: float(v) for k, v in lg.items()} }", flush=True)
    if not (worst <= AGREE_LOSS_TOL and gl2 <= AGREE_GRAD_TOL
            and frac <= AGREE_FRAC_TOL):
        fail("the train step on the card and on the CPU disagree")


def _grad_errors(got, want, nets):
    """(largest relative L2 difference over a network, largest difference
    in one tensor relative to its largest entry, that tensor's name) of
    two {network: [gradient per parameter]}.  A conv bias in front of a
    train-mode BN has a zero gradient that is computed as rounding noise,
    so a tensor's scale is floored at 1% of its network's largest entry."""
    l2 = worst = 0.0
    where = ""
    for n in want:
        a = [t.detach().double().cpu() for t in got[n]]
        b = [t.detach().double().cpu() for t in want[n]]
        num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
        den = sum(float((y ** 2).sum()) for y in b)
        l2 = max(l2, (num / max(den, 1e-300)) ** 0.5)
        top = max(float(y.abs().max()) for y in b)
        for (name, _), x, y in zip(nets[n].named_parameters(), a, b):
            e = float((x - y).abs().max()) / max(float(y.abs().max()),
                                                 1e-2 * top, 1e-300)
            if e > worst:
                worst, where = e, f"{n}.{name}"
    return l2, worst, where


def conditioning(torch):
    """Not part of the default run (`python3 chip_smoke.py conditioning`):
    how far fp32 itself decides the gradients of one train step of the
    256px configuration.  The same weights and batch give the four gradient
    trees (a) on the card with the kernels, (b) on the card with the
    kernels' plain versions forced onto the CUDA tensors -- for this
    measurement only: the wrappers' own device test is patched out, which
    nothing in the port can do --, (c) on the CPU in fp32 and (d) on the
    CPU in fp64.  (c) against (d) is what rounding alone does; (a) against
    (b) is what the kernels add to it."""
    import copy

    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.train import step

    kw = dict(alpha=100.0, lsgan=True, reconstruction="l1")
    card = build_train(AGREE_EXPERIMENT, "cuda", seed=3,
                       compute_dtype=torch.float32)
    batch = _train_batch(torch, AGREE_BATCH, card.in_shp, card.latent_dim,
                         11)
    cpu_batch = tuple(t.cpu() for t in batch)

    def grads(nets, b):
        return step.losses_and_grads(
            {n: copy.deepcopy(m) for n, m in nets.items()}, *b, **kw)[1]

    g_kern = grads(card.nets, batch)
    mods = (cs, ct, bc)
    saved = [m.all_on_cpu for m in mods]
    for m in mods:
        m.all_on_cpu = lambda *a: True
    g_plain = grads(card.nets, batch)
    for m, f in zip(mods, saved):
        m.all_on_cpu = f
    nets32 = {n: copy.deepcopy(m).cpu() for n, m in card.nets.items()}
    g32 = grads(nets32, cpu_batch)
    nets64 = {n: copy.deepcopy(m).double() for n, m in nets32.items()}
    for m in nets64.values():
        m.compute_dtype = torch.float64
    g64 = grads(nets64, tuple(t.double() for t in cpu_batch))
    for label, a, b in (("kernels vs plain versions, both on the card",
                         g_kern, g_plain),
                        ("card (kernels) vs CPU fp32", g_kern, g32),
                        ("card (kernels) vs CPU fp64", g_kern, g64),
                        ("CPU fp32 vs CPU fp64", g32, g64)):
        l2, worst, where = _grad_errors(a, b, nets32)
        print(f"conditioning {AGREE_EXPERIMENT} batch {AGREE_BATCH}: {label}: "
              f"largest relative L2 difference over a network {l2:.3e}, "
              f"largest difference in one tensor relative to its largest "
              f"entry {worst:.3e} at {where}", flush=True)


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
    only = set(sys.argv[1:])  # e.g. `kernels train`; none = every phase
    unknown = only - PHASES
    if unknown:
        print(f"FAIL: unknown phases {sorted(unknown)}; one of "
              f"{sorted(PHASES)}")
        return 4

    def want(phase):  # "conditioning" runs only when asked for
        return not only or phase in only

    strict_fp32()
    t_start = time.perf_counter()
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

    rows, serve_launches, train_launches = {}, {}, {}
    if want("kernels"):
        rows = check_kernels(torch)
        check_autograd(torch)
        print(f"phase kernels done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("serve"):
        pipe, serve_launches = serve_slice(torch, card)
        device_breakdown(torch, pipe, card)
        agreement(torch, pipe)
        del pipe
        torch.cuda.empty_cache()
        print(f"phase serve done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if "conditioning" in only:
        conditioning(torch)
    if want("train"):
        train_launches = train_slice(torch, card)
        train_agreement(torch)
        print(f"phase train done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if only:
        print(f"phases {sorted(only)} passed; run without arguments for the "
              f"result lines")
        return 0

    csrc = "terrain_tpu_torch/ops/kernels/csrc/"
    pallas = "terrain_tpu/ops/pallas/"
    meta = {  # kernel -> (source, the pallas_call it replaces)
        "bilinear_conv": ("bilinear_conv.cu", "bilinear_conv.py:145"),
        "conv_thin": ("conv_thin.cu", "conv_thin.py:182"),
        "conv_thin_dx": ("conv_thin.cu", "conv_thin.py:182"),
        "conv_thin_dw": ("conv_thin.cu", "conv_thin.py:239"),
        "conv_stem_fwd": ("conv_stem.cu", "conv_stem.py:260"),
        "conv_stem_dw": ("conv_stem.cu", "conv_stem.py:299"),
        "conv_stem_dx": ("conv_stem.cu", "conv_stem.py:325"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        main_row = rows[name][0]  # main path shape, fp32
        n_serve = serve_launches.get(name, 0)
        n_train = train_launches[name]
        if n_train == 0 or (name in serve_launches and n_serve == 0):
            fail(f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": pallas + rep, "launches": n_serve + n_train,
            "launches_serve": n_serve, "launches_train": n_train,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               if r["dtype"] == "float32"),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

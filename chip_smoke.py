#!/usr/bin/env python3
"""Drive terrain_tpu_torch's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py kernels quality   # some phases only, no result lines

Phases (any failure exits non-zero and prints no result line):
  1. card: its name and power limit (nvidia-smi), torch/CUDA versions, and
     the nvcc build of every kernel from csrc/ (timed, one nvcc per source,
     all started together);
  2. kernels: each of the twelve CUDA kernels against its plain PyTorch
     version on the card, in fp32 and bf16 (bilinear: fp32, its only type),
     at the main paths' shapes and small or ragged ones; max-abs error
     against a stated tolerance (the pool moves values and is held exactly,
     deliberate ties included; a dW kernel without atomics must give the
     same bits twice, and so must the stem's forward and dX and conv_thin's
     forward), and times (CUDA events, median of 30 launches after
     warm-up, each alone: the wrapper's host cost included; and
     stream_ms, the device time of 20 launches queued behind a spin
     kernel) of the kernel, the plain version and one PyTorch library call
     for the same function (where that call does less -- a forward
     without its activation, a gradient without the leaky select, dW
     without db -- also library_same_ms: the call with the activation, or
     the select, the call and the db sum), beside the least time the card
     could take (bilinear_conv in fp32: its three TF32 tensor-core passes, with
     the fp32 CUDA cores' figure printed beside it).
     Then the six differentiable ops (conv_thin, conv_stem, bilinear_conv,
     pool2, conv_s2, bilinear) on CUDA tensors against autograd of their
     plain versions: the gradients must exist and agree (bilinear_conv's
     under each TERRAIN_BC_BWD value: conv6, dense, xla32); and the
     bilinear_conv and bilinear backwards (PyTorch ops, as they are XLA code
     in the JAX package) timed as ops, bilinear_conv's by each of the three;
  3. serve: test1_nobn_bilin_both's generators at full width (512px,
     latent 1000) with seeded random weights -- the repository holds no
     trained checkpoint, so this is the server's --no-weights mode --
     behind the port's TerrainServer, warmed up on every bucket, answering
     gz/atob/interp requests (npy and png, det and stoch, streamed, and
     concurrent clients that the batcher coalesces) through the port's
     TerrainClient; the launch counters, reset just before, must show
     bilinear_conv twice and conv_thin once per two-stage dispatch; then
     one fixed z (N=1, det, fp32) through the samplers on the card and
     through the same weights on the CPU (plain versions), by default and
     with the unfused decoder (TERRAIN_PALLAS=1 TERRAIN_PALLAS_DECODER=0:
     one bilinear launch);
  4. train: the flagship four-network train step built through
     experiments.build_train at full width (512px, latent 1000, batch 4,
     seeded weights and a seeded synthetic batch), in fp32 and with bf16
     compute over fp32 parameters, with the two opt-in kernel switches
     (TERRAIN_POOL_VJP=pallas, TERRAIN_PALLAS_CONVS2=1) off and on, and in
     fp32 with the unfused decoder, and in fp32 and bf16 with
     TERRAIN_BC_BWD=dense and =xla32: a warm-up step, then timed steps with
     the launch counters set to 0 just before and read just after (per
     step: conv_stem fwd 2, dW 1, dX 1; conv_thin fwd, dX, dW 1 each;
     bilinear_conv 2 and its backward 2; with the switches on pool2 fwd 12
     and bwd 12, conv_s2 fwd 3 and dW 2, with them off 0; with the unfused
     decoder bilinear 1 and its backward 1, bilinear_conv 0), finite losses,
     every parameter of all four networks changed, step time, images/s,
     peak memory, and a profiled step by kernel; then one step of the 256px
     configuration, switches on, on the card (kernels) and on the CPU
     (plain versions) from the same weights and batch: losses, gradients
     and updated weights;
  5. trainer: `python -m terrain_tpu_torch test1_nobn_bilin_both train`
     through cli.main at full width on 240 synthetic pairs held on the card
     as uint8, gathered, normalized and augmented inside the step, both
     switches on: one epoch with a checkpoint, then the same command
     resuming it for a second epoch; results.txt (header, two rows of
     finite losses), the dumps, both checkpoints (every parameter moved),
     the launch counts of an epoch, epoch time, images/s, the data path's
     share of a step, peak memory; then smoke_synthetic train + gen;
  6. quality: the same command with the unfused decoder, TERRAIN_SWD=1 and
     TERRAIN_PROFILE on host iterators behind the prefetcher (40 synthetic
     pairs, two epochs, a checkpoint each), then `gen`: swd.txt with
     terrain_tpu's columns and finite values, gen's checkpoint picked from
     it, the trace file, the launch counts, epoch and SWD times, and the SWD
     pyramid and terrain W1 of the same images on the card against the CPU;
  7. raster: a synthetic raster pair at the NASA rasters' size (21600 x
     10800; a heightmap ~30% ocean, an RGB texture) written as PNGs whose
     rows cycle through the five filter types, decoded by the port's codec
     (seconds and MB/s; the pair must come back byte-equal, in under 60 s),
     the crop iterator's first batch against plain slicing of the decoded
     pair, its crops/s and rejection share, then two epochs of
     `TERRAIN_RASTER=hm.png,tex.png TERRAIN_EPOCH_CROPS=48 python -m
     terrain_tpu_torch test1_nobn_bilin_both train` at 512px: finite
     losses, the flagship kernels' launch counts, epoch time and the share
     of a step of the host batch and of the augmentation;
  8. scan: TERRAIN_SCAN as one CUDA graph: the flagship step (augmentation
     on) from one saved state, 4 eager steps twice against two replays of
     a 4-step graph, by default (no deterministic algorithms: the port's
     fp32 step repeats itself), in fp32 and bf16, switches off and on, and
     in fp32 at half the lr (captured anew) and with adam (its step count
     advanced on the device): losses, every parameter, the BN statistics
     and the optimizer state bit-equal, and the hand-written kernels of a
     profiled replay at 4x their per-step counts; per step at
     TERRAIN_SCAN=16, by default, eager and graph in turns, with profiled
     device time and busy share (bf16: the graph's step within 1.25x its
     device time); then the trainer on 240 pairs on the card, two epochs
     at TERRAIN_SCAN=16 (fp32 through the CLI) and one eager from the same
     seed, fp32 and bf16: epoch times, and epoch 1's results.txt loss
     columns equal to eager's;
  9. parallel: data parallelism over torch.distributed, fp32 and bf16, at
     global batch 4.  NCCL at world size 1 (one H100 holds no second NCCL
     rank): TwoStageGAN(mesh=make_mesh()) on three seeds against the step
     without a mesh (losses and the gradients the update takes, each
     network's to its own limit) and bit-equal to itself, with the
     switches on and the unfused decoder on one, and its step ms, device
     ms and collectives a step; in one process, the two-rank step's twin
     (only its summation orders changed) and epochs over 8 pairs without a
     mesh and as the twin.  Then two spawned gloo ranks sharing the card,
     2 rows each: the same steps against one process's, four planted
     faults (BN statistics local, gradients summed, gradients 1% large,
     half the batch twice) each shown to fail that comparison, three
     epochs whose loss rows must match one process's, and every kernel of
     the train path launched on each rank at its local batch.
On request only: `conditioning` (what fp32 rounding does to the 256px
step: CPU fp32 vs fp64, card vs CPU, kernels vs plain versions) and
`determinism` (two fp32 steps from one state in each of DET_SETTINGS, the
warnings of deterministic algorithms, what the repairs cost in fp32 and
bf16, and cuDNN's fp32 conv gradients of the step against fp64).
The last lines are the `kernels` JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import contextlib
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
TF32_PEAK = 495e12   # H100 SXM dense TF32 tensor cores, FLOP/s
HBM_BW = 3.35e12     # H100 SXM HBM3, bytes/s
F32_TOL = 1e-4       # x max|ref|: fp32 sums in another order
BILINEAR_TOL = 1e-6  # x max|ref|: the same fp32 operations in the same order
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
# the two opt-in ops, switched on as in terrain_tpu: six of the DCGAN
# discriminator's seven pools in its two passes, forward and backward; the
# U-Net's and PatchGAN's first convs (PatchGAN twice), dW+db where the
# parameters are live
SWITCHES = {"TERRAIN_POOL_VJP": "pallas", "TERRAIN_PALLAS_CONVS2": "1"}
SWITCHED_LAUNCHES = {"pool2_fwd": 12, "pool2_bwd": 12, "conv_s2_fwd": 3,
                     "conv_s2_dw": 2}
# the unfused decoder: terrain_tpu's switches that send the U-Net's last
# bilinear stage, (N,128,128,256) fp32, through the bilinear kernel and its
# transpose instead of bilinear_conv (the (N,64,64,512) stage is below the
# kernel's regime and goes to the library resize)
UNFUSED = {"TERRAIN_PALLAS": "1", "TERRAIN_PALLAS_DECODER": "0"}
UNFUSED_LAUNCHES = {"bilinear": 1, "bilinear_backward": 1,
                    "bilinear_conv": 0, "bilinear_conv_backward": 0}
# an eval step runs the forwards only; a dump of [A, G(A)] pairs runs the
# U-Net alone
EVAL_LAUNCHES = {"pool2_fwd": 12, "pool2_bwd": 0, "conv_s2_fwd": 3,
                 "conv_s2_dw": 0}
TRAINER_N = 240          # the shipped set's size: 250 MB of uint8 on the card
# the quality path's train set: depth cut to 10 steps an epoch (the widths
# are the flagship's); the valid set is its floor of 4 pairs, one step
QUALITY_N = 40
# epoch 1 warms up (cuDNN's choices for new shapes), epoch 2 is traced
# (TERRAIN_PROFILE), epoch 3 is the clean one
QUALITY_EPOCHS = 3
SWD_N = 16               # images per SWD evaluation (the trainer's n)
SWD_TOL = 1e-4           # relative, card vs CPU: fp32 sums in another order
# TERRAIN_BC_BWD, the bilinear_conv backward's route (conv6 is the default)
BC_BWD_MODES = ("conv6", "dense", "xla32")
# the raster phase: a synthetic pair at the NASA rasters' size (21600 x
# 10800, SURVEY.md:76), one epoch of TERRAIN_EPOCH_CROPS crops from it
RASTER_H, RASTER_W = 10800, 21600
RASTER_CROPS = 48
RASTER_DECODE_S = 60.0   # limit: seconds to decode the pair on the host
# the scan phase: eager steps against one CUDA graph of SCAN_K steps from
# one saved state, on SCAN_N pairs held on the card; timing at
# TERRAIN_SCAN=16 (terrain_tpu's TPU launch script); the trainer on
# TRAINER_N pairs at TERRAIN_SCAN=16 (chunks of 15)
SCAN_K = 4
SCAN_TIME_K = 16
SCAN_N = 16
SCAN_BUSY_LIMIT = 1.25   # bf16: graph step ms / its profiled device ms
# the parallel phase.  A data-parallel step computes one process's
# function with its sums in another order: the BatchNorms' statistics and
# the losses as all-reduced sums over a count, and on two ranks each
# rank's share of every sum over the batch, at cuDNN's algorithms for the
# local batch.  Its twin in one process changes those orders alone: a
# world-1 mesh (the same BatchNorm sums) whose two discriminators (no
# BatchNorm, no dropout) run each rank's rows as a call of their own.  The
# gradients pass back through BatchNorms over a few values and through
# cuDNN's fp32 dW of the DCGAN discriminator's 5x5 convs, 8.3e-3 to
# 3.6e-2 off fp64 relative to its largest entry (PERF.md), so a new
# summation order moves some networks' gradients far more than 1e-4: the
# twin moves the DCGAN generator's by 4.8e-3 to 9.4e-3 relative L2.  So
# the two ranks are held to PAR_TWIN x the twin's error on the same seed
# (each network's gradients, each column of the epoch's loss row: the
# twin's largest over the seeds), and never to less than PAR_TOL; on an
# NVIDIA H100 80GB HBM3 at 700 W the ranks' errors were 0.71-1.17x the
# twin's in the step and 0.80-1.13x in the epoch over PAR_SEEDS, and every
# planted fault of PAR_FAULTS exceeds those limits (checked in every run).
# World 1 against no mesh is itself a change of summation order alone:
# held to PAR_W1_GRAD_TOL, about twice the largest of its readings over
# PAR_SEEDS and seed 7 (PERF.md §6).
PAR_WORLD = 2
PAR_N = 8
PAR_SEEDS = (0, 1, 2)    # the batches and datasets every figure is read on
PAR_TOL = 1e-4           # two ranks vs one process: the least limit
PAR_TWIN = 2.0
PAR_LOSS_TOL = {"fp32": 1e-6, "bf16": 1e-4}  # world 1 vs no mesh
PAR_W1_GRAD_TOL = {"fp32": {"dcgan_gen": 2e-2, "dcgan_disc": 1e-4,
                            "p2p_gen": 4e-3, "p2p_disc": 1e-4},
                   "bf16": {"dcgan_gen": 2e-2, "dcgan_disc": 1e-4,
                            "p2p_gen": 5e-2, "p2p_disc": 1e-4}}
PAR_FAULTS = ("BN statistics local", "gradients summed",
              "gradients 1% large", "half the batch twice")
PAR_TIMEOUT_S = 300      # a collective's wait before it fails
# each hand-written kernel's symbol, as the profiler names it
KERNEL_SYMBOLS = {"bilinear_conv": "bilinear_conv_kernel",
                  "conv_thin": "thin_fwd_kernel",
                  "conv_thin_dx": "thin_dx_kernel",
                  "conv_thin_dw": "thin_dw_kernel",
                  "conv_stem_fwd": "stem_fwd_kernel",
                  "conv_stem_dw": "stem_dw_kernel",
                  "conv_stem_dx": "stem_dx_kernel",
                  "pool2_fwd": "pool2_fwd_kernel",
                  "pool2_bwd": "pool2_bwd_kernel",
                  "conv_s2_fwd": "s2_fwd_kernel",
                  "conv_s2_dw": "s2_dw_kernel",
                  "bilinear": "bilinear_2x_kernel"}
PHASES = {"kernels", "serve", "train", "trainer", "quality", "raster", "scan",
          "parallel", "conditioning", "determinism"}


def set_switches(on, switches=SWITCHES):
    for k, v in switches.items():
        if on:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)


def expected_launches(on, unfused=False):
    return {**TRAIN_LAUNCHES,
            **{k: v if on else 0 for k, v in SWITCHED_LAUNCHES.items()},
            **(UNFUSED_LAUNCHES if unfused
               else {"bilinear": 0, "bilinear_backward": 0})}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(flops, nbytes, fp32, tf32_passes=0):
    """The least time the card could take for a kernel's work: its bytes
    (each input read once, each output written once) at HBM_BW, or its
    operations at the peak of their type, whichever is longer.  bf16 work
    goes at the bf16 tensor cores' peak; fp32 work at the CUDA cores', or,
    for a kernel whose fp32-accurate products take `tf32_passes` passes on
    the TF32 tensor cores (bilinear_conv's 3xTF32 split), that many passes
    at their peak.  Returns (ms, "operations" or "bytes")."""
    if not fp32:
        t_ops = flops / BF16_PEAK * 1e3
    elif tf32_passes:
        t_ops = tf32_passes * flops / TF32_PEAK * 1e3
    else:
        t_ops = flops / F32_PEAK * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def stream_ms(fn, launches=20, reps=5):
    """Median device time of one launch among `launches` queued back to back
    behind a spin kernel, so the host's launch cost is off the clock."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)  # ~2 ms: the host queues meanwhile
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / launches)
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
def _rand(torch, g, shape, dt, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)


def kernel_cases(torch):
    """One dict per kernel and shape: name, shape, make(dtype, generator) ->
    args, the kernel's wrapper, its plain version, one library call for the
    same function, the operations and (per dtype) the bytes of the work.
    The first case of each kernel is the main path's shape.  `f32_out`
    marks outputs that are fp32 whatever the input type (dW, db).  Where the
    library call computes less than the kernel (a forward without its
    activation, a gradient without the leaky select, dW without db),
    `lib_same` is a library route that computes the same function: the
    activation, or the select, the library gradient and the db sum.
    `tf32_passes` is the number of TF32 tensor-core passes the kernel's
    fp32 products take (see bound_ms)."""
    import torch.nn.functional as F
    from torch.nn import grad as ng

    from terrain_tpu_torch.ops.kernels import bilinear as bl
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.ops.kernels import pool2 as p2

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
            kern=ct.conv_thin_fwd, plain=ct.conv_thin_plain, twice=True,
            lib=lambda x, wt: F.conv2d(nchw(x), oihw(wt), padding=1),
            flops=2.0 * n * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (c + f) + 9 * c * f))

    def thin_dx(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, f), dt),
                    _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5))

        return dict(
            name="conv_thin_dx", shape=(n, h, w, c, f), make=make,
            kern=ct.conv_thin_dx, plain=ct.conv_thin_dx_plain, twice=True,
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
            twice=True,
            lib=lambda x, gg: ng.conv2d_weight(nchw(x), (f, c, 3, 3),
                                               nchw(gg), padding=1),
            flops=2.0 * n * h * w * 9 * c * f,
            nbytes=lambda dt: es(dt) * n * h * w * (c + f) + 4 * 9 * c * f)

    def masked(gg, y, slope):
        return gg if slope is None else torch.where(y >= 0, gg, slope * gg)

    def leaky(v, slope):  # the activation as one more library call
        return v if slope is None else F.leaky_relu(v, slope)

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
            twice=True,
            # the conv alone; lib_same adds the activation as a second call
            lib=lambda x, wt, b: F.conv2d(nchw(x), oihw(wt), b.to(x.dtype),
                                          padding=2),
            lib_same=lambda x, wt, b: leaky(
                F.conv2d(nchw(x), oihw(wt), b.to(x.dtype), padding=2), slope),
            flops=2.0 * n * h * w * 25 * f,
            nbytes=lambda dt: es(dt) * (n * h * w * (1 + f) + 25 * f) + 4 * f)

    def stem_dw(n, h, w, f, slope):
        k = 2 if slope is not None else 1

        def make(dt, g):
            x, _, _, y, gg = stem_args(dt, g, n, h, w, f, slope)
            return (x, gg, y)

        def lib_same(x, gg, y):
            gm = masked(gg, y, slope)
            return (ng.conv2d_weight(nchw(x), (f, 1, 5, 5), nchw(gm),
                                     padding=2),
                    gm.sum((0, 1, 2), dtype=torch.float32))

        return dict(
            name="conv_stem_dw", shape=(n, h, w, f, slope), make=make,
            kern=lambda x, gg, y: cs.conv_stem_dw(x, gg, y, slope),
            plain=lambda x, gg, y: cs.conv_stem_dw_plain(x, gg, y, slope),
            f32_out=True, twice=True, lib_same=lib_same,
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

        def lib_same(gg, wt, y):
            return ng.conv2d_input((n, 1, h, w), oihw(wt),
                                   nchw(masked(gg, y, slope)), padding=2)

        return dict(
            name="conv_stem_dx", shape=(n, h, w, f, slope), make=make,
            kern=lambda gg, wt, y: cs.conv_stem_dx(gg, wt, y, slope),
            plain=lambda gg, wt, y: cs.conv_stem_dx_plain(gg, wt, y, slope),
            lib_same=lib_same, twice=True,
            # dX on the unmasked cotangent
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

        flops = 2.0 * n * 4 * h * w * 9 * c * f

        def nbytes(dt):
            return es(dt) * (n * h * w * (c + 4 * f) + 9 * c * f) + 4 * f

        return dict(
            name="bilinear_conv", shape=(n, h, w, c, f), make=make,
            kern=bc.bilinear_conv_fwd, plain=bc.bilinear_conv_plain, lib=lib,
            flops=flops, nbytes=nbytes, twice=True, tf32_passes=3)

    def pool_x(dt, g, n, h, w, c, ties):
        x = _rand(torch, g, (n, h, w, c), dt)
        # ties: a handful of levels, so most windows hold their maximum twice
        return torch.round(x * 2) / 2 if ties else x

    def pool_fwd(n, h, w, c, ties=False):
        def make(dt, g):
            return (pool_x(dt, g, n, h, w, c, ties),)

        return dict(
            name="pool2_fwd", shape=(n, h, w, c, "ties" if ties else "random"),
            make=make, kern=p2.pool2_fwd, plain=p2.pool2_fwd_plain, exact=True,
            lib=lambda x: F.max_pool2d(nchw(x), 2),
            flops=3.0 * n * (h // 2) * (w // 2) * c,
            nbytes=lambda dt: es(dt) * n * h * w * c * 5 // 4)

    def pool_bwd(n, h, w, c, ties=False):
        def make(dt, g):
            return (pool_x(dt, g, n, h, w, c, ties),
                    _rand(torch, g, (n, h // 2, w // 2, c), dt))

        def lib_make(x, gg):
            # autograd through the library pool: its backward alone
            xr = x.clone().requires_grad_()
            y = F.max_pool2d(nchw(xr), 2)
            return lambda: torch.autograd.grad(y, xr, nchw(gg),
                                               retain_graph=True)

        return dict(
            name="pool2_bwd", shape=(n, h, w, c, "ties" if ties else "random"),
            make=make, kern=p2.pool2_bwd, plain=p2.pool2_bwd_plain, exact=True,
            lib_make=lib_make, flops=5.0 * n * (h // 2) * (w // 2) * c,
            nbytes=lambda dt: es(dt) * n * h * w * c * 9 // 4)

    def s2_args(dt, g, n, h, w, c, f, slope):
        x = _rand(torch, g, (n, h, w, c), dt)
        wt = _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5)
        b = _rand(torch, g, (f,), torch.float32, 0.1)
        y = c2.conv_s2_fwd_plain(x, wt, b, slope)
        return x, wt, b, y, _rand(torch, g, (n, h // 2, w // 2, f), dt)

    def s2_fwd(n, h, w, c, f, slope):
        def make(dt, g):
            return s2_args(dt, g, n, h, w, c, f, slope)[:3]

        return dict(
            name="conv_s2_fwd", shape=(n, h, w, c, f, slope), make=make,
            kern=lambda x, wt, b: c2.conv_s2_fwd(x, wt, b, slope),
            plain=lambda x, wt, b: c2.conv_s2_fwd_plain(x, wt, b, slope),
            # the conv alone; lib_same adds the activation as a second call
            lib=lambda x, wt, b: F.conv2d(nchw(x), oihw(wt), b.to(x.dtype),
                                          stride=2, padding=1),
            lib_same=lambda x, wt, b: leaky(
                F.conv2d(nchw(x), oihw(wt), b.to(x.dtype), stride=2,
                         padding=1), slope),
            flops=2.0 * n * (h // 2) * (w // 2) * 9 * c * f,
            nbytes=lambda dt: es(dt) * (n * h * w * c + n * h * w // 4 * f
                                        + 9 * c * f) + 4 * f)

    def s2_dw(n, h, w, c, f, slope):
        k = 2 if slope is not None else 1

        def make(dt, g):
            x, _, _, y, gg = s2_args(dt, g, n, h, w, c, f, slope)
            return (x, gg, y)

        def lib_same(x, gg, y):
            gm = masked(gg, y, slope)
            return (ng.conv2d_weight(nchw(x), (f, c, 3, 3), nchw(gm),
                                     stride=2, padding=1),
                    gm.sum((0, 1, 2), dtype=torch.float32))

        return dict(
            name="conv_s2_dw", shape=(n, h, w, c, f, slope), make=make,
            kern=lambda x, gg, y: c2.conv_s2_dw(x, gg, y, slope),
            plain=lambda x, gg, y: c2.conv_s2_dw_plain(x, gg, y, slope),
            f32_out=True, twice=True, lib_same=lib_same,
            # dW alone, on the unmasked cotangent
            lib=lambda x, gg, y: ng.conv2d_weight(
                nchw(x), (f, c, 3, 3), nchw(gg), stride=2, padding=1),
            flops=2.0 * n * (h // 2) * (w // 2) * (9 * c + 1) * f,
            nbytes=lambda dt: es(dt) * (n * h * w * c + k * n * h * w // 4 * f)
            + 4 * (9 * c + 1) * f)

    def up2(n, h, w, c):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, c), dt),)

        def lib(x):
            return F.interpolate(nchw(x), scale_factor=2, mode="bilinear",
                                 align_corners=False)

        return dict(
            name="bilinear", shape=(n, h, w, c), make=make,
            kern=bl.bilinear_2x_fwd, plain=bl.bilinear_2x_plain, lib=lib,
            # fp32 only, as terrain_tpu's guard; the same products and sums
            # in the same order as the plain version, each rounded alone
            dtypes=(torch.float32,), tol=BILINEAR_TOL,
            # three flops per interpolated value: the row pass makes 2H*W,
            # the column pass 4H*W values per channel
            flops=3.0 * n * (2 * h * w + 4 * h * w) * c,
            nbytes=lambda dt: es(dt) * n * h * w * c * 5)

    return [up2(4, 128, 128, 256), up2(8, 128, 128, 256),
            up2(2, 136, 200, 128),
            bil(4, 64, 64, 512, 128), bil(4, 128, 128, 256, 64),
            # the served buckets 1 and 8
            bil(1, 64, 64, 512, 128), bil(1, 128, 128, 256, 64),
            bil(8, 64, 64, 512, 128), bil(8, 128, 128, 256, 64),
            bil(2, 21, 27, 24, 16),
            # conv_thin's forward and dW (row streams): the main shape,
            # batch 8 (the served bucket), then W no multiple of the
            # 64-column strip (200, 130) and below one strip (45), C = 8
            # and 24, F = 1, 3 and 8
            thin(4, 256, 256, 64, 4), thin(8, 256, 256, 64, 4),
            thin(2, 64, 200, 8, 4), thin(3, 37, 45, 24, 3),
            thin(1, 48, 130, 64, 8),
            # dX (a row stream too): the main shape, the forward's ragged
            # ones, and F = 3 and 1, whose bf16 g rows are no whole 16-byte
            # pieces
            thin_dx(4, 256, 256, 64, 4), thin_dx(2, 64, 200, 8, 4),
            thin_dx(1, 48, 130, 64, 8), thin_dx(3, 37, 45, 24, 3),
            thin_dx(3, 37, 45, 24, 1),
            thin_dw(4, 256, 256, 64, 4), thin_dw(8, 256, 256, 64, 4),
            thin_dw(2, 64, 200, 8, 4), thin_dw(3, 37, 45, 24, 1),
            thin_dw(1, 48, 130, 64, 8),
            # the stem's forward and dX: the main shapes, then ragged ones
            # (W no multiple of the forward's tile or of dX's strip, H
            # cutting the blocks' shares of rows mid-strip) at F 8 to 512
            stem_fwd(8, 512, 512, 64, 0.2), stem_fwd(4, 512, 512, 64, 0.2),
            stem_fwd(2, 37, 45, 8, None), stem_fwd(3, 133, 250, 64, 0.2),
            stem_fwd(1, 21, 70, 512, 0.2),
            stem_dw(8, 512, 512, 64, 0.2), stem_dw(2, 37, 45, 8, 0.2),
            stem_dw(1, 21, 70, 64, None),
            stem_dx(4, 512, 512, 64, 0.2), stem_dx(2, 37, 45, 8, 0.2),
            stem_dx(1, 21, 70, 64, None), stem_dx(3, 133, 250, 64, 0.2),
            stem_dx(1, 21, 70, 512, 0.2),
            pool_fwd(8, 512, 512, 64), pool_fwd(4, 16, 16, 256),
            pool_fwd(2, 16, 32, 8, ties=True),
            pool_bwd(8, 512, 512, 64), pool_bwd(4, 16, 16, 256),
            pool_bwd(2, 64, 64, 64, ties=True),
            s2_fwd(4, 512, 512, 1, 64, None), s2_fwd(8, 512, 512, 4, 64, 0.01),
            s2_fwd(1, 64, 256, 2, 8, 0.2),
            # dW+db (a bulk-copy stream): the main shapes, W/2 = 100 (a
            # short last tile a row), F = 128 (32-pixel tiles), fewer tiles
            # than blocks, F = 512 at cin 4 (the block's sums overlap the
            # ring's barriers in shared memory)
            s2_dw(4, 512, 512, 1, 64, None), s2_dw(8, 512, 512, 4, 64, 0.01),
            s2_dw(2, 64, 200, 4, 64, 0.2), s2_dw(2, 128, 256, 2, 128, 0.2),
            s2_dw(1, 64, 256, 2, 8, 0.2), s2_dw(1, 16, 48, 4, 512, None)]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def check_kernels(torch):
    results = {}
    g = torch.Generator(device="cuda").manual_seed(1234)
    for case in kernel_cases(torch):
        name, shape = case["name"], case["shape"]
        big = case["flops"] > 1e9
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            if dt not in case.get("dtypes", (dt,)):
                continue
            tol = case.get("tol", tol)
            if case.get("f32_out"):
                tol = F32_TOL  # fp32 sums of the same rounded inputs
            if case.get("exact"):
                tol = 0.0      # a selection: the same bits, ties included
            args = case["make"](dt, g)
            refs = _as_tuple(case["plain"](*args))
            # A wrapper writes into torch.empty, which may hand back a freed
            # block that still holds the plain version's values: fill the
            # free blocks of that size with NaN, so a kernel that wrote
            # nothing cannot pass.
            poison = [torch.full_like(r, float("nan"))
                      for r in refs for _ in range(3)]
            del poison
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
            if case.get("twice"):  # no atomics: the same bits every run
                again = _as_tuple(case["kern"](*args))
                if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                    fail(f"{name} {shape} {dt}: two runs differ")
            lib = (case["lib_make"](*args) if "lib_make" in case
                   else lambda: case["lib"](*args))
            ms = time_ms(lambda: case["kern"](*args))
            dev_ms = stream_ms(lambda: case["kern"](*args))
            plain_ms = time_ms(lambda: case["plain"](*args),
                               reps=10 if big else 30)
            lib_ms = time_ms(lib, reps=10 if big else 30)
            fp32 = dt == torch.float32
            bound, by = bound_ms(case["flops"], case["nbytes"](dt), fp32,
                                 case.get("tf32_passes", 0))
            row = dict(shape=shape, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, tol=lim, ms=ms, stream_ms=dev_ms,
                       plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by)
            extra = ""
            if "lib_same" in case:
                row["library_same_ms"] = time_ms(
                    lambda: case["lib_same"](*args), reps=10 if big else 30)
                extra += (f" library_same_ms {row['library_same_ms']:.4f} "
                          f"(the same function through library calls)")
            if fp32 and "tf32_passes" in case:  # the CUDA cores', as before
                row["cuda_core_bound_ms"] = bound_ms(
                    case["flops"], case["nbytes"](dt), True)[0]
                extra += (f" cuda_core_bound_ms "
                          f"{row['cuda_core_bound_ms']:.4f}")
            print(f"kernel {name} {shape} {row['dtype']}: max_abs_err "
                  f"{err:.3e} (tol {lim:.3e}) ms {ms:.4f} stream_ms "
                  f"{dev_ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                  f"{bound:.4f} ({by}){extra}", flush=True)
            results.setdefault(name, []).append(row)
            del args, refs, outs, lib
    return results


def check_autograd(torch):
    """The six differentiable ops on CUDA tensors against autograd of
    their plain versions: gradients must exist (a wrapper that launches
    through ctypes into a fresh tensor returns one without a grad_fn, and
    training would stop there without any error) and agree.  Also the
    bilinear_conv and bilinear backwards as ops (PyTorch code, as they are
    XLA code in the JAX package), timed at the flagship shapes."""
    import torch.nn.functional as F

    from terrain_tpu_torch.ops.kernels import bilinear as bl
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.ops.kernels import pool2 as p2

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

    def pool_grad(dt, n, h, w, c):
        """Pool2Fn: the gradient is a selection, so it is held exactly to
        the plain backward (autograd of the plain forward would split a
        tie); inputs on a few levels, so ties are everywhere."""
        x = (torch.round(_rand(torch, g, (n, h, w, c), dt) * 2) / 2) \
            .requires_grad_()
        y = p2.max_pool2(x)
        if y.grad_fn is None:
            fail(f"pool2 {(n, h, w, c)}: the output has no grad_fn")
        cot = _rand(torch, g, tuple(y.shape), dt)
        (got,) = torch.autograd.grad(y, x, cot)
        want = p2.pool2_bwd_plain(x.detach(), cot)
        if got.dtype != dt or not torch.equal(got, want):
            fail(f"pool2 {(n, h, w, c)} {dt}: gradient differs from the "
                 f"plain backward")
        xl = x.detach().clone().requires_grad_()
        (lib,) = torch.autograd.grad(
            F.max_pool2d(xl.permute(0, 3, 1, 2), 2), xl,
            cot.permute(0, 3, 1, 2))
        print(f"autograd pool2 {(n, h, w, c)} {str(dt).split('.')[-1]}: "
              f"gradient equals the plain backward on tied inputs; equals "
              f"autograd of F.max_pool2d: {torch.equal(got, lib)}", flush=True)

    for shape in ((4, 128, 128, 256), (2, 136, 200, 128)):
        # Bilinear2xFn: fp32 only, as its regime; the transpose against
        # autograd of the plain forward, and against itself (no atomics)
        (x,) = leaves(torch.float32, (shape, 1.0, "x"))
        compare(f"bilinear {shape}", torch.float32, bl.bilinear_2x,
                bl.bilinear_2x_plain, [x], F32_TOL)
        n, h, w, c = shape
        cot = _rand(torch, g, (n, 2 * h, 2 * w, c), torch.float32)
        dx = bl.bilinear_2x_bwd(cot, torch.float32)
        if not torch.equal(dx, bl.bilinear_2x_bwd(cot, torch.float32)):
            fail(f"bilinear {shape}: two backward passes differ")
        if shape[1] != 128:
            continue
        xl = x.detach().clone().requires_grad_()
        yl = F.interpolate(xl.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear", align_corners=False)
        yp = bl.bilinear_2x_plain(x)
        ms = time_ms(lambda: bl.bilinear_2x_bwd(cot, torch.float32))
        plain_ms = time_ms(lambda: torch.autograd.grad(
            yp, x, cot, retain_graph=True))
        lib_ms = time_ms(lambda: torch.autograd.grad(
            yl, xl, cot.permute(0, 3, 1, 2), retain_graph=True))
        bound = 4 * n * h * w * c * 5 / HBM_BW * 1e3
        print(f"op bilinear backward {shape} float32: ms {ms:.4f} (the "
              f"transpose, PyTorch ops as in the JAX package) plain_ms "
              f"{plain_ms:.4f} library_ms {lib_ms:.4f} (autograd of the "
              f"plain and of the library forward) bound_ms {bound:.4f} "
              f"(bytes)", flush=True)
        del yl, yp, xl
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in ((2, 256, 256, 64), (2, 16, 16, 256)):
            pool_grad(dt, *shape)
        for n, h, w, c, f, slope in ((2, 256, 256, 4, 64, 0.01),
                                     (2, 64, 256, 1, 8, None)):
            compare(f"conv_s2 {(n, h, w, c, f, slope)}", dt,
                    lambda x, wt, b: c2.conv_s2(x, wt, b, slope),
                    lambda x, wt, b: c2.conv_s2_fwd_plain(x, wt, b, slope),
                    leaves(dt, ((n, h, w, c), 1.0, "x"),
                           ((3, 3, c, f), (9 * c) ** -0.5, "w"),
                           ((f,), 0.1, "b")), tol)
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
            # under each TERRAIN_BC_BWD value; bf16: conv6 rounds the
            # combined 6x6 kernel and the cotangent to bf16, dense its whole
            # composite, where the plain composite stays in fp32
            for mode in BC_BWD_MODES:
                os.environ["TERRAIN_BC_BWD"] = mode
                compare(f"bilinear_conv {(n, h, w, c, f)} {mode}", dt,
                        bc.bilinear_conv, bc.bilinear_conv_plain, args,
                        tol if dt == torch.float32 or mode == "xla32"
                        else 2 * tol)
            os.environ.pop("TERRAIN_BC_BWD")
            if h < 64:
                continue
            x, wt, b = (a.detach() for a in args)
            cot = _rand(torch, g, (n, 2 * h, 2 * w, f), dt)
            bwd_ops = {
                "conv6": lambda: (bc.dx_conv6(cot, wt), bc.composite_grads(
                    x, wt, cot, dt, (False, True, True))),
                "dense": lambda: bc.composite_grads(x, wt, cot, dt),
                "xla32": lambda: bc.composite_grads(x, wt, cot,
                                                    torch.float32)}
            yp = bc.bilinear_conv_plain(*args)
            up = F.interpolate(args[0].permute(0, 3, 1, 2), scale_factor=2,
                               mode="bilinear", align_corners=False)
            yl = F.conv2d(up, args[1].permute(3, 2, 0, 1),
                          args[2].to(dt), padding=1).permute(0, 2, 3, 1)
            ms = {m: time_ms(op, reps=10) for m, op in bwd_ops.items()}
            plain_ms = time_ms(lambda: torch.autograd.grad(
                yp, args, cot, retain_graph=True), reps=10)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                yl, args, cot, retain_graph=True), reps=10)
            print(f"op bilinear_conv backward {(n, h, w, c, f)} "
                  f"{str(dt).split('.')[-1]}: ms conv6 {ms['conv6']:.4f} "
                  f"dense {ms['dense']:.4f} xla32 {ms['xla32']:.4f} "
                  f"(TERRAIN_BC_BWD's three routes, PyTorch ops as in the "
                  f"JAX package) plain_ms {plain_ms:.4f} library_ms "
                  f"{lib_ms:.4f} (autograd of the plain and of the library "
                  f"forward)", flush=True)
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


def profiled(torch, fn):
    """One profiled call: (wall ms, [(device ms, count, kernel name)]) of
    its device-side events."""
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
    return wall, rows


def profile_once(torch, fn, label, top=10):
    """One profiled call: device kernel time by name and the device's busy
    share of the call's wall time.  Returns (wall ms, busy ms)."""
    wall, rows = profiled(torch, fn)
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: wall {wall:.3f} ms, device kernels {busy:.3f} "
          f"ms (busy share {busy / wall:.3f}), {sum(r[1] for r in rows)} "
          f"kernel launches", flush=True)
    for dev, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {dev:9.3f} ms  x{count:<4d} {key[:100]}")
    return wall, busy


# ------------------------------------------------------------------ phase 4
def agreement(torch, pipe):
    """One fixed z (N=1, det, fp32) through the served samplers on the card
    and through the same weights on the CPU (plain versions): by default,
    and with the unfused decoder (UNFUSED), where the card's U-Net runs the
    bilinear kernel once and the CPU its plain version."""
    import numpy as np

    from terrain_tpu_torch.experiments import build_model
    from terrain_tpu_torch.ops.kernels import bilinear as bl

    cpu, _ = build_model(EXPERIMENT, "cpu", seed=1,
                         compute_dtype=torch.float32)
    cpu.dcgan_gen.load_state_dict(pipe.dcgan_gen.state_dict())
    cpu.p2p_gen.load_state_dict(pipe.p2p_gen.state_dict())
    z = np.random.RandomState(2024).rand(1, pipe.latent_dim) \
        .astype(np.float32)
    try:
        for unfused in (False, True):
            set_switches(unfused, UNFUSED)
            _reset_counters()
            bl.PLAIN.calls = 0
            a_g, b_g = pipe.two_stage_det(torch.from_numpy(z).cuda())
            a_c, b_c = cpu.two_stage_det(torch.from_numpy(z))
            got = (_read_counters()["bilinear"], bl.PLAIN.calls)
            errs = [(x.cpu() - y).abs().max().item() for x, y in
                    ((a_g, a_c), (b_g, b_c))]
            label = "unfused decoder" if unfused else "default"
            print(f"agreement card vs CPU (N=1, det, fp32, {label}): "
                  f"heightmap max_abs_err {errs[0]:.3e}, texture "
                  f"{errs[1]:.3e} (tol {AGREE_TOL}); bilinear launches on "
                  f"the card and plain calls on the CPU {got}; heightmap "
                  f"range [{a_c.min():.4f}, {a_c.max():.4f}], texture "
                  f"[{b_c.min():.4f}, {b_c.max():.4f}]", flush=True)
            if not max(errs) <= AGREE_TOL:
                fail(f"card and CPU outputs disagree ({label})")
            if got != ((1, 1) if unfused else (0, 0)):
                fail(f"agreement ({label}): bilinear launches and plain "
                     f"calls {got}")
    finally:
        set_switches(False, UNFUSED)


# ------------------------------------------------------------------ phase 5
def _counters():
    from terrain_tpu_torch.ops.kernels import bilinear as bl
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.ops.kernels import pool2 as p2

    return {"bilinear_conv": bc.KERNEL, "conv_thin": ct.KERNEL,
            "conv_thin_dx": ct.KERNEL_DX, "conv_thin_dw": ct.KERNEL_DW,
            "conv_stem_fwd": cs.KERNEL_FWD, "conv_stem_dw": cs.KERNEL_DW,
            "conv_stem_dx": cs.KERNEL_DX,
            "pool2_fwd": p2.KERNEL_FWD, "pool2_bwd": p2.KERNEL_BWD,
            "conv_s2_fwd": c2.KERNEL_FWD, "conv_s2_dw": c2.KERNEL_DW,
            "bilinear": bl.KERNEL}


def _op_counters():
    """Counters that are no kernel launches: the bilinear_conv and bilinear
    backwards (ops of PyTorch calls) and the NHWC copies the ops with a copy
    counter had to make."""
    from terrain_tpu_torch.ops.kernels import bilinear as bl
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import pool2 as p2

    return {"bilinear_conv_backward": bc.BACKWARD,
            "bilinear_backward": bl.BACKWARD,
            "pool2_copies": p2.COPIES, "conv_s2_copies": c2.COPIES,
            "bilinear_copies": bl.COPIES}


def _reset_counters():
    for k in _counters().values():
        k.launches = 0
    for c in _op_counters().values():
        c.calls = 0


def _read_counters():
    out = {name: k.launches for name, k in _counters().items()}
    out.update({name: c.calls for name, c in _op_counters().items()})
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
    fp32 and with bf16 compute over fp32 parameters, with the two opt-in
    kernel switches off and on, and in fp32 with the unfused decoder
    (UNFUSED): one warm-up step, then TRAIN_STEPS timed steps with the
    launch counters set to 0 just before and read just after.  Returns the
    fp32 runs' counts added, and the step ms of each configuration."""
    import math

    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.models import param_count

    counts, step_ms = {}, {}
    for label, cd, on, unfused, bc_bwd in (
            ("fp32", torch.float32, False, False, None),
            ("fp32", torch.float32, False, True, None),
            ("fp32", torch.float32, True, False, None),
            ("bf16", torch.bfloat16, False, False, None),
            ("bf16", torch.bfloat16, True, False, None),
            *((lb, cd, False, False, m)
              for lb, cd in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16))
              for m in BC_BWD_MODES[1:])):
        set_switches(on)
        set_switches(unfused, UNFUSED)
        set_switches(bc_bwd is not None, {"TERRAIN_BC_BWD": bc_bwd})
        label = (f"{label} switches {'on' if on else 'off'}"
                 + (" unfused decoder" if unfused else "")
                 + (f" TERRAIN_BC_BWD={bc_bwd}" if bc_bwd else ""))
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
        step_ms[label] = ms
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
        for name, per_step in expected_launches(on, unfused).items():
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
        if cd == torch.float32:
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
        del ts, before, batch
        torch.cuda.empty_cache()
    set_switches(False)
    set_switches(False, UNFUSED)
    os.environ.pop("TERRAIN_BC_BWD", None)
    return counts, step_ms


def train_agreement(torch):
    """One train step of the 256px configuration (every kernel's regime
    engages, the two opt-in ops switched on) with the same weights and batch
    on the card (kernels) and on the CPU (plain versions), fp32."""
    from terrain_tpu_torch.experiments import build_train

    set_switches(True)
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
    # at 256px five of the discriminator's six pools lie in pool2's regime
    want = {**expected_launches(True), "pool2_fwd": 10, "pool2_bwd": 10}
    for name, per_step in want.items():
        if got[name] != per_step:
            fail(f"agreement: {name} launched {got[name]} times, expected "
                 f"{per_step}")
    t0 = time.perf_counter()
    lc = cpu.train_step(cpu.opt_states, tuple(t.cpu() for t in batch), None,
                        cpu.lr)
    cpu_s = time.perf_counter() - t0
    set_switches(False)
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


# ------------------------------------------------------------------ phase 6
def trainer_slice(torch, card):
    """This slice's path at full width, through the entry point a user
    calls: `python -m terrain_tpu_torch test1_nobn_bilin_both train` on a
    synthetic set of the shipped set's size held on the card as uint8
    (TERRAIN_SYNTHETIC=1 TERRAIN_FAST=1 TERRAIN_N=240), both kernel switches
    on, augmentation in the step, one epoch with a checkpoint; then the same
    command resumes it (TERRAIN_RESUME=auto) for a second epoch.  Returns
    the launch counts of the two runs, added, and the first epoch's time."""
    import math
    import shutil
    import tempfile

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.experiments import _get_data, build_gan
    from terrain_tpu_torch.train import checkpoint
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    root = tempfile.mkdtemp(prefix="trainer_")
    env = {"TERRAIN_SYNTHETIC": "1", "TERRAIN_FAST": "1",
           "TERRAIN_N": str(TRAINER_N), "TERRAIN_SAVE_EVERY": "1",
           "TERRAIN_OUT": os.path.join(root, "out"),
           "TERRAIN_MODELS": os.path.join(root, "models")}
    saved = {k: os.environ.get(k) for k in
             (*env, "TERRAIN_EPOCHS", "TERRAIN_RESUME")}
    os.environ.update(env)
    set_switches(True)
    n_train, n_eval = TRAINER_N // TRAIN_BATCH, (TRAINER_N // 10) // TRAIN_BATCH
    out = os.path.join(root, "out", EXPERIMENT)
    models = os.path.join(root, "models", EXPERIMENT)
    counts = {}
    try:
        for epochs, resume in ((1, None), (2, "auto")):
            os.environ["TERRAIN_EPOCHS"] = str(epochs)
            if resume:
                os.environ["TERRAIN_RESUME"] = resume
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            t0 = time.perf_counter()
            if cli.main([EXPERIMENT, "train"]) != 0:
                fail("trainer: the CLI returned an error")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read_counters()
            peak = torch.cuda.max_memory_allocated()
            print(f"trainer [{card}]: `{EXPERIMENT} train` to epoch {epochs}"
                  f"{' (resumed)' if resume else ''}: {wall:.1f} s in all "
                  f"(data, epoch, dumps, checkpoint), peak memory "
                  f"{peak / 2**20:.1f} MiB, launches {got}", flush=True)
            # one epoch each: every train step 12/12/3/2, every eval step
            # the forwards, and 4 + 1 + 1 U-Net forwards in the dumps
            want = {k: n_train * v + n_eval * EVAL_LAUNCHES[k]
                    for k, v in SWITCHED_LAUNCHES.items()}
            want["conv_s2_fwd"] += 6
            for k, v in want.items():
                if got[k] != v:
                    fail(f"trainer: {k} launched {got[k]} times in the "
                         f"epoch, expected {v}")
            for k, v in TRAIN_LAUNCHES.items():
                if got[k] < n_train * v:
                    fail(f"trainer: {k} launched {got[k]} times")
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
        with open(os.path.join(out, "results.txt")) as f:
            lines = f.read().splitlines()
        header = lines[0].split(",")
        if header != (["epoch"] + [f"train_{k}" for k in TRAIN_KEYS]
                      + [f"valid_{k}" for k in TRAIN_KEYS]
                      + ["lr", "time", "mode"]) or len(lines) != 3:
            fail(f"trainer: results.txt has {len(lines)} lines, header "
                 f"{header}")
        rows = [dict(zip(header, ln.split(","))) for ln in lines[1:]]
        for i, row in enumerate(rows):
            vals = [float(row[c]) for c in header[1:11]]
            if row["epoch"] != str(i + 1) or not all(map(math.isfinite, vals)):
                fail(f"trainer: bad results row {row}")
            t = float(row["time"])
            print(f"trainer [{card}]: epoch {i + 1}: {t:.3f} s for "
                  f"{n_train} train + {n_eval} eval steps of batch "
                  f"{TRAIN_BATCH} ({TRAINER_N / t:.2f} images/s over the "
                  f"epoch, eval included); train losses "
                  f"{ {k: float(row['train_' + k]) for k in TRAIN_KEYS} }",
                  flush=True)
        for name in ("out_1.png", "out_2.png", "dump_train/3.b.png",
                     "dump_valid/0.a.png", "dump_a/19.png",
                     "arch_p2p_gen.txt"):
            if not os.path.exists(os.path.join(out, name)):
                fail(f"trainer: no {name} among the dumps")
        # both checkpoints load, and every parameter of every network moved
        gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False)
        fresh = {n: [p.detach().clone() for p in net.parameters()]
                 for n, net in gan.nets.items()}
        for e in (1, 2):
            path = os.path.join(models, f"{e}.model")
            trees, extra = checkpoint.load_model(path)
            if sorted(trees) != sorted(gan.nets) or extra["step"] <= 0:
                fail(f"trainer: {path} is incomplete")
            gan.load_model(path, exact=True)
            for n, net in gan.nets.items():
                same = sum(torch.equal(p, q) for p, q in
                           zip(net.parameters(), fresh[n]))
                if same:
                    fail(f"trainer: {same} parameters of {n} are unchanged "
                         f"in {e}.model")
        # the data path's share of a step: prepare (gather + normalize +
        # augment of one batch from the 250 MB set) by CUDA events, beside
        # the epoch's time per train step
        t0 = time.perf_counter()
        ds, _ = _get_data(gan.in_shp, device="cuda")
        torch.cuda.synchronize()
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        gan.save_model(os.path.join(models, "again.model"))
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(models, "again.model"))
        print(f"trainer: outside the epoch: making the {TRAINER_N}+"
              f"{TRAINER_N // 10} synthetic pairs and putting them on the "
              f"card {t_data:.1f} s; writing a checkpoint {t_save:.1f} s "
              f"({size / 2**20:.0f} MiB, weights and rmsprop state through "
              f"gzip level 1)", flush=True)
        prepare = ds.make_prepare(augment=True)
        idx = torch.arange(TRAIN_BATCH, device="cuda", dtype=torch.int32) * 7
        z = torch.rand(TRAIN_BATCH, gan.latent_dim, device="cuda")
        prep_ms = time_ms(lambda: prepare((z, idx), gan._next_rngs()))
        bare_ms = time_ms(lambda: ds.gather_normalize(idx))
        step_ms = float(rows[1]["time"]) * 1e3 / (n_train + n_eval)
        print(f"trainer [{card}]: prepare (gather + normalize + shear "
              f"augment, batch {TRAIN_BATCH}) {prep_ms:.3f} ms of device "
              f"time, gather + normalize alone {bare_ms:.3f} ms; epoch 2 "
              f"took {step_ms:.3f} ms per step: prepare share "
              f"{prep_ms / step_ms:.4f}; dataset on the card "
              f"{(ds.x.numel() + ds.y.numel()) / 2**20:.1f} MiB", flush=True)
        del gan, ds, fresh
        torch.cuda.empty_cache()
        # a generation mode, cheaply: train the small configuration, then
        # `gen` from its checkpoint
        for k in ("TERRAIN_N", "TERRAIN_EPOCHS", "TERRAIN_RESUME",
                  "TERRAIN_FAST", "TERRAIN_SAVE_EVERY"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        for mode in ("train", "gen"):
            if cli.main(["smoke_synthetic", mode]) != 0:
                fail(f"trainer: smoke_synthetic {mode} returned an error")
        gen = os.path.join(root, "out", "smoke_synthetic", "gen")
        if len(os.listdir(gen)) != 8:
            fail("trainer: smoke_synthetic gen wrote no 8 samples")
        print(f"trainer: smoke_synthetic train + gen on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        set_switches(False)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return counts, float(rows[0]["time"])


# ------------------------------------------------------------------ phase 7
def quality_slice(torch, card, trainer_epoch_s, bare_ms):
    """The trainer's quality path at full width, through the entry point:
    `python -m terrain_tpu_torch test1_nobn_bilin_both train` with the
    unfused decoder (UNFUSED), TERRAIN_SWD=1 and TERRAIN_PROFILE, on host
    iterators over synthetic pairs (TERRAIN_FAST unset) behind the
    prefetcher, QUALITY_EPOCHS epochs with a checkpoint each; then `gen`,
    which picks its checkpoint from the run's swd.txt.  Checks swd.txt
    (terrain_tpu's columns, finite values), the pick, the trace, the launch
    counts, and SWD and terrain W1 of the same images on the card against
    the CPU.  Returns the launch counts of train and gen, added."""
    import contextlib
    import io
    import math
    import shutil
    import tempfile

    import numpy as np

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.data.prefetch import Prefetcher
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.eval import swd_pyramid, terrain_stats
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    root = tempfile.mkdtemp(prefix="quality_")
    trace_dir = os.path.join(root, "trace")
    env = {"TERRAIN_SYNTHETIC": "1", "TERRAIN_N": str(QUALITY_N),
           "TERRAIN_EPOCHS": str(QUALITY_EPOCHS), "TERRAIN_SAVE_EVERY": "1",
           "TERRAIN_SWD": "1", "TERRAIN_PROFILE": trace_dir,
           "TERRAIN_OUT": os.path.join(root, "out"),
           "TERRAIN_MODELS": os.path.join(root, "models"), **UNFUSED}
    unset = ("TERRAIN_FAST", "TERRAIN_RESUME", "TERRAIN_PICK",
             "TERRAIN_PREFETCH", "TERRAIN_TERRAIN_METRICS")
    saved = {k: os.environ.get(k) for k in (*env, *unset)}
    for k in unset:
        os.environ.pop(k, None)
    os.environ.update(env)
    out = os.path.join(root, "out", EXPERIMENT)
    n_train = QUALITY_N // TRAIN_BATCH
    n_eval = max(QUALITY_N // 10, 4) // TRAIN_BATCH
    # measurement hooks, on the classes and for this phase only: the time
    # and peak memory of each epoch's passes, dumps and SWD evaluation, and
    # the batches the prefetcher copied
    seg = {"run_epoch": [], "dump_epoch": [], "log_swd": []}
    copied = [0]
    saved_methods = {name: getattr(TwoStageGAN, "_" + name) for name in seg}
    to_device = Prefetcher._to_device

    def timed(name):
        method = saved_methods[name]

        def run(self, *a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = method(self, *a, **k)
            torch.cuda.synchronize()
            seg[name].append((round(time.perf_counter() - t0, 3),
                              round(torch.cuda.max_memory_allocated()
                                    / 2**20, 1)))
            return out
        return run

    def counted_to_device(self, item):
        copied[0] += 1
        return to_device(self, item)

    for name in seg:
        setattr(TwoStageGAN, "_" + name, timed(name))
    Prefetcher._to_device = counted_to_device
    counts = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        if cli.main([EXPERIMENT, "train"]) != 0:
            fail("quality: the CLI returned an error")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counters()
        print(f"quality [{card}]: `{EXPERIMENT} train` with "
              f"{' '.join(f'{k}={v}' for k, v in UNFUSED.items())} "
              f"TERRAIN_SWD=1 TERRAIN_PROFILE, {QUALITY_N} synthetic pairs on "
              f"host iterators, {QUALITY_EPOCHS} epochs: {wall:.1f} s in all "
              f"(data, epochs, dumps, SWD, trace, checkpoints); batches "
              f"through the prefetcher {copied[0]}; launches {got}",
              flush=True)
        print(f"quality [{card}]: (s, peak MiB) of each train and valid "
              f"pass {seg['run_epoch']}, each epoch's dumps "
              f"{seg['dump_epoch']}, each SWD evaluation {seg['log_swd']}",
              flush=True)
        # per epoch: a forward per train and eval step, 4 + 1 + 1 U-Net
        # forwards in the dumps and one (of SWD_N images) in the SWD
        # evaluation; a backward per train step; no fused decoder
        want = {"bilinear": QUALITY_EPOCHS * (n_train + n_eval + 7),
                "bilinear_backward": QUALITY_EPOCHS * n_train,
                "bilinear_conv": 0, "bilinear_conv_backward": 0,
                "pool2_fwd": 0, "conv_s2_fwd": 0}
        for k, v in want.items():
            if got[k] != v:
                fail(f"quality: {k} launched {got[k]} times, expected {v}")
        for k, v in TRAIN_LAUNCHES.items():
            if v and k not in want and got[k] < QUALITY_EPOCHS * n_train * v:
                fail(f"quality: {k} launched {got[k]} times")
        if copied[0] < QUALITY_EPOCHS * (n_train + n_eval):
            fail(f"quality: the prefetcher copied {copied[0]} batches")
        counts = dict(got)
        with open(os.path.join(out, "results.txt")) as f:
            rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
        times = [float(r[-2]) for r in rows]
        per_step = [t * 1e3 / (n_train + n_eval) for t in times]
        dev_steps = TRAINER_N // TRAIN_BATCH + (TRAINER_N // 10) // TRAIN_BATCH
        print(f"quality [{card}]: epoch `time` {times} s, {per_step} ms per "
              f"step of batch {TRAIN_BATCH} (eval included; epoch 1 warms "
              f"up, epoch 2 is traced); the bare step of this configuration "
              f"{bare_ms:.3f} ms; the device-resident trainer phase's first "
              f"epoch {trainer_epoch_s:.3f} s, "
              f"{trainer_epoch_s * 1e3 / dev_steps:.3f} ms per step (fused "
              f"decoder, opt-in switches on)", flush=True)
        # swd.txt: terrain_tpu's columns for train_mode both, in its order
        with open(os.path.join(out, "swd.txt")) as f:
            lines = f.read().splitlines()
        header = lines[0].split(",")
        cols = ([f"swd_level{i}" for i in range(4)] + ["swd_mean",
                "elev_w1", "slope_w1"]
                + [f"p2p_swd_level{i}" for i in range(4)] + ["p2p_swd_mean"])
        if header != ["epoch"] + cols or len(lines) != QUALITY_EPOCHS + 1:
            fail(f"quality: swd.txt header {header}, {len(lines)} lines")
        swd_rows = [dict(zip(header, ln.split(","))) for ln in lines[1:]]
        for i, row in enumerate(swd_rows):
            vals = [float(row[c]) for c in cols]
            if row["epoch"] != str(i + 1) or not all(map(math.isfinite,
                                                         vals)):
                fail(f"quality: bad swd.txt row {row}")
        print(f"quality: swd.txt {lines}", flush=True)
        traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        sizes = [os.path.getsize(os.path.join(trace_dir, t)) for t in traces]
        if len(traces) != 1 or not sizes[0]:
            fail(f"quality: TERRAIN_PROFILE wrote {traces} {sizes}")
        with open(os.path.join(trace_dir, traces[0])) as f:
            n_kern = f.read().count('"cat": "kernel"')
        print(f"quality: trace {traces[0]}, {sizes[0] / 2**20:.1f} MiB, "
              f"{n_kern} device kernel events", flush=True)
        # gen: picks the epoch of the least swd_mean from swd.txt
        best = min(swd_rows, key=lambda r: float(r["swd_mean"]))["epoch"]
        _reset_counters()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([EXPERIMENT, "gen"])
        gen_s = time.perf_counter() - t0
        said = buf.getvalue()
        print(said, end="", flush=True)
        gen_counts = _read_counters()
        n_png = len(os.listdir(os.path.join(out, "gen")))
        if rc != 0 or f"best @e{best} " not in said \
                or f"checkpoint {best}.model" not in said or n_png != 100:
            fail(f"quality: gen did not pick epoch {best} from swd.txt or "
                 f"wrote {n_png} samples")
        print(f"quality [{card}]: gen picked {best}.model from swd.txt and "
              f"wrote {n_png} samples in {gen_s:.1f} s; launches "
              f"{gen_counts} (gen samples the DCGAN generator only)",
              flush=True)
        for k, v in gen_counts.items():
            counts[k] = counts.get(k, 0) + v
        # SWD and terrain W1 of the same images on the card and on the CPU
        # (the draws come from one host generator, so they are the same)
        real = make_pairs(SWD_N, 512, seed=1)[0].astype(np.float32) / 255.0
        fake = make_pairs(SWD_N, 512, seed=2)[0].astype(np.float32) / 255.0
        res = {}
        for dev in ("cuda", "cpu"):
            r, f_ = (torch.from_numpy(a).to(dev) for a in (real, fake))
            t0 = time.perf_counter()
            res[dev] = {**swd_pyramid(r, f_, seed=0, n_levels=3),
                        **terrain_stats(r, f_, seed=0)}
            res[dev + "_s"] = time.perf_counter() - t0
        worst = max(abs(res["cuda"][k] - v) / max(abs(v), 1e-12)
                    for k, v in res["cpu"].items())
        print(f"quality: SWD pyramid + terrain W1 of {SWD_N} 512px "
              f"heightmaps, card vs CPU: largest relative difference "
              f"{worst:.3e} (tol {SWD_TOL}); card {res['cuda_s']:.3f} s, "
              f"CPU {res['cpu_s']:.3f} s; values {res['cuda']}", flush=True)
        if not worst <= SWD_TOL:
            fail("quality: SWD on the card and on the CPU disagree")
        # the SWD evaluation's peak memory: its U-Net forward on SWD_N
        # images, with the decoder fused (the default) and unfused
        from terrain_tpu_torch.experiments import build_model

        pipe, _ = build_model(EXPERIMENT, "cuda", seed=0)
        x = torch.from_numpy(real).cuda()
        peaks = {}
        for n in (TRAIN_BATCH, SWD_N):
            for label, on in (("fused", False), ("unfused", True)):
                set_switches(on, UNFUSED)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                pipe.atob_det(x[:n])
                torch.cuda.synchronize()
                peaks[f"{label} decoder, batch {n}"] = round(
                    (torch.cuda.max_memory_allocated() - base) / 2**20, 1)
        print(f"quality [{card}]: peak MiB above the resident weights of the "
              f"U-Net G det forward at 512px {peaks}", flush=True)
        del pipe, x
    finally:
        for name, method in saved_methods.items():
            setattr(TwoStageGAN, "_" + name, method)
        Prefetcher._to_device = to_device
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return counts


# ------------------------------------------------------------------ phase 8
def _synthetic_raster(np, seed=0):
    """A raster pair at the NASA rasters' size: a heightmap of a few
    separable waves, made at a quarter of the size and repeated 4x4, about
    30% of it ocean (zeros) in large regions, and an RGB texture coloured
    from it; both carry 2 bits of noise at full size from a random tile
    wider than zlib's window, so neither compresses to nothing."""
    rnd = np.random.RandomState(seed)
    h, w = RASTER_H // 4, RASTER_W // 4
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for _ in range(4):
        fy, fx, py, px = rnd.uniform(1, 9, 4)
        f += np.sin(fy * 6.2832 * y + py) * np.cos(fx * 6.2832 * x + px)
    f -= np.quantile(f, 0.3)
    land = f > 0
    small = np.where(land, f * np.float32(240.0) / f.max() + 1, 0)
    small = small.astype(np.uint8)
    colour = np.stack([small // 2 + 60, small // 3 + 80,
                       np.where(land, 70, 160).astype(np.uint8)], -1)

    def full(a):
        return np.repeat(np.repeat(a, 4, 0), 4, 1)

    noise = rnd.randint(0, 4, size=(512, 16384)).astype(np.uint8)
    noise = np.tile(noise, (RASTER_H // 512 + 1, RASTER_W // 16384 + 1))
    noise = noise[:RASTER_H, :RASTER_W]
    hm = full(small)
    hm += noise * full(land)
    tex = full(colour)
    tex += noise[..., None]
    return hm, tex


def _plain_crops(np, hm, tex, bs, crop, seed, threshold=0.9):
    """RasterCropIterator's first batch by plain slicing: offsets drawn
    max(need * 2, 4) at a time, rows before columns, a crop kept while its
    heightmap is at most `threshold` zeros."""
    rnd = np.random.RandomState(seed)
    got, need = [], bs
    while need > 0:
        n = max(need * 2, 4)
        ys = rnd.randint(0, hm.shape[0] - crop + 1, size=n)
        xs = rnd.randint(0, hm.shape[1] - crop + 1, size=n)
        keep = [(y, x) for y, x in zip(ys, xs)
                if (hm[y:y + crop, x:x + crop] == 0).mean() <= threshold]
        got += keep[:need]
        need -= len(keep[:need])
    return (np.stack([hm[y:y + crop, x:x + crop, None] for y, x in got]),
            np.stack([tex[y:y + crop, x:x + crop] for y, x in got]))


def raster_slice(torch, card):
    """The raster input path at the NASA rasters' size: a synthetic pair
    (_synthetic_raster) written as PNGs whose rows cycle through the five
    filter types, decoded by the port's codec (timed; the pair must come
    back byte-equal), the crop iterator's first batch against plain
    slicing, its crops/s and rejection share, then two epochs of
    `TERRAIN_RASTER=hm.png,tex.png TERRAIN_EPOCH_CROPS=48 python -m
    terrain_tpu_torch test1_nobn_bilin_both train` through cli.main with the
    counters set to 0 just before and read just after.  Returns them."""
    import math
    import shutil
    import tempfile

    import numpy as np

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.data import RasterCropIterator, augment_pair
    from terrain_tpu_torch.serve.png import decode_png, encode_png
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    root = tempfile.mkdtemp(prefix="raster_")
    saved = {k: os.environ.get(k) for k in (
        "TERRAIN_RASTER", "TERRAIN_EPOCH_CROPS", "TERRAIN_EPOCHS",
        "TERRAIN_OUT", "TERRAIN_MODELS", "TERRAIN_SYNTHETIC", "TERRAIN_FAST",
        "TERRAIN_N", "TERRAIN_RESUME", "TERRAIN_SAVE_EVERY",
        "TERRAIN_ARTIFACT_EVERY")}
    try:
        t0 = time.perf_counter()
        hm, tex = _synthetic_raster(np)
        t_make = time.perf_counter() - t0
        paths, sizes = [], []
        t0 = time.perf_counter()
        for name, img in (("hm.png", hm), ("tex.png", tex)):
            data = encode_png(img, level=1,
                              filters=np.arange(RASTER_H) % 5)
            paths.append(os.path.join(root, name))
            sizes.append(len(data))
            with open(paths[-1], "wb") as f:
                f.write(data)
            del data
        t_write = time.perf_counter() - t0
        print(f"raster: made a {RASTER_W}x{RASTER_H} pair (heightmap "
              f"{(hm == 0).mean():.3f} ocean) in {t_make:.1f} s, wrote it as "
              f"PNGs with filter types 0-4 by row (zlib level 1, "
              f"{sizes[0] / 1e6:.1f} + {sizes[1] / 1e6:.1f} MB) in "
              f"{t_write:.1f} s", flush=True)
        decoded, t_dec = [], 0.0
        for path, img in zip(paths, (hm, tex)):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                out = decode_png(f.read())
            dt = time.perf_counter() - t0
            t_dec += dt
            print(f"raster [{card}]: decoded {os.path.basename(path)} "
                  f"{out.shape} in {dt:.2f} s ({img.nbytes / dt / 1e6:.1f} "
                  f"MB/s of pixels)", flush=True)
            if not np.array_equal(out.reshape(img.shape), img):
                fail(f"raster: {path} decoded to other bytes")
            decoded.append(out)
        if t_dec > RASTER_DECODE_S:
            fail(f"raster: decoding the pair took {t_dec:.1f} s > "
                 f"{RASTER_DECODE_S} s")
        dhm, dtex = decoded[0][..., 0], decoded[1][..., :3]
        del decoded
        it = RasterCropIterator(dhm, dtex, TRAIN_BATCH, crop=512,
                                epoch_size=RASTER_CROPS, seed=0)
        x, y = it.next_uint8()
        px, py = _plain_crops(np, dhm, dtex, TRAIN_BATCH, 512, 0)
        if not (np.array_equal(x, px) and np.array_equal(y, py)):
            fail("raster: the iterator's first batch is not the plain "
                 "slices of the decoded pair")
        t0 = time.perf_counter()
        n_batches = RASTER_CROPS // TRAIN_BATCH
        for _ in range(n_batches):
            next(it)  # crop, ocean filter, normalize
        t_batch = (time.perf_counter() - t0) / n_batches
        accepted = (n_batches + 1) * TRAIN_BATCH
        print(f"raster: the first batch equals plain slicing of the decoded "
              f"pair; {TRAIN_BATCH / t_batch:.1f} crops/s "
              f"accepted (a host batch of {TRAIN_BATCH}: crop, filter, "
              f"normalize {t_batch * 1e3:.1f} ms), rejection share "
              f"{1 - accepted / it.drawn:.3f} ({it.drawn} offsets drawn; "
              f"a try draws twice what it needs and keeps the first "
              f"non-ocean ones)",
              flush=True)
        g = torch.Generator(device="cuda").manual_seed(0)
        xa = torch.from_numpy(x).cuda().float() / 255.0
        ya = torch.from_numpy(y).cuda().float() / 127.5 - 1.0
        aug_ms = time_ms(lambda: augment_pair(g, xa, ya))
        del dhm, dtex, hm, tex, it
        os.environ.update({
            "TERRAIN_RASTER": ",".join(paths),
            "TERRAIN_EPOCH_CROPS": str(RASTER_CROPS), "TERRAIN_EPOCHS": "2",
            "TERRAIN_OUT": os.path.join(root, "out"),
            "TERRAIN_MODELS": os.path.join(root, "models"),
            "TERRAIN_SAVE_EVERY": "10", "TERRAIN_ARTIFACT_EVERY": "1000"})
        for k in ("TERRAIN_SYNTHETIC", "TERRAIN_FAST", "TERRAIN_N",
                  "TERRAIN_RESUME"):
            os.environ.pop(k, None)
        set_switches(False)
        _reset_counters()
        t0 = time.perf_counter()
        if cli.main([EXPERIMENT, "train"]) != 0:
            fail("raster: the CLI returned an error")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counters()
        with open(os.path.join(root, "out", EXPERIMENT, "results.txt")) as f:
            header, *rows = [ln.split(",") for ln in f.read().splitlines()]
        rows = [dict(zip(header, r)) for r in rows]
        for row in rows:
            vals = [float(row[f"{s}_{k}"]) for s in ("train", "valid")
                    for k in TRAIN_KEYS]
            if not all(map(math.isfinite, vals)):
                fail(f"raster: a loss is not finite: {row}")
        if len(rows) != 2:
            fail(f"raster: results.txt has {len(rows)} epochs")
        n_train = RASTER_CROPS // TRAIN_BATCH
        n_eval = max(RASTER_CROPS // 10, TRAIN_BATCH) // TRAIN_BATCH
        for k, v in TRAIN_LAUNCHES.items():
            if got[k] < 2 * n_train * v:
                fail(f"raster: {k} launched {got[k]} times in 2 x {n_train} "
                     f"train steps")
        epochs = [float(r["time"]) for r in rows]
        row = rows[1]
        step_ms = epochs[1] * 1e3 / (n_train + n_eval)
        print(f"raster [{card}]: `TERRAIN_RASTER=hm.png,tex.png "
              f"TERRAIN_EPOCH_CROPS={RASTER_CROPS} {EXPERIMENT} train`: "
              f"{wall:.1f} s in all (decoding the pair again included), "
              f"epochs {epochs[0]:.3f} / {epochs[1]:.3f} s for {n_train} "
              f"train + {n_eval} eval steps (epoch 2: {step_ms:.3f} ms a "
              f"step); a host batch "
              f"{t_batch * 1e3:.1f} ms = {t_batch * 1e3 / step_ms:.3f} of a "
              f"step (on the prefetcher's thread), the augmentation on the "
              f"card {aug_ms:.3f} ms = {aug_ms / step_ms:.4f}; losses "
              f"{ {k: float(row['train_' + k]) for k in TRAIN_KEYS} }; "
              f"launches {got}", flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return got


# ------------------------------------------------------------------ phase 9
def _scan_setup(torch, np, cd):
    """The flagship trainer's networks, optimizer and train step (with
    the paired augmentation, so the graph draws from its generators) over
    SCAN_N synthetic pairs on the card."""
    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.experiments import build_gan

    gan, _ = build_gan(EXPERIMENT, "cuda", compute_dtype=cd, verbose=False)
    ds = DeviceDataset(*make_pairs(SCAN_N, gan.in_shp, seed=0),
                       device="cuda")
    tr, _ = gan._build_steps(ds.make_prepare(augment=True))
    return gan, ds, tr


def _chunk(torch, np, gan, ds, k, seed):
    rnd = np.random.RandomState(seed)
    Z = torch.from_numpy(rnd.rand(k, TRAIN_BATCH, gan.latent_dim).astype(
        np.float32)).cuda()
    idx = torch.from_numpy(rnd.randint(0, ds.N, (k, TRAIN_BATCH)).astype(
        np.int32)).cuda()
    return [ds.batch_args(Z[t], idx[t]) for t in range(k)]


def _held(e1, e2, g):
    """Per category (losses, parameters, BN statistics, optimizer state):
    the graph run against two eager runs, all three bit-equal.  Returns
    {category: (eager vs eager max abs, graph vs eager max abs, tensors
    bit-equal eager/eager, of those bit-equal in the graph, tensors)} and
    the failures."""
    out, bad = {}, []
    for cat in e1:
        ee_max = ge_max = 0.0
        same = same_g = 0
        for i, (a, b, c) in enumerate(zip(e1[cat], e2[cat], g[cat])):
            ee = float((a - b).abs().max()) if a.numel() else 0.0
            ge = float((c - a).abs().max()) if a.numel() else 0.0
            ee_max, ge_max = max(ee_max, ee), max(ge_max, ge)
            same += a.equal(b)
            same_g += a.equal(b) and c.equal(a)
            if not a.equal(b):
                bad.append(f"{cat}[{i}]: eager differs from itself by "
                           f"{ee:.3e}")
            elif not c.equal(a):
                bad.append(f"{cat}[{i}]: the graph is off eager by {ge:.3e}")
        out[cat] = (ee_max, ge_max, same, same_g, len(e1[cat]))
    return out, bad


def scan_equivalence(torch, np, card):
    """Eager steps against one CUDA graph of SCAN_K steps, from one saved
    state (networks, BN statistics, optimizer state, generator seeds), by
    default (the fp32 step is run-to-run deterministic since the port's
    repairs: device.strict_fp32, ops/resize.Bilinear2xLib), in fp32 and
    bf16, with the opt-in switches off and on: k eager steps twice, then
    two replays, every tensor bit-equal; then, fp32 switches off, the same
    at half the lr (the graph captured anew), and with adam, whose step
    count the graph advances on the device.  Returns the bf16 and fp32
    setups (rmsprop) for timing."""
    from terrain_tpu_torch.train import optim
    from terrain_tpu_torch.train.losses import TRAIN_KEYS
    from terrain_tpu_torch.train.step import build_scan_step

    kept = {}
    for label, cd in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gan, ds, tr = _scan_setup(torch, np, cd)
        batches = _chunk(torch, np, gan, ds, SCAN_K, 5)
        runs = [(False, 1.0, "rmsprop"), (True, 1.0, "rmsprop")]
        if label == "fp32":
            runs += [(False, 0.5, "rmsprop"), (False, 1.0, "adam")]
        for on, lr_scale, opt in runs:
            set_switches(on)
            if opt != gan.optimizer.name:
                gan.optimizer = optim.get_optimizer(opt)
                gan._init_opt_states()
                tr, _ = gan._build_steps(ds.make_prepare(augment=True))
            cats = {"params": [p for n in gan.nets.values()
                               for p in n.parameters()],
                    "bn_stats": [b for n in gan.nets.values()
                                 for b in n.buffers()],
                    opt: [t for st in gan.opt_states.values()
                          for v in st.values()
                          for t in (v if isinstance(v, list) else [v])]}
            every = [t for ts in cats.values() for t in ts]
            saved = [t.detach().clone() for t in every]
            counter = gan._step_counter

            def start():
                with torch.no_grad():
                    for t, v in zip(every, saved):
                        t.copy_(v)
                gan._step_counter = counter
                return [gan._next_rngs(t) for t in range(SCAN_K)]

            def result(losses):
                return {"losses": [losses[k].float().clone()
                                   for k in TRAIN_KEYS],
                        **{c: [t.detach().float().clone() for t in ts]
                           for c, ts in cats.items()}}

            def eager(lr):
                rngs = start()
                outs = [tr(gan.opt_states, b, r, lr)
                        for b, r in zip(batches, rngs)]
                return result({k: torch.stack([o[k] for o in outs])
                               for k in TRAIN_KEYS})

            lr = gan.lr * lr_scale
            scan = build_scan_step(tr)
            e1, e2 = eager(lr), eager(lr)
            t0 = time.perf_counter()
            g = result(scan(gan.opt_states, batches, start(), lr))
            t_cap = time.perf_counter() - t0
            g2 = result(scan(gan.opt_states, batches, start(), lr))
            held, bad = _held(e1, e2, g)
            _, bad2 = _held(e1, e2, g2)  # a second replay of the graph
            what = (f"{label} {opt} switches {'on' if on else 'off'}"
                    + (f", lr x{lr_scale}" if lr_scale != 1.0 else ""))
            print(f"scan [{card}] {what}: {SCAN_K} eager steps twice vs one "
                  f"graph of {SCAN_K} (warm-up + capture + replay "
                  f"{t_cap:.1f} s): " + "; ".join(
                      f"{c} eager/eager {ee:.3e} graph/eager {ge:.3e}, "
                      f"bit-equal {sg}/{s} of {n}"
                      for c, (ee, ge, s, sg, n) in held.items()),
                  flush=True)
            if bad or bad2:
                fail(f"scan {what}: eager and the graph are not bit-equal: "
                     f"{(bad + bad2)[:5]}")
            if lr_scale == 1.0 and opt == "rmsprop":
                # the hand-written kernels in a replay
                _, prof = profiled(torch, lambda: scan(
                    gan.opt_states, batches, start(), lr))
                counts = {name: sum(c for _, c, key in prof if sym in key)
                          for name, sym in KERNEL_SYMBOLS.items()}
                print(f"scan {what}: hand-written kernels in one profiled "
                      f"replay of {SCAN_K} steps {counts}", flush=True)
                for name, n in expected_launches(on).items():
                    if name in KERNEL_SYMBOLS and counts[name] != SCAN_K * n:
                        fail(f"scan {what}: {name} ran {counts[name]} times "
                             f"in the replay, expected {SCAN_K} x {n}")
            start()  # the saved state back
            del scan, e1, e2, g, g2, saved, every, cats
        set_switches(False)
        if gan.optimizer.name != "rmsprop":
            gan.optimizer = optim.get_optimizer("rmsprop")
            gan._init_opt_states()
            tr, _ = gan._build_steps(ds.make_prepare(augment=True))
        torch.cuda.empty_cache()
        kept[label] = (gan, ds, tr)
    return kept


def scan_timing(torch, np, card, kept):
    """Per step at TERRAIN_SCAN=16, switches off, eager and graph in turns
    (eager, graph, graph, eager: host clock around a synchronized chunk),
    and the profiled device time and busy share of each.  (The profiler
    may drop some of a 16-step replay's ~53,000 kernel events: the kernel
    counts are held on the 4-step replays of scan_equivalence.)"""
    from terrain_tpu_torch.train.step import build_scan_step

    k = SCAN_TIME_K
    for label, (gan, ds, tr) in kept.items():
        batches = _chunk(torch, np, gan, ds, k, 6)
        scan = build_scan_step(tr)

        def eager():
            rngs = [gan._next_rngs(t) for t in range(k)]
            for b, r in zip(batches, rngs):
                tr(gan.opt_states, b, r, gan.lr)

        def graph():
            scan(gan.opt_states, batches,
                 [gan._next_rngs(t) for t in range(k)], gan.lr)

        graph()  # warm-up and capture
        eager()
        per = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (eager if mode == "eager" else graph)()
            torch.cuda.synchronize()
            per[mode].append((time.perf_counter() - t0) * 1e3 / k)
        prof = {m: profiled(torch, f) for m, f in (("eager", eager),
                                                    ("graph", graph))}
        busy = {m: sum(r[0] for r in rows) / k
                for m, (_, rows) in prof.items()}
        share = {m: busy[m] * k / wall for m, (wall, _) in prof.items()}
        print(f"scan [{card}] {label} switches off, TERRAIN_SCAN={k}: per "
              f"step eager {per['eager'][0]:.3f}, graph "
              f"{per['graph'][0]:.3f}, graph {per['graph'][1]:.3f}, eager "
              f"{per['eager'][1]:.3f} ms (host clock, in turns); profiled "
              f"device time a step eager {busy['eager']:.3f} ms (busy share "
              f"{share['eager']:.3f}), graph {busy['graph']:.3f} ms (busy "
              f"share {share['graph']:.3f}); "
              f"{sum(r[1] for r in prof['eager'][1]) / k:.0f} kernels a step "
              f"eager, {sum(r[1] for r in prof['graph'][1]) / k:.0f} in the "
              f"replay", flush=True)
        counts = {name: sum(c for _, c, key in prof["graph"][1] if sym in key)
                  for name, sym in KERNEL_SYMBOLS.items()}
        print(f"scan {label}: hand-written kernels among the profiler's "
              f"events of one replay of {k} steps {counts}", flush=True)
        graph_ms = statistics.mean(per["graph"])
        if label == "bf16" and graph_ms > SCAN_BUSY_LIMIT * busy["graph"]:
            fail(f"scan bf16: the graph's step {graph_ms:.3f} ms is more "
                 f"than {SCAN_BUSY_LIMIT} x its device time "
                 f"{busy['graph']:.3f} ms")
        del scan, batches
    kept.clear()
    torch.cuda.empty_cache()


def scan_trainer(torch, np, card):
    """The trainer on TRAINER_N pairs held on the card at TERRAIN_SCAN=16
    (chunks of 15 train and 6 eval steps), dumps off: first `python -m
    terrain_tpu_torch test1_nobn_bilin_both train` in fp32 through cli.main,
    two epochs, with the counters set to 0 just before and read just
    after (its dW and dX kernels show one warm-up step and one capture of
    15, not the 120 steps: the graph outlives the epoch); then, on the same
    pairs made once, an eager epoch from the same seed against it, and in
    bf16 two TERRAIN_SCAN=16 epochs against an eager one.  Eager is
    bit-equal to itself in both settings (scan_equivalence), so epoch 1's
    loss columns must be equal.  Returns the counts."""
    import math
    import shutil
    import tempfile

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.experiments import _get_data, build_gan
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    root = tempfile.mkdtemp(prefix="scan_")
    env = {"TERRAIN_SYNTHETIC": "1", "TERRAIN_FAST": "1",
           "TERRAIN_N": str(TRAINER_N), "TERRAIN_EPOCHS": "2",
           "TERRAIN_SAVE_EVERY": "10", "TERRAIN_ARTIFACT_EVERY": "1000",
           "TERRAIN_OUT": os.path.join(root, "cli"),
           "TERRAIN_MODELS": os.path.join(root, "cli_models"),
           "TERRAIN_SCAN": str(SCAN_TIME_K)}
    saved = {k: os.environ.get(k) for k in (
        *env, "TERRAIN_DTYPE", "TERRAIN_RESUME")}
    os.environ.update(env)
    for k in ("TERRAIN_RESUME", "TERRAIN_DTYPE"):
        os.environ.pop(k, None)
    set_switches(False)
    n_train = TRAINER_N // TRAIN_BATCH
    n_eval = (TRAINER_N // 10) // TRAIN_BATCH
    cols = [f"{s}_{k}" for s in ("train", "valid") for k in TRAIN_KEYS]

    def read(out_dir):
        with open(os.path.join(out_dir, "results.txt")) as f:
            header, *rows = [ln.split(",") for ln in f.read().splitlines()]
        rows = [dict(zip(header, r)) for r in rows]
        for row in rows:
            if not all(math.isfinite(float(row[c])) for c in cols):
                fail(f"scan trainer: a loss is not finite: {row}")
        return rows

    try:
        np.random.seed(0)  # the prior sampler's stream
        _reset_counters()
        if cli.main([EXPERIMENT, "train"]) != 0:
            fail("scan trainer: the CLI returned an error")
        counts = _read_counters()
        first = read(os.path.join(root, "cli", EXPERIMENT))
        print(f"scan trainer: launches of the fp32 TERRAIN_SCAN="
              f"{SCAN_TIME_K} run through the CLI, 2 epochs (eager "
              f"warm-ups and captures; replays add none) {counts}",
              flush=True)
        for k in ("conv_stem_dw", "conv_stem_dx", "conv_thin_dx",
                  "conv_thin_dw"):
            if counts[k] != 16 * TRAIN_LAUNCHES[k]:
                fail(f"scan trainer: {k} launched {counts[k]} times, "
                     f"expected 16 (a warm-up step and a capture of 15)")
        data = _get_data(512, device="cuda")
        for label, cd in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            rows = {"graph": first} if label == "fp32" else {}
            for run in ("graph", "eager"):
                if run in rows:
                    continue
                os.environ["TERRAIN_SCAN"] = ("1" if run == "eager"
                                              else str(SCAN_TIME_K))
                gan, _ = build_gan(EXPERIMENT, "cuda", compute_dtype=cd,
                                   verbose=False)
                out = os.path.join(root, f"{label} {run}")
                np.random.seed(0)
                gan.train(*data, TRAIN_BATCH, 2 if run == "graph" else 1,
                          out, save_every=10)
                rows[run] = read(out)
                del gan
            graph, eager = rows["graph"], rows["eager"][0]
            off = [c for c in cols if graph[0][c] != eager[c]]
            print(f"scan trainer [{card}] {label}: `{EXPERIMENT} train` on "
                  f"{TRAINER_N} pairs on the card, {n_train} train + "
                  f"{n_eval} eval steps an epoch: at TERRAIN_SCAN="
                  f"{SCAN_TIME_K} (chunks of 15 and 6) epoch 1 "
                  f"{float(graph[0]['time']):.3f} s (capture included), "
                  f"epoch 2 {float(graph[1]['time']):.3f} s; eager "
                  f"{float(eager['time']):.3f} s; epoch 1's loss columns "
                  f"equal to eager's: {len(cols) - len(off)} of {len(cols)}",
                  flush=True)
            if off:
                fail(f"scan trainer {label}: columns {off} of the graph's "
                     f"epoch differ from eager's: {graph[0]} vs {eager}")
        del data
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def scan_slice(torch, card):
    import numpy as np

    kept = scan_equivalence(torch, np, card)
    scan_timing(torch, np, card, kept)
    return scan_trainer(torch, np, card)


# ----------------------------------------------------------------- phase 10
def _snapshot(gan):
    """A function that puts gan back as it is now: parameters, BN
    statistics, optimizer state and the step counter its draws follow."""
    import torch

    from terrain_tpu_torch.train.step import step_state

    state = step_state(gan.nets, gan.opt_states)
    saved = [t.detach().clone() for t in state]
    counter = gan._step_counter

    def restore():
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        gan._step_counter = counter

    return restore


def _recording(gan, scale=1.0):
    """gan's optimizer, wrapped to keep the gradients each update is given
    (after the data group's all-reduce; times `scale`, a planted fault,
    when it is not 1): returns the list they go to, one entry per network
    and step, in NET_NAMES order."""
    import dataclasses

    rec, opt = [], gan.optimizer

    def update(params, grads, state, lr):
        if scale != 1.0:
            grads = [g * scale for g in grads]
        rec.append([g.detach().clone() for g in grads])
        opt.update(params, grads, state, lr)

    gan.optimizer = dataclasses.replace(opt, update=update)
    return rec


def _par_step(torch, gan, batch, scale=1.0):
    """One train step of gan (its augmentation on) on the host batch
    (Z, X, Y): (losses, {network: gradients it updated with})."""
    from terrain_tpu_torch.train.step import NET_NAMES

    opt = gan.optimizer
    rec = _recording(gan, scale)
    tr, _ = gan._build_steps(gan._host_prepare)
    gan.optimizer = opt
    losses = tr(gan.opt_states, batch, gan._next_rngs(), gan.lr)
    return ({k: float(v) for k, v in losses.items()},
            dict(zip(NET_NAMES, rec)))


def _tiled_sampler(index, seed):
    """A prior sampler whose data-parallel shards tile one global draw:
    rank `index` of a world drawing n rows a step gets global rows
    index*n .. index*n+n-1 (tests/tiny_cfg.py's det_sampler), a stream
    of its own for each seed."""
    import numpy as np

    state = {"c": 0}

    def sampler(n, d):
        c = state["c"]
        state["c"] += 1
        g = index * n + np.arange(n)[:, None]
        v = np.sin(g * 12.9898 + np.arange(d)[None, :] * 78.233
                   + c * 37.719 + seed * 4.1414) * 43758.5453
        return (v % 1.0).astype(np.float32)

    return sampler


@contextlib.contextmanager
def _discriminators_as_ranks(torch, gan, world, n):
    """gan's two discriminators (neither has a BatchNorm or dropout, so
    each row's output is its own) run as the `world` ranks of a
    data-parallel step at global batch n run them: one call on each
    rank's rows of every block of n rows (a call on real and fake rows
    holds two blocks), the outputs put back in order.  The same function;
    the sums over the batch of their backward (dW) in the ranks' order."""
    from terrain_tpu_torch.train.step import has_bn

    nets = [gan.nets[k] for k in ("dcgan_disc", "p2p_disc")]
    if any(has_bn(d) or getattr(d, "dropout_p", 0.0) for d in nets):
        fail("parallel: a discriminator with BatchNorm or dropout has no "
             "row-by-row twin")
    per = n // world

    def split(forward):
        def call(*xs, **kw):
            rows = xs[0].shape[0]
            if rows % n:
                fail(f"parallel: a discriminator call on {rows} rows, not "
                     f"blocks of {n}")
            idx = [torch.tensor([b * n + r * per + i for b in range(rows // n)
                                 for i in range(per)], device=xs[0].device)
                   for r in range(world)]
            out = torch.cat([forward(*(x[i] for x in xs), **kw)
                             for i in idx])
            return out[torch.argsort(torch.cat(idx))]
        return call

    for d in nets:
        d.forward = split(d.forward)
    try:
        yield
    finally:
        for d in nets:
            del d.forward


def _faulty_step(torch, gan, fault, batch, rows):
    """A data-parallel step of gan on its rows of the global batch with one
    of PAR_FAULTS planted: (losses, {network: gradients})."""
    import torch.distributed as dist

    from terrain_tpu_torch.ops.norm import BatchNorm
    from terrain_tpu_torch.train import step as step_mod

    mine = tuple(t[rows] for t in batch)
    if fault == "half the batch twice":  # every rank takes rank 0's rows
        first = slice(0, rows.stop - rows.start)
        return _par_step(torch, gan, tuple(t[first] for t in batch))
    if fault == "gradients 1% large":
        return _par_step(torch, gan, mine, scale=1.01)
    if fault == "BN statistics local":
        bns = [m for net in gan.nets.values() for m in net.modules()
               if isinstance(m, BatchNorm)]
        for m in bns:
            m.process_group = None
        try:
            return _par_step(torch, gan, mine)
        finally:
            for m in bns:
                m.process_group = gan._group
    if fault == "gradients summed":  # and the losses: mean_over takes both
        mean = step_mod.mean_over
        step_mod.mean_over = lambda ts, g: [t * dist.get_world_size(g)
                                            for t in mean(ts, g)]
        try:
            return _par_step(torch, gan, mine)
        finally:
            step_mod.mean_over = mean
    fail(f"parallel: unknown fault {fault}")


def _errors(got, want):
    """{"loss <key>": relative error, "grad <network>": relative L2} of two
    (losses, {network: gradients})."""
    (lg, gg), (lw, gw) = got, want
    out = {f"loss {k}": abs(lg[k] - lw[k]) / max(abs(lw[k]), 1e-30)
           for k in lw}
    for n in gw:
        num = sum(float(((a.double() - b.double()) ** 2).sum())
                  for a, b in zip(gg[n], gw[n]))
        den = sum(float((b.double() ** 2).sum()) for b in gw[n])
        out[f"grad {n}"] = (num / max(den, 1e-300)) ** 0.5
    return out


def _limits(loss_tol, grad_tol):
    """The limit of each key of _errors: loss_tol for the losses, each
    network's own for its gradients."""
    from terrain_tpu_torch.train.losses import TRAIN_KEYS
    from terrain_tpu_torch.train.step import NET_NAMES

    return {**{f"loss {k}": loss_tol for k in TRAIN_KEYS},
            **{f"grad {n}": grad_tol[n] for n in NET_NAMES}}


def _twin_limits(twin):
    """The two ranks' limits from the twin's errors: PAR_TOL for the
    losses, PAR_TWIN x the twin's error (at least PAR_TOL) for each
    network's gradients."""
    return {k: PAR_TOL if k.startswith("loss")
            else max(PAR_TOL, PAR_TWIN * v) for k, v in twin.items()}


def _over(err, lim):
    return [f"{k} {err[k]:.3e} > {lim[k]:.3e}" for k in err
            if not err[k] <= lim[k]]


def _show(what, err, lim, twin=None):
    """Prints each error beside its limit (and its twin's, the same
    function with only the summation order changed); returns the ones
    over their limits."""
    print(f"{what} (relative): " + "; ".join(
        f"{k} {err[k]:.3e} (" + (f"twin {twin[k]:.3e}, " if twin else "")
        + f"limit {lim[k]:.3e})" for k in err), flush=True)
    return [f"{what}: {b}" for b in _over(err, lim)]


def _results_row(out_dir):
    with open(os.path.join(out_dir, "results.txt")) as f:
        header, row = [ln.split(",") for ln in f.read().splitlines()[:2]]
    return {k: float(v) for k, v in zip(header, row)
            if k.startswith(("train_", "valid_"))}


def _row_errors(row, want):
    return {k: abs(row[k] - v) / max(abs(v), 1e-30) for k, v in want.items()}


def parallel_world1(torch, card, root):
    """NCCL at world size 1 (the real backend; its collectives move
    nothing): the flagship step through TwoStageGAN(mesh=make_mesh()) in
    fp32 and bf16 on each seed of PAR_SEEDS, and in fp32 with the opt-in
    switches on and with the unfused decoder on the first, each against the
    same step without a mesh (losses and the gradients the update takes)
    and against itself from the same state (bit-equal); in fp32 the twin
    of the two-rank step, whose discriminators run as the two ranks do; by
    default, step ms (host clock around a synchronized step, median of 3,
    in turns: none, mesh, mesh, none), profiled device ms and the
    collectives a step.  Then the epochs the two ranks' are held to: over
    PAR_N pairs on the card, one process without a mesh and the twin.
    Returns (the launch counts of the mesh's steps, failures, the twin's
    errors {"<label>, seed <s>": errors}, the epoch rows {seed: {"one":
    row, "twin": row}})."""
    import datetime

    import torch.distributed as dist

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.parallel import initialize, make_mesh

    initialize(f"file://{root}/nccl", 1, 0, backend="nccl",
               timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    counts, bad, twins, rows = {}, [], {}, {}
    try:
        mesh = make_mesh()
        for label, cd, switches in (
                ("fp32", torch.float32, {}), ("bf16", torch.bfloat16, {}),
                ("fp32 switches on", torch.float32, SWITCHES),
                ("fp32 unfused decoder", torch.float32, UNFUSED)):
            set_switches(True, switches)
            gans = {m: build_gan(EXPERIMENT, "cuda", compute_dtype=cd,
                                 verbose=False, mesh=m)[0]
                    for m in (None, mesh)}
            dp = gans[mesh]
            back = {m: _snapshot(g) for m, g in gans.items()}
            lim = _limits(PAR_LOSS_TOL[label[:4]],
                          PAR_W1_GRAD_TOL[label[:4]])
            for seed in PAR_SEEDS[:1] if switches else PAR_SEEDS:
                batch = _train_batch(torch, TRAIN_BATCH, dp.in_shp,
                                     dp.latent_dim, seed)
                back[mesh]()
                _reset_counters()
                l1, g1 = _par_step(torch, dp, batch)
                torch.cuda.synchronize()
                for k, v in _read_counters().items():
                    counts[k] = counts.get(k, 0) + v
                back[mesh]()
                l2, g2 = _par_step(torch, dp, batch)
                back[None]()
                ref = _par_step(torch, gans[None], batch)
                same = l1 == l2 and all(a.equal(b) for n in g1
                                        for a, b in zip(g1[n], g2[n]))
                print(f"parallel [{card}] NCCL world 1, {label}, seed {seed}: "
                      f"the mesh's step twice from one state bit-equal: "
                      f"{same}", flush=True)
                if not same:
                    bad.append(f"world 1 {label} seed {seed}: the step "
                               f"differs from itself")
                twin = None
                if cd == torch.float32:
                    back[mesh]()
                    with _discriminators_as_ranks(torch, dp, PAR_WORLD,
                                                  TRAIN_BATCH):
                        twin = _errors(_par_step(torch, dp, batch), ref)
                    twins[f"{label}, seed {seed}"] = twin
                bad += _show(f"parallel [{card}] NCCL world 1, {label}, seed "
                             f"{seed}: mesh vs no mesh",
                             _errors((l1, g1), ref), lim, twin)
                del l1, g1, l2, g2, ref
            if not switches:
                _par_time(torch, card, label, gans, batch)
            del gans, dp, back, batch
            set_switches(False, switches)
            torch.cuda.empty_cache()
        for seed in PAR_SEEDS:
            ds = DeviceDataset(*make_pairs(PAR_N, 512, seed=seed),
                               device="cuda")
            rows[seed] = {}
            for name, m in (("one", None), ("twin", mesh)):
                gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=m)
                gan.sampler = _tiled_sampler(0, seed)
                out = os.path.join(root, f"{name}{seed}")
                with (_discriminators_as_ranks(torch, gan, PAR_WORLD,
                                               TRAIN_BATCH)
                      if m else contextlib.nullcontext()):
                    gan.train(ds, ds, TRAIN_BATCH, 1, out, save_every=10)
                rows[seed][name] = _results_row(out)
                del gan
            del ds
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts, bad, twins, rows


def _par_time(torch, card, label, gans, batch):
    """Step ms in turns and profiled device ms, without and with the
    world-1 mesh, and the collectives of one mesh step."""
    import torch.distributed as dist

    steps = {}
    for m, gan in gans.items():
        tr, _ = gan._build_steps(gan._host_prepare)
        steps["mesh" if m else "none"] = (
            lambda gan=gan, tr=tr: tr(gan.opt_states, batch,
                                      gan._next_rngs(), gan.lr))
    calls = {"all_reduce": 0, "broadcast": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    for k in calls:
        setattr(dist, k, counting(k))
    try:
        steps["mesh"]()
    finally:
        for k, f in real.items():
            setattr(dist, k, f)
    per = {"none": [], "mesh": []}
    for mode in ("none", "mesh", "mesh", "none"):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[mode]()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        per[mode].append(statistics.median(ms))
    dev = {}
    for mode, fn in steps.items():
        _, rows = profiled(torch, fn)
        dev[mode] = sum(r[0] for r in rows)
    print(f"parallel [{card}] NCCL world 1, {label}: step without a mesh "
          f"{per['none'][0]:.3f} / {per['none'][1]:.3f} ms, with "
          f"{per['mesh'][0]:.3f} / {per['mesh'][1]:.3f} ms (host clock, "
          f"synchronized, median of 3, in turns); profiled device time "
          f"{dev['none']:.3f} vs {dev['mesh']:.3f} ms; collectives of one "
          f"mesh step {calls}", flush=True)


def _par_rank(rank, world, root, env):
    """One gloo rank on the card, spawned by parallel_gloo, on its rows of
    each global batch of TRAIN_BATCH: the flagship step in fp32 on each
    seed of PAR_SEEDS, and with the switches on and with the unfused
    decoder on the first; on the first seed each planted fault of
    PAR_FAULTS; then an epoch of TwoStageGAN.train over PAR_N pairs held on
    the card for each seed.  Rank 0 also takes each step in one process on
    the whole batch and compares.  The launch counters are read around this
    rank's sound data-parallel runs alone (not the faults, not rank 0's
    one-process steps).  Writes root/rank<r>.json; raises on any
    failure."""
    import datetime

    sys.path.insert(0, HERE)
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.parallel import initialize, make_mesh

    strict_fp32()
    initialize(f"file://{root}/gloo", world, rank, backend="gloo",
               timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    out = {"counts": {}, "step_ms": [], "err": {}, "faults": {}, "rows": {},
           "epoch_s": []}

    def counted(fn):
        _reset_counters()
        r = fn()
        torch.cuda.synchronize()
        for k, v in _read_counters().items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        return r

    try:
        mesh = make_mesh()
        for label, switches in (("fp32", {}), ("fp32 switches on", SWITCHES),
                                ("fp32 unfused decoder", UNFUSED)):
            set_switches(True, switches)
            gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
            back = _snapshot(gan)
            if rank == 0:
                one, _ = build_gan(EXPERIMENT, "cuda", verbose=False)
                back_one = _snapshot(one)
            rows = gan._local(TRAIN_BATCH)
            for seed in PAR_SEEDS[:1] if switches else PAR_SEEDS:
                batch = _train_batch(torch, TRAIN_BATCH, gan.in_shp,
                                     gan.latent_dim, seed)
                back()
                t0 = time.perf_counter()
                got = counted(lambda: _par_step(
                    torch, gan, tuple(t[rows] for t in batch)))
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                if rank == 0:
                    back_one()
                    ref = _par_step(torch, one, batch)
                    out["err"][f"{label}, seed {seed}"] = _errors(got, ref)
                if switches or seed != PAR_SEEDS[0]:
                    continue
                for fault in PAR_FAULTS:
                    back()
                    faulty = _faulty_step(torch, gan, fault, batch, rows)
                    if rank == 0:
                        out["faults"][fault] = _errors(faulty, ref)
            del gan, back, batch, got
            if rank == 0:
                del one, back_one, ref
            set_switches(False, switches)
            torch.cuda.empty_cache()
        for seed in PAR_SEEDS:
            ds = DeviceDataset(*make_pairs(PAR_N, 512, seed=seed),
                               device="cuda")
            gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
            gan.sampler = _tiled_sampler(rank, seed)
            d = os.path.join(root, f"rank{rank}_{seed}")
            t0 = time.perf_counter()
            counted(lambda: gan.train(ds, ds, TRAIN_BATCH, 1, d,
                                      save_every=10))
            out["epoch_s"].append(time.perf_counter() - t0)
            out["rows"][seed] = _results_row(d)
            del gan, ds
            torch.cuda.empty_cache()
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def parallel_gloo(torch, card, root, twins, one_rows):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device; gloo stages CUDA tensors through the host, so its times are
    a correctness path's, not speed figures), spawned, fp32, global batch
    TRAIN_BATCH, each rank on its 2 rows: each step's losses and
    all-reduced gradients against one process's step on the card, to the
    limits the twin's errors on the same seed set (twins, from
    parallel_world1), each planted fault shown to fail that comparison,
    each epoch's loss row against one process's (one_rows, from
    parallel_world1, with the twin's), and every kernel of the train path
    launched on each rank.  Returns (each rank's launch counts,
    failures)."""
    torch.multiprocessing.spawn(_par_rank, args=(PAR_WORLD, root,
                                                 {"TERRAIN_ARTIFACT_EVERY":
                                                  "1000"}),
                                nprocs=PAR_WORLD, join=True)
    res = []
    for r in range(PAR_WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            res.append(json.load(f))
    bad = []
    print(f"parallel [{card}] {PAR_WORLD} gloo ranks on one card, fp32, "
          f"global batch {TRAIN_BATCH}: steps (ms, each rank's in order) "
          + "; ".join(" ".join(f"{t:.1f}" for t in r["step_ms"]) for r in res)
          + " (a correctness path: gloo stages through the host); epochs of "
          f"{PAR_N // TRAIN_BATCH} train + {PAR_N // TRAIN_BATCH} eval steps "
          f"over {PAR_N} pairs on the card, rank 0: "
          + ", ".join(f"{t:.1f}" for t in res[0]["epoch_s"]) + " s",
          flush=True)
    for what, err in res[0]["err"].items():
        bad += _show(f"parallel [{card}] {PAR_WORLD} gloo ranks, {what}: "
                     f"one step vs one process, the gradients all-reduced",
                     err, _twin_limits(twins[what]), twins[what])
    lim = _twin_limits(twins[f"fp32, seed {PAR_SEEDS[0]}"])
    for fault, err in res[0]["faults"].items():
        _show(f"parallel [{card}] {PAR_WORLD} gloo ranks, the planted fault "
              f"'{fault}'", err, lim)
        caught = _over(err, lim)
        print(f"parallel [{card}] the planted fault '{fault}' fails the "
              f"comparison on {caught}", flush=True)
        if not caught:
            bad.append(f"the planted fault '{fault}' passes the two-rank "
                       f"comparison")
    # the epoch: each column's limit from the twin's largest error in it
    # over the seeds (one realization a seed of how far two updates carry
    # a change of summation order)
    twin_rows = [_row_errors(w["twin"], w["one"]) for w in one_rows.values()]
    elim = {k: max(PAR_TOL, PAR_TWIN * max(t[k] for t in twin_rows))
            for k in twin_rows[0]}
    for seed, want in one_rows.items():
        mine = [r["rows"][str(seed)] for r in res]
        if any(m != mine[0] for m in mine):
            bad.append(f"seed {seed}: the ranks recorded other loss rows: "
                       f"{mine}")
        bad += _show(f"parallel [{card}] {PAR_WORLD} gloo ranks, seed "
                     f"{seed}: the epoch's loss row vs one process's",
                     _row_errors(mine[0], want["one"]), elim,
                     _row_errors(want["twin"], want["one"]))
    counts = [r["counts"] for r in res]
    for r, c in enumerate(counts):
        print(f"parallel: rank {r}'s launches at its {TRAIN_BATCH // PAR_WORLD}"
              f" rows {c}", flush=True)
        missing = [k for k in _counters() if not c.get(k)]
        if missing:
            bad.append(f"rank {r} launched no {missing} at the local batch")
    return counts, bad


def parallel_slice(torch, card):
    """Data parallelism over torch.distributed: NCCL at world 1, then two
    gloo ranks sharing the card.  Every reading is printed before any
    failure ends the run.  Returns the launch counts of the world-1
    mesh's steps and of the two ranks, added."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="parallel_")
    saved = os.environ.get("TERRAIN_ARTIFACT_EVERY")
    os.environ["TERRAIN_ARTIFACT_EVERY"] = "1000"
    try:
        world1, bad, twins, rows = parallel_world1(torch, card, root)
        torch.cuda.empty_cache()
        ranks, more = parallel_gloo(torch, card, root, twins, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved is None:
            os.environ.pop("TERRAIN_ARTIFACT_EVERY", None)
        else:
            os.environ["TERRAIN_ARTIFACT_EVERY"] = saved
    bad += more
    if bad:
        fail(f"parallel: {bad}")
    gloo = {}
    for c in ranks:
        for k, v in c.items():
            gloo[k] = gloo.get(k, 0) + v
    print(f"parallel: launches of the world-1 mesh's steps {world1}; of the "
          f"two ranks {gloo}", flush=True)
    return world1, gloo


# ------------------------------------------------- determinism (on request)
# `python3 chip_smoke.py determinism`: not part of the default run.  From
# one saved state (the flagship's four networks at full width, their BN
# statistics and rmsprop states, the step's generator seeds) and one batch
# of DET_BATCH synthetic pairs on the card, fp32, twice in each setting:
# one forward and backward, whose gradients are compared network by
# network, and DET_STEPS train steps, whose parameters are compared.
# setting -> (F.interpolate's own backward for the U-Net's bilinear stages
# outside bilinear_conv's regime, cudnn.deterministic,
# use_deterministic_algorithms (warn_only; its warnings are printed))
DET_SETTINGS = {"before": (True, False, False),
                "cudnn_deterministic": (True, True, False),
                "adjoint": (False, False, False),
                "repaired": (False, True, False),
                "deterministic_algorithms": (True, False, True)}
DET_BATCH, DET_PAIRS, DET_STEPS, DET_REPS = 4, 8, 4, 10


class _InterpolateBackward:
    """The op ops/resize.Bilinear2xLib replaced: F.interpolate under
    autograd, whose CUDA backward accumulates with atomics."""

    @staticmethod
    def apply(x):
        import torch.nn.functional as F

        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear", align_corners=False)
        return up.permute(0, 2, 3, 1)


def _det_set(torch, setting, adjoint):
    from terrain_tpu_torch.ops import resize

    lib, cudnn_det, algos = DET_SETTINGS[setting]
    resize.Bilinear2xLib = _InterpolateBackward if lib else adjoint
    torch.backends.cudnn.deterministic = cudnn_det
    torch.use_deterministic_algorithms(algos, warn_only=True)


class _DetRun:
    """The flagship's trainer, its step and DET_STEPS batches on the card,
    its state saved so that every run starts from it."""

    def __init__(self, torch, np, cd):
        from terrain_tpu_torch.data import DeviceDataset
        from terrain_tpu_torch.data.synthetic import make_pairs
        from terrain_tpu_torch.experiments import build_gan

        self.gan, _ = build_gan(EXPERIMENT, "cuda", compute_dtype=cd,
                                verbose=False)
        ds = DeviceDataset(*make_pairs(DET_PAIRS, self.gan.in_shp, seed=0),
                           device="cuda")
        self.prepare = ds.make_prepare(augment=True)
        self.step, _ = self.gan._build_steps(self.prepare)
        rnd = np.random.RandomState(5)
        z = torch.from_numpy(rnd.rand(DET_STEPS, DET_BATCH,
                                      self.gan.latent_dim)
                             .astype(np.float32)).cuda()
        idx = torch.from_numpy(rnd.randint(0, DET_PAIRS,
                                           (DET_STEPS, DET_BATCH))
                               .astype(np.int32)).cuda()
        self.batches = [ds.batch_args(z[t], idx[t]) for t in range(DET_STEPS)]
        self.restore = _snapshot(self.gan)

    def grads(self):
        from terrain_tpu_torch.train.step import losses_and_grads

        self.restore()
        rngs = self.gan._next_rngs()
        z, x, y = self.prepare(self.batches[0], rngs)
        _, grads = losses_and_grads(self.gan.nets, z, x, y, rngs,
                                    **self.gan._step_kw)
        return {n: [g.clone() for g in gs] for n, gs in grads.items()}

    def steps(self):
        self.restore()
        for b in self.batches:
            self.step(self.gan.opt_states, b, self.gan._next_rngs(),
                      self.gan.lr)
        return {n: [p.detach().clone() for p in net.parameters()]
                for n, net in self.gan.nets.items()}

    def one(self):
        self.step(self.gan.opt_states, self.batches[0], self.gan._next_rngs(),
                  self.gan.lr)


def _det_compare(a, b):
    """{net: [tensors that differ, of tensors, max abs difference]}."""
    out = {}
    for n in a:
        diff = [float((x - y).abs().max()) for x, y in zip(a[n], b[n])
                if not x.equal(y)]
        out[n] = [len(diff), len(a[n]), max(diff, default=0.0)]
    return out


def _det_step_ms(torch, run):
    """(CUDA events around a step, median of DET_REPS after 2 warm-up
    steps, the host's cost included; profiled device ms of one step;
    {kernel: device ms})."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run.one()
    times = []
    for _ in range(DET_REPS):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run.one()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run.one()
        torch.cuda.synchronize()
    kernels = {ev.key: getattr(ev, "self_device_time_total", 0) / 1e3
               for ev in prof.key_averages()
               if str(getattr(ev, "device_type", "")).endswith("CUDA")}
    return statistics.median(times), sum(kernels.values()), kernels


def _conv_calls(torch, run):
    """{key: (x shape, w shape, layouts, fn(x, w))} of every distinct
    F.conv2d and F.conv_transpose2d call of DET_STEPS fp32 train steps of
    `run` (bias left out: it moves neither dX nor dW), and the stem's conv
    as check_autograd runs it through its plain version."""
    import torch.nn.functional as F

    calls = {}
    real = {"conv2d": F.conv2d, "conv_transpose2d": F.conv_transpose2d}

    def layout(t):
        return ("channels_last" if t.dim() == 4 and not t.is_contiguous()
                and t.is_contiguous(memory_format=torch.channels_last)
                else "contiguous")

    def recording(kind):
        def call(x, w, bias=None, *args, **kwargs):
            key = (f"{kind} x{tuple(x.shape)} {layout(x)} w{tuple(w.shape)}"
                   f" {layout(w)} {args} {kwargs}")
            calls.setdefault(key, (tuple(x.shape), tuple(w.shape),
                                   (layout(x), layout(w)),
                                   lambda a, b: real[kind](a, b, None, *args,
                                                           **kwargs)))
            return real[kind](x, w, bias, *args, **kwargs)
        return call

    for kind in real:
        setattr(F, kind, recording(kind))
    try:
        run.steps()
    finally:
        for kind, fn in real.items():
            setattr(F, kind, fn)
    calls["conv2d stem x(2, 1, 256, 256) w(64, 1, 5, 5) pad 2"] = (
        (2, 1, 256, 256), (64, 1, 5, 5), ("contiguous", "contiguous"),
        lambda a, b: F.conv2d(a, b, padding=2))
    return calls


def _accuracy(torch, calls):
    """{key: {setting: [dX error, dW error]}}, each the largest error
    against the CPU's fp64 gradients over their largest entry, on seeded
    normal inputs; settings "default" and "deterministic" (fp32, cuDNN's
    default and deterministic algorithms) and "fp64" (cuDNN in fp64)."""
    gen = torch.Generator().manual_seed(0)
    fmts = {"channels_last": torch.channels_last,
            "contiguous": torch.contiguous_format}
    out = {}
    for key, (xs, ws, layouts, fn) in calls.items():
        fan_in = (ws[1] if "transpose" not in key else ws[0]) * ws[2] * ws[3]
        x, w = (torch.randn(shape, generator=gen, dtype=torch.float64)
                .contiguous(memory_format=fmts[f])
                for shape, f in zip((xs, ws), layouts))
        w = w * fan_in ** -0.5
        cot = torch.randn(fn(x, w).shape, generator=gen, dtype=torch.float64)

        def grads(dtype, dev):
            xd = x.to(dev, dtype).requires_grad_()  # keeps the layout
            wd = w.to(dev, dtype).requires_grad_()
            return torch.autograd.grad(fn(xd, wd), (xd, wd),
                                       cot.to(dev, dtype))

        ref = grads(torch.float64, "cpu")
        out[key] = {}
        for label, dtype, det in (("default", torch.float32, False),
                                  ("deterministic", torch.float32, True),
                                  ("fp64", torch.float64, False)):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=det,
                                            allow_tf32=False):
                got = grads(dtype, "cuda")
            out[key][label] = [
                float((a.cpu().double() - r).abs().max() / r.abs().max())
                for a, r in zip(got, ref)]
    return out


def determinism(torch, card):
    """Run-to-run determinism of the fp32 flagship step in each of
    DET_SETTINGS, what the repairs cost (fp32 and bf16, two rounds of
    opposite order, and the kernels whose device time moved most), and the
    accuracy of cuDNN's fp32 gradients of every library conv of the step
    against fp64.  Leaves the port's own setting (`repaired`)."""
    import warnings

    import numpy as np

    from terrain_tpu_torch.ops import resize

    adjoint = resize.Bilinear2xLib
    try:
        run = _DetRun(torch, np, torch.float32)
        for setting in DET_SETTINGS:
            _det_set(torch, setting, adjoint)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                g = _det_compare(run.grads(), run.grads())
                p = _det_compare(run.steps(), run.steps())
            print(f"determinism {setting} fp32: gradients of one step, twice "
                  f"(differing, of, max abs) {g}; parameters after "
                  f"{DET_STEPS} steps, twice {p}", flush=True)
            if DET_SETTINGS[setting][2]:
                print(f"determinism {setting}: warnings "
                      f"{sorted({str(w.message)[:240] for w in caught})}",
                      flush=True)
        _det_set(torch, "repaired", adjoint)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run.grads()
        print(f"determinism repaired under deterministic algorithms: "
              f"warnings {sorted({str(w.message)[:240] for w in caught})}",
              flush=True)
        _det_set(torch, "repaired", adjoint)
        calls = _conv_calls(torch, run)
        del run
        torch.cuda.empty_cache()
        order = ["before", "repaired", "cudnn_deterministic", "adjoint"]
        for label, cd in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            run, kernels = _DetRun(torch, np, cd), {}
            for rnd, settings in enumerate((order, order[::-1])):
                for setting in settings:
                    _det_set(torch, setting, adjoint)
                    run.restore()
                    ms, dev, kernels[setting, rnd] = _det_step_ms(torch, run)
                    print(f"determinism time [{card}] {label} {setting} round "
                          f"{rnd}: step {ms:.3f} ms (CUDA events, median of "
                          f"{DET_REPS}), profiled device time {dev:.3f} ms",
                          flush=True)
            a, b = kernels["before", 0], kernels["repaired", 0]
            for d, k in sorted(((b.get(k, 0.0) - a.get(k, 0.0), k)
                                for k in set(a) | set(b)), reverse=True)[:10]:
                print(f"  {label} repaired - before {d:+9.3f} ms (before "
                      f"{a.get(k, 0.0):.3f}, repaired {b.get(k, 0.0):.3f}) "
                      f"{k[:110]}", flush=True)
            del run
            torch.cuda.empty_cache()
    finally:
        _det_set(torch, "repaired", adjoint)
    acc = _accuracy(torch, calls)
    for key, v in sorted(acc.items(),
                         key=lambda kv: -max(kv[1]["deterministic"])):
        print(f"determinism accuracy [{card}] {key}: dX, dW relative to the "
              f"CPU's fp64: cuDNN fp32 default {v['default'][0]:.2e}, "
              f"{v['default'][1]:.2e}; deterministic "
              f"{v['deterministic'][0]:.2e}, {v['deterministic'][1]:.2e}; "
              f"cuDNN fp64 {v['fp64'][0]:.2e}, {v['fp64'][1]:.2e}",
              flush=True)


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

    def want(phase):  # "conditioning", "determinism" only when asked for
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
        entry = ""  # the (mangled) kernel the next lines are about
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry[:72]}: {line.strip()}")

    rows, serve_launches, train_launches, trainer_launches = {}, {}, {}, {}
    quality_launches, trainer_epoch_s, step_ms = {}, float("nan"), {}
    raster_launches, scan_launches, parallel_launches = {}, {}, {}
    world1_launches = {}
    if want("kernels"):
        # the plain versions and the library calls on cuDNN's default
        # algorithms, as they were measured before the port's step turned
        # to its deterministic ones (strict_fp32): the library's own best
        # is the yardstick, and for the stem's one-channel 5x5 conv the
        # deterministic dW is 5.3e-3 off fp64 (relative to the largest
        # entry), the default 7.6e-7 (the `determinism` phase's accuracy
        # part, on an NVIDIA H100 80GB HBM3 at 700 W)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
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
    if "determinism" in only:
        determinism(torch, card)
    if want("train"):
        train_launches, step_ms = train_slice(torch, card)
        train_agreement(torch)
        print(f"phase train done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("trainer"):
        trainer_launches, trainer_epoch_s = trainer_slice(torch, card)
        print(f"phase trainer done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("quality"):
        quality_launches = quality_slice(
            torch, card, trainer_epoch_s,
            step_ms.get("fp32 switches off unfused decoder", float("nan")))
        print(f"phase quality done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("raster"):
        raster_launches = raster_slice(torch, card)
        print(f"phase raster done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("scan"):
        scan_launches = scan_slice(torch, card)
        print(f"phase scan done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("parallel"):
        world1_launches, parallel_launches = parallel_slice(torch, card)
        print(f"phase parallel done at {time.perf_counter() - t_start:.0f} "
              f"s", flush=True)
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
        "conv_s2_fwd": ("conv_s2.cu", "conv_s2.py:176"),
        "conv_s2_dw": ("conv_s2.cu", "conv_s2.py:217"),
        "pool2_fwd": ("pool2.cu", "pool2.py:106"),
        "pool2_bwd": ("pool2.cu", "pool2.py:125"),
        "bilinear": ("bilinear.cu", "bilinear.py:99"),
    }
    # the paths each kernel lies on: it must have run on every one of them
    # (bilinear only with the unfused decoder: the train phase's UNFUSED
    # step and the quality phase; the opt-in pool2 and conv_s2 in the train
    # and trainer phases; bilinear_conv not in the quality phase, whose
    # decoder is unfused)
    paths = {name: ["train", "trainer", "quality"] for name in meta}
    paths["bilinear"] = ["train", "quality"]
    for name in ("pool2_fwd", "pool2_bwd", "conv_s2_fwd", "conv_s2_dw",
                 "bilinear_conv"):
        paths[name].remove("quality")
    for name in serve_launches:
        paths[name].append("serve")
    # the raster epoch and the TERRAIN_SCAN epoch run the default path;
    # the parallel phase's steps every kernel of the train path (the
    # opt-in ones with the switches on, bilinear with the unfused decoder):
    # "parallel" the two gloo ranks at their local batch of 2 (each rank
    # checked on its own in the phase), "parallel_world1" the world-1
    # NCCL mesh at batch 4
    for name in TRAIN_LAUNCHES:
        if name in paths:
            paths[name] += ["raster", "scan"]
    for name in meta:
        paths[name] += ["parallel", "parallel_world1"]
    launches = {"serve": serve_launches, "train": train_launches,
                "trainer": trainer_launches, "quality": quality_launches,
                "raster": raster_launches, "scan": scan_launches,
                "parallel": parallel_launches,
                "parallel_world1": world1_launches}
    kernels = []
    for name, (src, rep) in meta.items():
        main_row = rows[name][0]  # main path shape, fp32
        per = {p: launches[p].get(name, 0) for p in launches}
        if any(per[p] == 0 for p in paths[name]):
            fail(f"{name} was not launched on its main paths: {per}")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": pallas + rep,
            "launches": sum(per.values()),
            **{f"launches_{p}": n for p, n in per.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               if r["dtype"] == "float32"),
            "ms": main_row["ms"], "stream_ms": main_row["stream_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_same_ms": main_row.get("library_same_ms")})
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

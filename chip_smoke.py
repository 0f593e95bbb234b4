#!/usr/bin/env python3
"""Drive terrain_tpu_torch's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py kernels quality   # some phases only, no result lines

Phases (any failure exits non-zero and prints no result line):
  1. card: its name and power limit (nvidia-smi), torch/CUDA versions, and
     the nvcc build of every kernel from csrc/ (timed, one nvcc per source,
     all started together);
  1a. coldstart: a fresh process to the end of one bf16 eager flagship
     step with the libraries already built (and a cold machine's figure:
     that plus phase 1's nvcc build and the six host g++ builds); a fresh
     TERRAIN_AOT store filled (phase 1's libraries and the host ones just
     built, with their records, copied in, then utils/aot.fill checking
     them); a fresh process with no
     compiler reachable (PATH an empty directory, CUDA_HOME and CUDA_PATH
     unset) taking the same step from the store, its launch counts the
     default path's; then, in that process, a copy of the store whose
     bilinear record names compute capability 8.0 (its library
     overwritten with bytes that cannot load): the build raises naming
     the entry; with nvcc (this process) it is rebuilt;
  1b. ballast: one fp32 step of the flagship (512px, batch 4, full
     width) from one seeded state in two fresh processes, one holding the
     card whole, one after a ballast allocation that leaves free 256 MiB
     less than the free run's peak reserved: every parameter, BN
     statistic, optimizer slot and loss bit-equal, and the device kernels
     of each profiled step compared by name (with cuDNN's FFT engines,
     which device.strict_fp32 blocks, the two runs differed: PERF.md §2);
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
     TERRAIN_BC_BWD=dense and =xla32, and in fp32 and bf16 with
     TERRAIN_POOL_VJP=lanes and =dense (pool2 launched 0 times): a
     warm-up step, then timed steps with
     the launch counters set to 0 just before and read just after (per
     step: conv_stem fwd 2, dW 1, dX 1; conv_thin fwd, dX, dW 1 each;
     bilinear_conv 2 and its backward 2; with the switches on pool2 fwd 12
     and bwd 12, conv_s2 fwd 3 and dW 2, with them off 0; with the unfused
     decoder bilinear 1 and its backward 1, bilinear_conv 0), finite losses,
     every parameter of all four networks changed, step time, images/s,
     peak memory, and a profiled step by kernel; the eager bf16 step with
     CudaKernel.launch as it is and with the parent's (before its profiler
     labels) in turns; then one step of the 256px
     configuration, switches on, on the card (kernels) and on the CPU
     (plain versions) from the same weights and batch: losses, gradients
     and updated weights; and the 2x2 pool alone at (8,512²,64), forward
     plus backward, under sas, pallas, lanes and dense, fp32 and bf16,
     beside the pool2 kernels' bound;
  5. trainer: `python -m terrain_tpu_torch test1_nobn_bilin_both train`
     through cli.main at full width on 40 synthetic pairs held on the card
     as uint8, gathered, normalized and augmented inside the step, both
     switches on: one epoch with a checkpoint, then the same command
     resuming it for a second epoch; results.txt (header, two rows of
     finite losses), the dumps, the four arch_<net>.txt equal to
     models/core.describe's text (arch_<net>.png where matplotlib
     imports, which is printed), both checkpoints (every parameter moved),
     the launch counts of an epoch, epoch time, images/s, the data path's
     share of a step, peak memory; then smoke_synthetic train + gen;
  6. quality: the same command with the unfused decoder, TERRAIN_SWD=1 and
     TERRAIN_PROFILE on host iterators behind the prefetcher (40 synthetic
     pairs, three epochs -- a warm-up, a traced and a clean one -- with a
     checkpoint each), then `gen`: swd.txt with
     terrain_tpu's columns and finite values, gen's checkpoint picked from
     it, the trace file and its cost (the traced epoch's time less the clean
     one's) summarized by tools/summarize_trace (its family table and top
     ops by roofline headroom; the family rows summing to the busy time,
     each hand-written kernel's events equal to its launches over the
     epoch and to its terrain:: labels, none in a library family, the
     cuDNN, GEMM and hand-written families 99% bounded, the summarizer
     within 20 s), the launch counts, epoch and SWD times, the SWD evaluation's
     peak memory, and the SWD
     pyramid and terrain W1 of the same images on the card against the CPU;
  7. raster: a synthetic raster pair at the NASA rasters' size (21600 x
     10800; a heightmap ~30% ocean, an RGB texture) written as PNGs whose
     rows cycle through the five filter types, decoded by the port's codec
     (seconds and MB/s; the pair must come back byte-equal, in under 60 s),
     the crop iterator's first batch against plain slicing of the decoded
     pair, its crops/s and rejection share, then one epoch of
     `TERRAIN_RASTER=hm.png,tex.png TERRAIN_EPOCH_CROPS=48 python -m
     terrain_tpu_torch test1_nobn_bilin_both train` at 512px: finite
     losses, the flagship kernels' launch counts, epoch time and the share
     of a step of the host batch and of the augmentation.  Then JPEG: each
     committed fixture of tests/data/jpeg decoded by the port's decoder to
     the SHA-256 of imageio's bytes committed beside it (MB/s printed), the
     full-width strip's restart intervals repeated into a 21600 x 10800
     texture (its decode timed, every band that no vertical upsampling
     crosses equal to the strip's), and one epoch of
     `TERRAIN_RASTER=hm.png,texture_2048x1024_420.jpg` (the heightmap a
     PNG made here at the texture's size) with the first batch against
     plain slicing and the default path's kernels counted.  Then the
     progressive fixtures (among the committed ones above, two of them cut
     after their second and third scan, which libjpeg-turbo smooths) and
     the progressive strip's scans, their restart intervals repeated,
     as a 21600 x 10800 texture: its decode timed, its peak host memory
     read in the phase's decode process (one process for the phase's
     memory runs, each file's peak above the resident set before it), its
     bands held to the strip's, and the first batch of it and the PNG
     heightmap above against plain slicing.  Then every committed PNG,
     TIFF, BMP, WebP, PNM, TGA, JPEG 2000, PFM/PAM, Radiance, Sun raster,
     DDS, SGI, PCX, QOI, IM, ICO, ICNS and MPO fixture to imageio's
     digests (or the exception imageio raises), from its bytes and its path,
     and the TIFF strips as a 21600 x 10800 pair, decoded and trained from.  Then
     the committed 1024 x 640 WebP pair (lossless heights, q90 texture):
     each decoded (best of 3: s and MP/s), the first batch against plain
     slicing, and one epoch of `TERRAIN_RASTER=hm.webp,tex.webp
     TERRAIN_EPOCH_CROPS=16` with finite losses and the kernels counted.
     Then JPEG 2000 (every committed JP2/J2K fixture among the ones above):
     the two committed 1024 x 1024 tiles (16-bit lossless heights, 5/3
     with five levels; an RGB 9/7 texture with the ICT and three layers)
     each repeated into a 20480 x 10240 codestream and, in the decode
     process, decoded (JP2_RUNS times, the best: s and MP/s) with its peak host
     memory sampled, every tile equal to the lone tile's decode; and one
     epoch of
     `TERRAIN_RASTER=<heights>.jp2,<texture>.jp2 TERRAIN_EPOCH_CROPS=16`
     from the two tiles, with the first batch against plain slicing,
     finite losses and the kernels counted.  Then PFM, PAM, Radiance, Sun
     raster and DDS (every committed fixture among the ones above, by the
     plugin imageio takes: OpenCV for a *.pfm/*.hdr/*.sr path and PF/P7/
     Radiance bytes): a 21600 x 10800 Pf heights file of seeded k / 2 m,
     and the two committed 1024 x 1024 DDS tiles (DXT1, BC7) with their
     block rows repeated to 21600 x 10800, each decoded three times in the
     decode process (the best: s and MP/s; peak host memory), the heights
     equal to plain numpy's rounding, every texture cell the lone tile's
     decode; and one epoch of `TERRAIN_RASTER=<heights>.pfm,<texture>.dds
     TERRAIN_EPOCH_CROPS=16` (1024 x 1024 heights, the DXT1 tile) with the
     first batch against plain slicing, finite losses and the kernels
     counted.  Then SGI, PCX, QOI, IM, ICO, ICNS and MPO (every committed
     fixture among the ones above, through Pillow's rules): a 21600 x
     10800 run-length SGI heights file and a QOI texture of QOI_OP_RGB and
     QOI_OP_RUN ops, made here from seeded arrays, each decoded once in
     the decode process (s, MP/s, peak host memory) and held to its
     array; and one epoch of `TERRAIN_RASTER=<heights>.sgi,<texture>.qoi
     TERRAIN_EPOCH_CROPS=8` from 2048 x 1024 versions, with the first
     batch against plain slicing, finite losses and the kernels counted;
  7b. inputs: in a child process where h5py, imageio and PIL cannot be
     imported (the card's machine has none): the committed h5py files of
     tests/data/h5 read by data/h5.py to their digests (every layout-4
     index, unfiltered edge chunks among them) and the gzip file's read
     rate; 48 + 4
     synthetic pairs at 512px streamed into an h5 by the port's writer and
     read back equal; one epoch of `TERRAIN_DATA=<that h5>
     test1_nobn_bilin_both train` with TERRAIN_FAST=1 (the same launches
     and the same loss bits as the same epoch from TERRAIN_SYNTHETIC=1,
     which runs first, after a synthetic warm-up epoch of 8 pairs at the
     same shapes, so that every timed epoch is warm; each after np.random.seed(0), the priors'
     stream)
     and one through the host iterator (its first batch plain slicing,
     the same launches); one epoch of `TERRAIN_DATA=<512px pairs whose
     last rows lie in unfiltered partial edge chunks>` (the committed
     tests/data/h5/edge_unfiltered_pairs_512.h5: its first batch plain
     slicing, finite losses, the kernels counted); then the four port tools on small
     inputs, each timed: make_synthetic (its pairs), build_dataset from a
     PNG heightmap and the progressive texture (its arrays the plain
     crops, filter and RandomState(42) split; a --subset-from of the 10
     closest crops), pick_epoch (its pick, exit code 1 without swd.txt)
     and compare_published on the card (its rows the CPU's);
  7c. artifacts: in a child process where h5py, imageio and PIL cannot be
     imported: the committed GIF clips of tests/data/gif written by the
     port's GIF writer (serve/gif.py) and read back by its reader to
     imageio's frame counts, durations and loop, the gray and 60-colour
     clips' frames to imageio's SHA-256, every full-colour frame within
     1.10 times Pillow's mean error plus 0.25 grey levels; a full-width
     checkpoint of test1_nobn_bilin_both (seeded weights), then `python
     -m terrain_tpu_torch test1_nobn_bilin_both interp` through cli.main:
     224 frames of 512 x 1024 (56 dispatches of 4), frames/s, the
     launches of bilinear_conv (2) and conv_thin (1) a dispatch; `gen`
     (100 samples); then the port's four artifact tools, each timed:
     make_filmstrip and make_gen_sheet (their PNGs the plain numpy
     composition of their tiles), render_clip to a GIF (read back: one
     frame for each run of equal frames with 40 ms for each frame of the
     run, loop 0, each frame's mean error against its source within
     CLIP_MAE_LIMIT; a gray clip of the heightmaps bit-equal; an .mp4
     refused naming ffmpeg) and pack_artifacts on a trainer-shaped
     directory (the CSVs' last rows per epoch, torn rows dropped; copies
     byte-equal; dump_a's sheet the plain composition);
  8. scan: TERRAIN_SCAN as one CUDA graph: the flagship step (augmentation
     on) from one saved state, 4 eager steps twice against two replays of
     a 4-step graph, by default (no deterministic algorithms: the port's
     fp32 step repeats itself), in fp32 and bf16, switches off and on, and
     in fp32 at half the lr (captured anew) and with adam (its step count
     advanced on the device): losses, every parameter, the BN statistics
     and the optimizer state bit-equal, and the hand-written kernels of a
     profiled replay at 4x their per-step counts; bf16 per step at
     TERRAIN_SCAN=16, by default, eager and graph in turns, and one such
     replay traced and summarized (every hand-written kernel in its family,
     16x one bare step's launches) (fp32 and the
     profiled device time: the parallel phase); then the trainer on 40
     pairs on the card, two epochs
     at TERRAIN_SCAN=16 (fp32 through the CLI) and one eager from the same
     seed, fp32 and bf16: epoch times, and epoch 1's results.txt loss
     columns equal to eager's;
  8b. nans: TERRAIN_CHECK_NANS=2 on the flagship trainer's steps (fp32,
     augmentation on), by default and with the switches on and the decoder
     unfused: two checked eager steps bit-equal to two unchecked ones, and
     by default a TERRAIN_SCAN=4 graph, checked and unchecked, bit-equal to
     eager steps; a NaN-poisoned weight of p2p_gen's first encoder conv
     raising eagerly and in the graph, naming p2p_gen, enc.0.conv and
     step 1, a NaN in step 3's prior raising naming step 3; bf16 at
     TERRAIN_SCAN=8, the graph checked and unchecked, per step; every
     hand-written kernel's outputs checked at least once (the parallel
     phase plants the poisoned weight on the world-1 NCCL mesh's graph
     too: it raises after the replay, no rank hangs);
  9. parallel: data parallelism over torch.distributed, fp32 and bf16, at
     global batch 4.  NCCL at world size 1 (one H100 holds no second NCCL
     rank): TwoStageGAN(mesh=make_mesh()) on PAR_SEEDS against the step
     without a mesh (losses and the gradients the update takes, each
     network's to its own limit) and bit-equal to itself, with the
     switches on and the unfused decoder on one, and its step ms, device
     ms and collectives a step; in one process, the two-rank step's twin
     (only its summation orders changed) and epochs over 8 pairs without a
     mesh and as the twin.  Then TERRAIN_SCAN on that mesh, the trainer's
     chunks as CUDA graphs with the NCCL collectives inside: fp32 chunks
     of 8 steps bit-equal to 8 eager steps on PAR_SEEDS, the eval
     chunk, an lr change and a load_model each capturing anew once (the
     launch calls show one warm-up step and one capture; a replay calls
     none), chunks of 4 with the switches on and with the unfused decoder
     whose profiled replays run every kernel 4x its per-step count; bf16
     per step, the mesh's eager steps, its graph and the graph without a
     mesh in turns, with device ms and peak MiB (each graph within 1.25x
     its device time).  Then two spawned gloo ranks sharing the card,
     2 rows each: the same steps against one process's, four planted
     faults (BN statistics local, gradients summed, gradients 1% large,
     half the batch twice) each shown to fail that comparison, three
     epochs whose loss rows must match one process's, an epoch at
     TERRAIN_SCAN=4 equal to the k = 1 epoch (a loop over gloo), and
     every kernel of the train path launched on each rank at its local
     batch;
 10. accuracy: every distinct library conv of one fp32 step against fp64
     gradients (relative to the largest entry; the card's fp64 on cuDNN's
     deterministic algorithms, held to the CPU's on the six smallest
     calls): the DCGAN
     discriminator's 5x5 convs with cin >= 64, whose dW is
     ops/conv.Conv5x5's, within 1e-4 and the same bits twice, every other
     conv within 5e-5; the route's dW timed beside cuDNN's (default and
     deterministic algorithms) at the three shapes where cuDNN's fp32 dW
     is its Winograd, and the fp32 step's device time;
 11. tp: tensor parallelism on a 1 x 2 mesh of two gloo ranks sharing the
     card, the flagship at full width (tp_min_features 256: 3 / 3 / 13 /
     2 layers sharded), fp32, batch 4: each seed's step (losses, the
     gradients and the update, the sharded ones gathered) against one
     process to twice the error of a one-process twin that calls each
     wide layer on its weight's slices, three planted faults (dX partial
     sums not reduced, slices at the wrong offset, the bias added on every
     shard before the gather) each shown to fail that, a checkpoint that
     holds the mesh's parameters whole and loads back sharded, and every
     kernel launched on each rank (a step with the opt-in switches on and
     one with the unfused decoder).
 12. spatial: spatial parallelism, the four-network step of
     test1_nobn_bilin_both at full width (512px, batch 4, fp32) through
     experiments.build_train(..., mesh=) on a 1 x 2 mesh of two gloo
     ranks sharing the card, each image's rows in slabs over 'model' down
     to 8-row slabs in all four networks: each seed's step, and one with
     both opt-in switches and one with the unfused decoder (losses, every
     network's gradients), against one process to twice the error of a
     one-process twin that runs each slab layer on each slab and adds the
     slabs' partial sums in the ranks' order, the twin itself held to
     fixed limits; ten planted faults (halo rows zeroed, a halo shifted
     by one row, BatchNorm over the data group only, a slab dW not summed
     over 'model', a whole-row dW summed over it, a 5x5 halo one row
     short, the DCGAN discriminator's slab dW not summed, conv_thin's
     halo rows zeroed, the stride-2 crop and the stem's crop one row off,
     the last two also in the twin) each shown to fail; one seed of
     test1_nobn_finetunep2p_bilin's pix2pix step compared alike; one
     seed of the flagship with the DCGAN generator's bilinear_upsample
     (h 5: each stage's bilinear x2 and 5x5 conv on a slab with two
     low-resolution halo rows a side; experiments.build_train's
     dcgan_bilinear) compared alike, with two planted faults (the
     upsample's halo row next to the slab zeroed, the halo one row short)
     each shown to fail; each
     rank's launches of all twelve kernels (pool2 and conv_s2 with the
     switches, bilinear with the unfused decoder) as often as in one
     process under the same switches, and a bf16 step.  (The `kernels`
     phase holds the kernels at the slabs' heights.)
On request only: `scan4` (TERRAIN_SCAN on four NCCL ranks, a card each,
each rank's wall clock bounded: a 4 x 1 mesh's trainer epoch at
TERRAIN_SCAN=16 bit-equal to k = 1, bf16 graph against eager at global
batch 16, a 2 x 2 mesh's and the 1 x 4 spatial `both` step's chunks
bit-equal to their eager steps), `tp4` (the `tp` phase on four cards: a 1 x 4 mesh of
NCCL ranks, a card each, and rank 0's one-process step timed beside
the mesh's), `spatial4` (the `spatial` phase on four cards: a 1 x 4
mesh of NCCL ranks, the 64² decoder stage a 16-row slab, the stem on
130- and 132-row slabs with their halos),
`conditioning` (what fp32 rounding does to the 256px
step: CPU fp32 vs fp64, card vs CPU, kernels vs plain versions) and
`determinism` (two fp32 steps from one state in each of DET_SETTINGS, the
warnings of deterministic algorithms, what the repairs cost in fp32 and
bf16, and cuDNN's and the port's fp32 conv gradients of the step
against fp64).
The last lines are the `kernels` JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

T_IMPORT = time.perf_counter()  # the coldstart child's timeline starts here
HERE = os.path.dirname(os.path.abspath(__file__))
EXPERIMENT = "test1_nobn_bilin_both"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit installs it
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
# between the kernels and their plain versions on one card.  With the
# accurate 5x5 dW (ops/conv.Conv5x5, on the card and the CPU alike) the
# card-vs-CPU reading is 7.1e-3 in three runs (an NVIDIA H100 80GB HBM3):
# the BatchNorms, not the dW, set it, so the limit stays.
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
# of the shipped set's 240 pairs (64 MB of uint8 on the card): the depth
# cut to keep the whole script within its time (240, then 120, 64, now 40:
# 10 train steps an epoch, as the quality path's)
TRAINER_N = 40
# the quality path's train set: depth cut to 10 steps an epoch (the widths
# are the flagship's); the valid set is its floor of 4 pairs, one step
QUALITY_N = 40
# epoch 1 warms up (cuDNN's choices for new shapes), epoch 2 is traced
# (TERRAIN_PROFILE), epoch 3 is the clean one
QUALITY_EPOCHS = 3
SWD_N = 16               # images per SWD evaluation (the trainer's n)
# the summarizer on the traced epoch: its seconds (limit), the share of the
# cuDNN, GEMM and hand-written families' ms that must carry a bound, the
# family rows' sum against the busy total (relative), the tables' length
SUMMARY_LIMIT_S = 20.0
SUMMARY_BOUNDED = 0.99
SUMMARY_SUM_TOL = 1e-3
SUMMARY_TOP = 15
# seconds the trace summaries, the traced replays and eager step, and the
# train phase's label check took (printed at the end)
TRACE_WORK_S = []
SWD_TOL = 1e-4           # relative, card vs CPU: fp32 sums in another order
# TERRAIN_BC_BWD, the bilinear_conv backward's route (conv6 is the default)
BC_BWD_MODES = ("conv6", "dense", "xla32")
# TERRAIN_POOL_VJP's two custom-VJP formulations (ops/pool.py), the
# alternatives to the pool2 kernels: the flagship step under each, and the
# pool alone at the discriminator's first pool's shape
POOL_MODES = ("lanes", "dense")
POOL_TIME_SHAPE = (8, 512, 512, 64)
# the raster phase: a synthetic pair at the NASA rasters' size (21600 x
# 10800, SURVEY.md:76), one epoch of TERRAIN_EPOCH_CROPS crops from it
RASTER_H, RASTER_W = 10800, 21600
RASTER_CROPS = 48
# the epochs from the JPEG, TIFF, WebP, JPEG 2000 and PFM + DDS pairs: 4 train
# steps of 512px crops each
EPOCH_CROPS = 16
RASTER_DECODE_S = 60.0   # limit: seconds to decode the pair on the host
# the JPEG fixtures (tests/make_jpeg_fixtures.py, with imageio's digests):
# each decoded to its digest; the texture trained from; the strip (a
# restart marker each MCU row) repeated into a 21600 x 10800 texture
JPEG_DIR = os.path.join("tests", "data", "jpeg")
JPEG_TEXTURE = "texture_2048x1024_420.jpg"
JPEG_STRIP = "strip_21600x32_420_rst.jpg"
# the progressive kinds: the strip (a DRI of one MCU row before each scan)
# repeated into a 21600 x 10800 texture and trained from; the texture the
# inputs phase builds a dataset from
JPEG_PSTRIP = "progressive_strip_21600x32_420_rst.jpg"
JPEG_PTEXTURE = "progressive_2048x1024_420.jpg"
# the TIFF, PNG, BMP, WebP, PNM, TGA and JPEG 2000 fixtures
# (tests/make_raster_fixtures.py, with imageio's digests): each decoded to
# its digest; the two full-width TIFF strips (8 rows a strip) repeated into
# a 21600 x 10800 pair, decoded and trained from; the 1024 x 640 WebP pair
# (lossless heights, q90 texture) decoded, timed and trained from; the two
# 1024 x 1024 JPEG 2000 tiles repeated into 20480 x 10240 codestreams,
# decoded and timed, and trained from; a RASTER_W x RASTER_H Pf heights
# file and the two 1024 x 1024 DDS tiles' block rows repeated into
# RASTER_W x RASTER_H textures, decoded and timed, and a PFM heights file
# with the DXT1 tile trained from; the SGI, PCX, QOI, IM, ICO, ICNS and
# MPO fixtures each decoded to its digest (or imageio's exception)
RASTER_FIXTURE_DIRS = ("tiff", "png", "bmp", "webp", "pnm", "tga", "jp2",
                       "pfm_pam", "hdr", "sun", "dds", "sgi", "pcx", "qoi",
                       "im", "ico", "icns", "mpo")
# the SGI + QOI pair: RASTER_W x RASTER_H files decoded once each, and an
# epoch of SQ_EPOCH_CROPS crops from SQ_H x SQ_W versions
SQ_H, SQ_W = 1024, 2048
SQ_EPOCH_CROPS = 8
WEBP_PAIR = ("pillow_pair_hm_1024x640_lossless.webp",
             "pillow_pair_tex_1024x640_q90.webp")
TIFF_TEXTURE_STRIP = "strip_21600x32_rgb_lzw.tif"
TIFF_HEIGHT_STRIP = "strip_21600x32_gray16_deflate.tif"
JP2_TILES = ("tile_1024_gray16_53_5levels.jp2", "tile_1024_rgb_97_3layers.jp2")
JP2_H, JP2_W = 10240, 20480  # 10 x 20 tiles of 1024
JP2_RUNS = 1  # timed decodes of each 20480 x 10240 codestream
DDS_TILES = ("tile_1024_dxt1.dds", "tile_1024_bc7.dds")
# the inputs phase: a child process in which these cannot be imported (the
# card's machine has none of them; the port reads h5 files without h5py),
# the committed h5py files (tests/make_h5_fixtures.py), and the pairs an
# epoch trains on from an h5 the port writes (the synthetic set of
# TERRAIN_N=INPUTS_N: its valid set is 4 pairs)
BLOCKED = ("h5py", "imageio", "PIL")
H5_DIR = os.path.join("tests", "data", "h5")
H5_GZIP = "pairs_earliest_gzip.h5"
H5_EDGE = "edge_unfiltered_pairs_512.h5"  # unfiltered partial edge chunks
# artifacts: the flagship's interp clip, (10 - 1) * 25 interpolants of which
# whole batches of 4 are written (experiments._MODES), 512 x 1024 each
CLIP_SAMPLES, CLIP_BATCH = 10, 4
CLIP_DISPATCHES = (CLIP_SAMPLES - 1) * 25 // CLIP_BATCH
CLIP_LAUNCHES = {"bilinear_conv": 2, "conv_thin": 1}  # each dispatch
GIF_DIR = os.path.join("tests", "data", "gif")
# a full-colour clip frame's mean absolute error against its source, grey
# levels: the median cut's 256 entries on the flagship's random-weight
# frames (the committed clips hold the writer to Pillow's own error)
CLIP_MAE_LIMIT = 12.0
CLIP_GRAY_FRAMES = 24    # heightmap halves rendered as a gray clip
ARTIFACTS_LIMIT_S = 600
INPUTS_N = 48
# a first, shorter synthetic epoch at the same shapes (batch 4, 512px; 2
# train steps and the valid floor's 1) takes cuDNN's warm-up, so that the
# synthetic and h5 epochs compared after it are all warm
INPUTS_WARMUP_N = 8
INPUTS_LIMIT_S = 600
# the scan phase: eager steps against one CUDA graph of SCAN_K steps from
# one saved state, on SCAN_N pairs held on the card; timing at
# TERRAIN_SCAN=16 (terrain_tpu's TPU launch script); the trainer on
# SCAN_TRAINER_N pairs at TERRAIN_SCAN=16 (10 train steps an epoch, one
# chunk; the valid pass 1 step): the depth cut to keep the whole script's
# time (240 pairs, then 120, 64, now 40)
SCAN_K = 4
SCAN_TIME_K = 16
SCAN_N = 16
SCAN_TRAINER_N = 40
SCAN_BUSY_LIMIT = 1.25   # bf16: graph step ms / its profiled device ms
# the parallel phase.  A data-parallel step computes one process's
# function with its sums in another order: the BatchNorms' statistics and
# the losses as all-reduced sums over a count, and on two ranks each
# rank's share of every sum over the batch, at cuDNN's algorithms for the
# local batch.  Its twin in one process changes those orders alone: a
# world-1 mesh (the same BatchNorm sums) whose two discriminators (no
# BatchNorm, no dropout) run each rank's rows as a call of their own.  The
# gradients pass back through BatchNorms over a few values, so a new
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
# PAR_SEEDS and seed 7 (PERF.md §6).  The DCGAN discriminator's fp32
# limit is 2e-5 since its 5x5 convs' dW is accurate (ops/conv.Conv5x5):
# it was 1e-4, about twice the largest reading before; the readings are
# now 4.5e-7 to 4.1e-6 in three runs, so 2e-5 leaves 4.8x over them.
PAR_WORLD = 2
PAR_N = 8
# the batches and datasets every figure is read on (two, cut from three to
# keep the whole script within its time; a limit pooled over the seeds,
# the twin's largest error, can only shrink)
PAR_SEEDS = (0, 1)
PAR_TOL = 1e-4           # two ranks vs one process: the least limit
PAR_TWIN = 2.0
PAR_LOSS_TOL = {"fp32": 1e-6, "bf16": 1e-4}  # world 1 vs no mesh
PAR_W1_GRAD_TOL = {"fp32": {"dcgan_gen": 2e-2, "dcgan_disc": 2e-5,
                            "p2p_gen": 4e-3, "p2p_disc": 1e-4},
                   "bf16": {"dcgan_gen": 2e-2, "dcgan_disc": 1e-4,
                            "p2p_gen": 5e-2, "p2p_disc": 1e-4}}
# TERRAIN_SCAN over a mesh: the world-1 NCCL mesh's chunks (fp32 bit-equal
# to eager, bf16 timed) at terrain_tpu's TPU launch script's k; the two
# gloo ranks' epoch at TERRAIN_SCAN=PAR_SCAN_GLOO_K over PAR_SCAN_GLOO_N
# pairs (k steps an epoch), a loop by train/step.py's rule
PAR_SCAN_K = 8           # the world-1 mesh's fp32 chunks held to eager
PAR_SCAN_TIME_K = 16     # its bf16 chunks timed (and scan4's)
PAR_SCAN_GLOO_K = 4
PAR_SCAN_GLOO_N = 16
PAR_FAULTS = ("BN statistics local", "gradients summed",
              "gradients 1% large", "half the batch twice")
# the accuracy phase: each library conv of the fp32 step against fp64,
# relative to the largest entry.  The DCGAN discriminator's 5x5 convs with
# cin >= 64 take ops/conv.Conv5x5's dW (cuDNN's own fp32 dW of them is
# 8e-3 to 3.6e-2 off at 64-256²: its Winograd, PERF.md); the others stay
# as cuDNN gives them: the largest, the dW of the (4,128²,64) -> 256 3x3
# conv, read 4.06e-5 on an NVIDIA H100 80GB HBM3 at 700 W
ACC_ROUTE_TOL = 1e-4
ACC_ANCHORS = 6          # the calls whose card fp64 is held to the CPU's
ACC_ANCHOR_TOL = 1e-10   # relative: fp64 sums in another order
ACC_TOL = 5e-5
PHASES = {"coldstart", "kernels", "ballast", "serve", "train", "trainer",
          "quality",
          "raster", "inputs", "artifacts", "scan", "nans",
          "parallel", "accuracy", "tp", "spatial", "conditioning",
          "determinism", "tp4", "spatial4", "scan4"}


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
    The first case of each kernel is the main path's shape.  `cost(dtype)`
    is the kernel module's cost model at the case's shape: (flops, bytes,
    TF32 passes).  `f32_out`
    marks outputs that are fp32 whatever the input type (dW, db).  Where the
    library call computes less than the kernel (a forward without its
    activation, a gradient without the leaky select, dW without db),
    `lib_same` is a library route that computes the same function: the
    activation, or the select, the library gradient and the db sum.
    The TF32 passes are those the kernel's fp32 products take
    (utils/roofline.bound_ms).  `slab` marks the heights that the
    spatial phase gives a kernel (a slab of rows with its halo): checked
    and not timed."""
    import torch.nn.functional as F
    from torch.nn import grad as ng

    from terrain_tpu_torch.ops.kernels import bilinear as bl
    from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import conv_stem as cs
    from terrain_tpu_torch.ops.kernels import conv_thin as ct
    from terrain_tpu_torch.ops.kernels import pool2 as p2

    def cost(mod, name, **shape):
        return lambda dt: mod.cost(name, dtype=dt, **shape)

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
            cost=cost(ct, "conv_thin", n=n, h=h, w=w, c=c, f=f))

    def thin_dx(n, h, w, c, f):
        def make(dt, g):
            return (_rand(torch, g, (n, h, w, f), dt),
                    _rand(torch, g, (3, 3, c, f), dt, (9 * c) ** -0.5))

        return dict(
            name="conv_thin_dx", shape=(n, h, w, c, f), make=make,
            kern=ct.conv_thin_dx, plain=ct.conv_thin_dx_plain, twice=True,
            lib=lambda gg, wt: ng.conv2d_input((n, c, h, w), oihw(wt),
                                               nchw(gg), padding=1),
            cost=cost(ct, "conv_thin_dx", n=n, h=h, w=w, c=c, f=f))

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
            cost=cost(ct, "conv_thin_dw", n=n, h=h, w=w, c=c, f=f))

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
            cost=cost(cs, "conv_stem_fwd", n=n, h=h, w=w, f=f))

    def stem_dw(n, h, w, f, slope):
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
            cost=cost(cs, "conv_stem_dw", n=n, h=h, w=w, f=f,
                      mask=int(slope is not None)))

    def stem_dx(n, h, w, f, slope):
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
            cost=cost(cs, "conv_stem_dx", n=n, h=h, w=w, f=f,
                      mask=int(slope is not None)))

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
            cost=cost(bc, "bilinear_conv", n=n, h=h, w=w, c=c, f=f),
            twice=True)

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
            cost=cost(p2, "pool2_fwd", n=n, h=h, w=w, c=c))

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
            lib_make=lib_make,
            cost=cost(p2, "pool2_bwd", n=n, h=h, w=w, c=c))

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
            cost=cost(c2, "conv_s2_fwd", n=n, h=h, w=w, c=c, f=f))

    def s2_dw(n, h, w, c, f, slope):
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
            cost=cost(c2, "conv_s2_dw", n=n, h=h, w=w, c=c, f=f,
                      mask=int(slope is not None)))

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
            cost=cost(bl, "bilinear", n=n, h=h, w=w, c=c))

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
            s2_dw(1, 64, 256, 2, 8, 0.2), s2_dw(1, 16, 48, 4, 512, None),
            # the spatial phase's slabs with their halos (parallel/
            # spatial.py): conv_s2 on a 256-row slab below the first, its
            # halo row and a zero row above (HO = 129, no multiple of the
            # 8-row tile), and on 1 x 4's 128-row slabs (HO = 65), the
            # U-Net's and PatchGAN's first convs; bilinear_conv and
            # bilinear on 1 x 2's edge slabs (32 + 1 and 64 + 1 rows) and
            # 1 x 4's inner ones (16 + 2 and 32 + 2)
            *[dict(c, slab=True) for c in (
                s2_fwd(4, 258, 512, 1, 64, None),
                s2_fwd(8, 258, 512, 4, 64, 0.01),
                s2_fwd(4, 130, 512, 1, 64, None),
                s2_fwd(8, 130, 512, 4, 64, 0.01),
                s2_dw(4, 258, 512, 1, 64, None),
                s2_dw(8, 258, 512, 4, 64, 0.01),
                s2_dw(4, 130, 512, 1, 64, None),
                s2_dw(8, 130, 512, 4, 64, 0.01),
                bil(4, 33, 64, 512, 128), bil(4, 65, 128, 256, 64),
                bil(4, 18, 64, 512, 128), bil(4, 34, 128, 256, 64),
                up2(4, 65, 128, 256), up2(4, 34, 128, 256),
                # the DCGAN pair's: the discriminator's stem on a
                # 256-row slab with its 2-row halo (1 x 2, either rank),
                # and 1 x 4's 128-row slabs, 130 rows at the edge ranks
                # and 132 in the middle, forward (the concat batch of 8
                # and the fake batch of 4), dW+db (8) and dX (4)
                stem_fwd(8, 258, 512, 64, 0.2), stem_fwd(4, 258, 512, 64, 0.2),
                stem_fwd(8, 130, 512, 64, 0.2), stem_fwd(8, 132, 512, 64, 0.2),
                stem_fwd(4, 132, 512, 64, 0.2),
                stem_dw(8, 258, 512, 64, 0.2), stem_dw(8, 130, 512, 64, 0.2),
                stem_dw(8, 132, 512, 64, 0.2),
                stem_dx(4, 258, 512, 64, 0.2), stem_dx(4, 130, 512, 64, 0.2),
                stem_dx(4, 132, 512, 64, 0.2),
                # the generator's output conv (conv_thin after the phase
                # decomposition) on 1 x 2's 128-row slabs with one halo
                # row (129), 1 x 4's edge (65) and middle (66) slabs: odd
                # heights against the row pairs of its forward and dX
                *[k(4, hh, 256, 64, 4) for hh in (129, 65, 66)
                  for k in (thin, thin_dx, thin_dw)],
                # the discriminator's max pools on slabs (no halo), with
                # ties: 1 x 2's 256 ... 8 rows (the last pooled, then
                # gathered) and 1 x 4's 128 ... 8
                *[k(8, hh, ww, c, ties=True)
                  for hh, ww, c in ((256, 512, 64), (128, 256, 128),
                                    (64, 128, 128), (32, 64, 128),
                                    (16, 32, 256), (8, 16, 256),
                                    (128, 512, 64), (64, 256, 128),
                                    (32, 128, 128), (16, 64, 128),
                                    (8, 32, 256))
                  for k in (pool_fwd, pool_bwd)])]]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def check_kernels(torch):
    from terrain_tpu_torch.utils.roofline import bound_ms

    results = {}
    g = torch.Generator(device="cuda").manual_seed(1234)
    for case in kernel_cases(torch):
        name, shape = case["name"], case["shape"]
        big = case["cost"](torch.float32)[0] > 1e9
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
            if case.get("slab"):
                print(f"kernel {name} {shape} {str(dt).split('.')[-1]} "
                      f"(a slab of the spatial phase): max_abs_err "
                      f"{err:.3e} (tol {lim:.3e}), not timed", flush=True)
                results.setdefault(name, []).append(dict(
                    shape=shape, dtype=str(dt).split(".")[-1],
                    max_abs_err=err, tol=lim))
                del args, refs, outs
                continue
            lib = (case["lib_make"](*args) if "lib_make" in case
                   else lambda: case["lib"](*args))
            ms = time_ms(lambda: case["kern"](*args))
            dev_ms = stream_ms(lambda: case["kern"](*args))
            plain_ms = time_ms(lambda: case["plain"](*args),
                               reps=10 if big else 30)
            lib_ms = time_ms(lib, reps=10 if big else 30)
            fp32 = dt == torch.float32
            flops, nbytes, passes = case["cost"](dt)
            bound, by = bound_ms(flops, nbytes, fp32, passes)
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
            if fp32 and passes:  # the CUDA cores', as before
                row["cuda_core_bound_ms"] = bound_ms(flops, nbytes, True)[0]
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
    from terrain_tpu_torch.utils import roofline

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
        bound = 4 * n * h * w * c * 5 / roofline.HBM_BW * 1e3
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


def device_rows(prof):
    """The key_averages rows of a profile's device-side events.  CPU ops
    carry their kernels' time too, and a `record_function` label
    (CudaKernel.launch's) has a device span as long as the kernels inside
    it: both left out, as torch's own table leaves the labels out."""
    return [ev for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not ev.is_user_annotation]


def profiled(torch, fn):
    """One profiled call: (wall ms, [(device ms, count, kernel name)]) of
    its device-side events (device_rows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in device_rows(prof):
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
    from terrain_tpu_torch.ops.kernels import all_kernels

    return all_kernels()


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
    for label, cd, on, unfused, bc_bwd, pool in (
            ("fp32", torch.float32, False, False, None, None),
            ("fp32", torch.float32, False, True, None, None),
            ("fp32", torch.float32, True, False, None, None),
            ("bf16", torch.bfloat16, False, False, None, None),
            ("bf16", torch.bfloat16, True, False, None, None),
            *((lb, cd, False, False, m, None)
              for lb, cd in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16))
              for m in BC_BWD_MODES[1:]),
            *((lb, cd, False, False, None, m)
              for lb, cd in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16))
              for m in POOL_MODES)):
        set_switches(on)
        set_switches(unfused, UNFUSED)
        set_switches(bc_bwd is not None, {"TERRAIN_BC_BWD": bc_bwd})
        if pool:  # set_switches(on) unset it: switches are off here
            os.environ["TERRAIN_POOL_VJP"] = pool
        label = (f"{label} switches {'on' if on else 'off'}"
                 + (" unfused decoder" if unfused else "")
                 + (f" TERRAIN_BC_BWD={bc_bwd}" if bc_bwd else "")
                 + (f" TERRAIN_POOL_VJP={pool}" if pool else ""))
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
        if label == "bf16 switches off":
            label_check(torch, card, got, evs)
        if not (bc_bwd or pool):  # the alternatives' profiles: cut for time
            profile_once(torch, lambda: ts.train_step(
                ts.opt_states, batch, None, ts.lr), f"train step {label}",
                top=12)
        if cd == torch.float32:
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
        del ts, before, batch
        torch.cuda.empty_cache()
    set_switches(False)
    set_switches(False, UNFUSED)
    os.environ.pop("TERRAIN_BC_BWD", None)
    pool_timing(torch, card)
    return counts, step_ms


def label_check(torch, card, got, evs, calls=200_000):
    """What the profiler labels add to a launch with no profiler recording:
    CudaKernel.labelled(), the one check `launch` makes before it calls
    the entry point, timed on the host clock over `calls` calls (the
    loop's own cost included), times the step's launches (`got`, over
    TRAIN_STEPS steps), against the spread of the step's CUDA-event times
    (`evs`).  Fails if that cost reaches the spread."""
    kernels = _counters()
    per_step = sum(got[n] for n in kernels) / TRAIN_STEPS
    k = next(iter(kernels.values()))
    t0 = time.perf_counter()
    for _ in range(calls):
        k.labelled()
    us = (time.perf_counter() - t0) * 1e6 / calls
    TRACE_WORK_S.append(time.perf_counter() - t0)
    ms = sorted(s.elapsed_time(e) for s, e in evs)
    cost = us * per_step / 1e3
    print(f"train bf16 switches off [{card}]: CudaKernel.labelled() with no "
          f"profiler {us:.4f} us a call (host clock, {calls} calls, loop "
          f"included) x {per_step:g} launches a step = {cost:.6f} ms a "
          f"step, against the eager step's spread over {TRAIN_STEPS} steps "
          f"{ms[-1] - ms[0]:.3f} ms (CUDA events {ms[0]:.3f} to "
          f"{ms[-1]:.3f} ms)", flush=True)
    if not cost < ms[-1] - ms[0]:
        fail(f"train: the label check costs {cost:.6f} ms a step, the "
             f"step's spread is {ms[-1] - ms[0]:.3f} ms")


def pool_timing(torch, card):
    """The DCGAN discriminator's 2x2 max pool at (8,512²,64), forward plus
    backward, under each TERRAIN_POOL_VJP formulation as PyTorch ops (sas:
    the library pool; lanes and dense: ops/pool.py's Functions; pallas:
    the pool2 kernels), fp32 and bf16, beside the pool2 kernels' bound
    (each input read once, each output written once: x and y forward, x,
    the cotangent and dx backward)."""
    from terrain_tpu_torch.ops import max_pool2d
    from terrain_tpu_torch.utils import roofline

    n, h, w, c = POOL_TIME_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dt)
        cot = torch.randn((n, h // 2, w // 2, c), generator=g,
                          device="cuda").to(dt)
        xr = x.requires_grad_()
        es = x.element_size()
        bound = es * n * h * w * c * (5 + 9) / 4 / roofline.HBM_BW * 1e3
        ms = {}
        for mode in ("sas", "pallas", *POOL_MODES):
            os.environ["TERRAIN_POOL_VJP"] = mode

            def fwd_bwd():
                return torch.autograd.grad(max_pool2d(xr, 2), xr, cot)

            ms[mode] = time_ms(fwd_bwd, reps=20)
        os.environ.pop("TERRAIN_POOL_VJP")
        print(f"pool timing [{card}] {POOL_TIME_SHAPE} {str(dt)[6:]}: "
              f"forward + backward ms (CUDA events, median of 20) "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; the pool2 kernels' bound {bound:.4f} ms (bytes)",
              flush=True)
        del x, xr, cot
    torch.cuda.empty_cache()


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


def _check_arch(gan, out):
    """The fresh run's arch_<net>.txt: terrain_tpu's text for each network
    (models/core.describe); arch_<net>.png where matplotlib imports."""
    import importlib.util

    from terrain_tpu_torch.models.core import describe

    have = importlib.util.find_spec("matplotlib") is not None
    for name, net in gan.nets.items():
        with open(os.path.join(out, f"arch_{name}.txt")) as f:
            if f.read() != describe(net):
                fail(f"trainer: arch_{name}.txt is not describe's text")
        if os.path.exists(os.path.join(out, f"arch_{name}.png")) != have:
            fail(f"trainer: arch_{name}.png {'missing' if have else 'drawn'}"
                 f" with matplotlib {'present' if have else 'absent'}")
    print(f"trainer: the four arch_<net>.txt equal describe's text; "
          f"matplotlib {'imports' if have else 'is not installed'} on this "
          f"machine, so arch_<net>.png {'were drawn' if have else 'were skipped'}",
          flush=True)


def _memoize_pairs():
    """Synthetic pairs made once per (n, size, seed) in this process, each
    call given a copy: the phases and their CLI runs draw the same sets
    again and again (data/synthetic.py gives the same bytes for equal
    arguments), and making them is set-up outside every timed step and
    epoch.  _plain_pairs() restores the plain function where its time is
    the measurement."""
    from terrain_tpu_torch.data import synthetic

    plain, made = synthetic.make_pairs, {}

    def make_pairs(n, size, seed=0):
        key = (int(n), int(size), int(seed))
        if key not in made:
            made[key] = plain(n, size, seed)
        return tuple(a.copy() for a in made[key])

    make_pairs.plain = plain
    synthetic.make_pairs = make_pairs


@contextlib.contextmanager
def _plain_pairs():
    from terrain_tpu_torch.data import synthetic

    memo = synthetic.make_pairs
    synthetic.make_pairs = getattr(memo, "plain", memo)
    try:
        yield
    finally:
        synthetic.make_pairs = memo


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
    from terrain_tpu_torch.train.trainer import TwoStageGAN

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
    # each checkpoint the CLI writes, timed where it is written
    save, saves = TwoStageGAN.save_model, []

    def timed_save(self, filename):
        t0 = time.perf_counter()
        save(self, filename)
        saves.append((time.perf_counter() - t0, filename))

    TwoStageGAN.save_model = timed_save
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
        _check_arch(gan, out)
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
        with _plain_pairs():
            ds, _ = _get_data(gan.in_shp, device="cuda")
        torch.cuda.synchronize()
        t_data = time.perf_counter() - t0
        # the resumed run's write of 2.model
        t_save, last = saves[-1]
        if [os.path.basename(f) for _, f in saves] != ["1.model", "2.model"]:
            fail(f"trainer: the CLI wrote the checkpoints {saves}")
        size = os.path.getsize(last)
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
        TwoStageGAN.save_model = save
        set_switches(False)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return counts, float(rows[0]["time"])


# ------------------------------------------------------------------ phase 7
class LostEvents(Exception):
    """A graph replay's trace holds fewer events of a hand-written kernel
    than its steps launched, and none more: the profiler dropped device
    records (a run of kernels of every family missing at once, seen once in
    a 16-step replay's 53,000 events).  A replay runs every kernel its
    graph holds, so the caller traces it once more, and a second shortfall
    fails."""


def summarize_checked(path, card, what, eager=False, per_step=None,
                      quiet=False, summary=None, bounded=None, csv=False,
                      lost_ok=False):
    """tools/summarize_trace on one trace, its family table and its top
    ops by headroom printed, then checked: the family rows sum to the busy
    time; every hand-written kernel event lands in its kernel's family
    (none in a library family or "other"); the cuDNN, GEMM and
    hand-written families carry a bound on SUMMARY_BOUNDED of their ms and
    each hand-written kernel's events equal the increase of its CudaKernel
    counter over the traced block (the trace's `terrain_launches`) and its
    `terrain::` annotations (`eager`); or, for a graph replay (`per_step`,
    (steps, {kernel: launches in one bare step})), equal the steps times
    one step's launches, every one under the cudaGraphLaunch (with
    `lost_ok`, a shortfall alone raises LostEvents).  `bounded`
    (default `eager`) checks the bounded shares alone.  `quiet` prints
    the header lines and the family table alone; `summary`, one made
    already, is checked in place of the trace at `path`, which the
    command line's code (`run`) reads otherwise, with `--csv
    <path>.csv` where `csv` (its header and rows checked).  Returns the
    Summary and the summarizer's seconds."""
    from terrain_tpu_torch.tools import summarize_trace as st
    from terrain_tpu_torch.utils.profiling import LAUNCHES_KEY

    lines = []
    t0 = time.perf_counter()
    if summary is None:
        csv_path = f"{path}.csv" if csv else None
        summ = st.run([path, "--top", str(SUMMARY_TOP)]
                      + (["--csv", csv_path] if csv else []), out=lines.append)
        secs = time.perf_counter() - t0
        TRACE_WORK_S.append(secs)
    else:
        summ, secs = summary, summary.seconds
        st.report(summ, SUMMARY_TOP, out=lines.append)
    print(f"{what} [{card}]: tools/summarize_trace"
          + (f" on {os.path.basename(path)} "
             f"({os.path.getsize(path) / 2**20:.1f} MiB)" if path else "")
          + f" in {secs:.2f} s:", flush=True)
    if quiet:  # the header and the family table
        lines = lines[:next(i for i, line in enumerate(lines)
                            if line.startswith("\nby launching op"))]
    print("\n".join(lines), flush=True)
    if summary is None and csv:
        with open(csv_path) as f:
            rows = f.read().splitlines()
        if rows[0] != st.CSV_HEADER or len(rows) - 1 != len(summ.per_op):
            fail(f"{what}: the CSV has {len(rows) - 1} rows under "
                 f"{rows[0]!r}, expected {len(summ.per_op)} under the JAX "
                 f"tool's header")
        print(f"{what}: --csv wrote {len(rows) - 1} rows under the JAX "
              f"tool's header", flush=True)
    fam_sum = sum(v[0] for v in summ.families.values())
    if not abs(fam_sum - summ.busy_ms) <= SUMMARY_SUM_TOL * summ.busy_ms:
        fail(f"{what}: the family rows sum to {fam_sum} ms, busy "
             f"{summ.busy_ms} ms")
    for (name, op, _), row in summ.per_op.items():
        base = st.kernel_base(name)
        if (base in st.hand_written() or base in st.SHARED_SYMBOLS) \
                and not row.family.startswith(st.HAND_PREFIX):
            fail(f"{what}: hand-written {base} under {op} fell to "
                 f"{row.family}")
    hand = summ.hand
    if eager if bounded is None else bounded:
        for fam, (ms, _, bnd) in summ.families.items():
            if (fam in st.LIBRARY_BOUNDED or fam.startswith(st.HAND_PREFIX)) \
                    and bnd < SUMMARY_BOUNDED * ms:
                fail(f"{what}: {fam} has a bound on {bnd:.3f} of its "
                     f"{ms:.3f} ms")
    if eager:
        launched = summ.meta.get(LAUNCHES_KEY)
        if launched is None:
            fail(f"{what}: the trace holds no {LAUNCHES_KEY}")
        for name, h in hand.items():
            want = (launched[name], launched[name], launched[name])
            if (h["events"], h["labels"], h["linked"] + h["by_order"]) \
                    != want:
                fail(f"{what}: {name} has {h} against {launched[name]} "
                     f"launches")
        print(f"{what}: hand-written kernel events = launches = terrain:: "
              f"labels { {n: h['events'] for n, h in hand.items()} }; "
              f"linked through correlation (launch inside its label) "
              f"{sum(h['linked'] for h in hand.values())}, by name and "
              f"order {sum(h['by_order'] for h in hand.values())}",
              flush=True)
    if per_step is not None:
        steps, grid = per_step
        off = {name: (h["events"], steps * grid.get(name, 0))
               for name, h in hand.items()
               if h["events"] != steps * grid.get(name, 0)}
        if off and lost_ok and all(got < want for got, want in off.values()):
            print(f"{what}: the trace lost device events (hand-written "
                  f"kernels' events, expected: {off}); traced again",
                  flush=True)
            raise LostEvents(off)
        for name, h in hand.items():
            if h["events"] != steps * grid.get(name, 0):
                fail(f"{what}: {name} ran {h['events']} times in the "
                     f"replay, expected {steps} x {grid.get(name, 0)}")
        ops = {op for (name, op, _), row in summ.per_op.items()
               if row.family.startswith(st.HAND_PREFIX)}
        if ops != {st.GRAPH_LAUNCH}:
            fail(f"{what}: hand-written kernels launched by {ops}")
        print(f"{what}: hand-written kernel events "
              f"{ {n: h['events'] for n, h in hand.items() if h['events']} }"
              f" = {steps} x one bare step's launches, each in its family "
              f"under {st.GRAPH_LAUNCH}", flush=True)
    return summ, secs


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
              f"up, epoch 2 is traced, epoch 3 is clean: the trace costs "
              f"{times[1] - times[2]:.3f} s); the bare step of this "
              f"configuration "
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
        _, secs = summarize_checked(
            os.path.join(trace_dir, traces[0]), card,
            "quality (traced epoch 2)", eager=True, csv=True)
        if secs > SUMMARY_LIMIT_S:
            fail(f"quality: the summarizer took {secs:.1f} s")
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
        print(f"quality [{card}]: the unfused decoder's SWD evaluation "
              f"({SWD_N} images, under device.strict_fp32): peak MiB "
              f"allocated {[p for _, p in seg['log_swd']]} (each epoch's, "
              f"weights included); its U-Net forward at batch {SWD_N} "
              f"{peaks[f'unfused decoder, batch {SWD_N}']} MiB above the "
              f"weights, the fused decoder's "
              f"{peaks[f'fused decoder, batch {SWD_N}']}", flush=True)
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
def _synthetic_raster(np, seed=0, size=(RASTER_H, RASTER_W)):
    """A raster pair at the NASA rasters' size (or `size`): a heightmap of a few
    separable waves, made at a quarter of the size and repeated 4x4, about
    30% of it ocean (zeros) in large regions, and an RGB texture coloured
    from it; both carry 2 bits of noise at full size from a random tile
    wider than zlib's window, so neither compresses to nothing."""
    rnd = np.random.RandomState(seed)
    full_h, full_w = size
    h, w = full_h // 4, full_w // 4
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
    noise = np.tile(noise, (full_h // 512 + 1, full_w // 16384 + 1))
    noise = noise[:full_h, :full_w]
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
    slicing, its crops/s and rejection share, then one epoch of
    `TERRAIN_RASTER=hm.png,tex.png TERRAIN_EPOCH_CROPS=48 python -m
    terrain_tpu_torch test1_nobn_bilin_both train` through cli.main with the
    counters set to 0 just before and read just after; then the other
    formats (raster_jpeg ... raster_sgi_qoi), their memory runs in one
    decode process started here.  Returns the counts of every epoch."""
    import math
    import shutil
    import tempfile

    import numpy as np

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.data import RasterCropIterator, augment_pair
    from terrain_tpu_torch.serve.png import decode_png, encode_png
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    root = tempfile.mkdtemp(prefix="raster_")
    dec = _DecodeProcess()
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
        del dhm, dtex, tex, it  # hm stays: the progressive texture's first batch
        os.environ.update({
            "TERRAIN_RASTER": ",".join(paths),
            "TERRAIN_EPOCH_CROPS": str(RASTER_CROPS), "TERRAIN_EPOCHS": "1",
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
        if len(rows) != 1:
            fail(f"raster: results.txt has {len(rows)} epochs")
        n_train = RASTER_CROPS // TRAIN_BATCH
        n_eval = max(RASTER_CROPS // 10, TRAIN_BATCH) // TRAIN_BATCH
        for k, v in TRAIN_LAUNCHES.items():
            if got[k] < n_train * v:
                fail(f"raster: {k} launched {got[k]} times in {n_train} "
                     f"train steps")
        row = rows[0]
        epoch = float(row["time"])
        step_ms = epoch * 1e3 / (n_train + n_eval)
        print(f"raster [{card}]: `TERRAIN_RASTER=hm.png,tex.png "
              f"TERRAIN_EPOCH_CROPS={RASTER_CROPS} {EXPERIMENT} train`: "
              f"{wall:.1f} s in all (decoding the pair again included), "
              f"epoch {epoch:.3f} s for {n_train} train + {n_eval} eval "
              f"steps ({step_ms:.3f} ms a step); a host batch "
              f"{t_batch * 1e3:.1f} ms = {t_batch * 1e3 / step_ms:.3f} of a "
              f"step (on the prefetcher's thread), the augmentation on the "
              f"card {aug_ms:.3f} ms = {aug_ms / step_ms:.4f}; losses "
              f"{ {k: float(row['train_' + k]) for k in TRAIN_KEYS} }; "
              f"launches {got}", flush=True)
        jpeg = raster_jpeg(torch, card, root, hm, dec)
        got = {k: got[k] + jpeg[k] for k in got}
        del hm
        tif = raster_tiff(torch, card, root, dec)
        got = {k: got[k] + tif[k] for k in got}
        wp = raster_webp(torch, card, root)
        got = {k: got[k] + wp[k] for k in got}
        j2 = raster_jp2(torch, card, root, dec)
        got = {k: got[k] + j2[k] for k in got}
        fd = raster_float_dds(torch, card, root, dec)
        got = {k: got[k] + fd[k] for k in got}
        sq = raster_sgi_qoi(torch, card, root, dec)
        got = {k: got[k] + sq[k] for k in got}
    finally:
        dec.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return got


def _jpeg_fixtures():
    """{name: (bytes, {"shape", "sha256", ...})} of tests/data/jpeg."""
    with open(os.path.join(HERE, JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    out = {}
    for name, want in digests.items():
        if name == "reference":  # the Pillow and libjpeg-turbo versions
            continue
        with open(os.path.join(HERE, JPEG_DIR, name), "rb") as f:
            out[name] = (f.read(), want)
    return out


def _repeat_strip(data, height):
    """The strip JPEG (one restart interval a row of MCUs) as one of
    `height` rows: its SOF height patched and its intervals repeated in
    turn, the RST markers between them renumbered.  Returns the bytes and
    the rows of a band (MCU row)."""
    sos = data.index(b"\xff\xda")
    head_end = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    body = data[head_end:data.rindex(b"\xff\xd9")]
    intervals, start = [], 0
    i = body.find(b"\xff", 0)
    while i >= 0:
        if 0xD0 <= body[i + 1] <= 0xD7:
            intervals.append(body[start:i])
            start = i + 2
        i = body.find(b"\xff", i + 2)
    intervals.append(body[start:])
    sof = data.index(b"\xff\xc0")
    hmax = vmax = 1
    for c in range(data[sof + 9]):
        hv = data[sof + 11 + 3 * c]
        hmax, vmax = max(hmax, hv >> 4), max(vmax, hv & 15)
    band = 8 * vmax
    n = height // band
    head = bytearray(data[:head_end])
    head[sof + 5:sof + 7] = height.to_bytes(2, "big")
    out = bytearray(head)
    for r in range(n):
        if r:
            out += bytes([0xFF, 0xD0 + (r - 1) % 8])
        out += intervals[r % len(intervals)]
    out += b"\xff\xd9"
    return bytes(out), band, len(intervals)


def _raster_epoch(torch, np, what, hm, tex, paths, root, crops):
    """The raster pair at `paths` (decoded here to hm, uint8 (H, W), and
    tex): the crop iterator's first batch against plain slicing, then one
    epoch of `TERRAIN_RASTER=<paths> TERRAIN_EPOCH_CROPS=<crops>
    EXPERIMENT train` through cli.main with the counters set to 0 just
    before and read just after: one row of finite losses, every kernel's
    launches in its train steps.  Returns (counts, wall s, the row)."""
    import math

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.data import RasterCropIterator
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    it = RasterCropIterator(hm, tex, TRAIN_BATCH, crop=512,
                            epoch_size=crops, seed=0)
    x, y = it.next_uint8()
    px, py = _plain_crops(np, hm, tex, TRAIN_BATCH, 512, 0)
    if not (np.array_equal(x, px) and np.array_equal(y, py)):
        fail(f"raster: the {what}'s first batch is not the plain slices of "
             f"the decoded pair")
    del it
    tag = what.split()[0].lower()
    out = os.path.join(root, f"out_{tag}")
    os.environ.update({
        "TERRAIN_RASTER": ",".join(paths), "TERRAIN_EPOCH_CROPS": str(crops),
        "TERRAIN_EPOCHS": "1", "TERRAIN_OUT": out,
        "TERRAIN_MODELS": os.path.join(root, f"models_{tag}")})
    _reset_counters()
    t0 = time.perf_counter()
    if cli.main([EXPERIMENT, "train"]) != 0:
        fail(f"raster: the CLI returned an error on the {what}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    with open(os.path.join(out, EXPERIMENT, "results.txt")) as f:
        header, *rows = [ln.split(",") for ln in f.read().splitlines()]
    if len(rows) != 1:
        fail(f"raster: the {what} run's results.txt has {len(rows)} epochs")
    row = dict(zip(header, rows[0]))
    if not all(math.isfinite(float(row[f"{s}_{k}"]))
               for s in ("train", "valid") for k in TRAIN_KEYS):
        fail(f"raster: a loss of the {what} run is not finite: {row}")
    n_train = crops // TRAIN_BATCH
    for k, v in TRAIN_LAUNCHES.items():
        if got[k] < n_train * v:
            fail(f"raster: {k} launched {got[k]} times in {n_train} train "
                 f"steps from the {what}")
    return got, wall, row


def raster_jpeg(torch, card, root, hm_big, dec):
    """JPEG rasters through the port's decoder: each committed fixture
    decoded to imageio's digest (tests/make_jpeg_fixtures.py), the decode
    rate; the strip repeated into a 21600 x 10800 texture, its decode
    timed and every band that no vertical upsampling crosses equal to the
    strip's; then one epoch of `TERRAIN_RASTER=hm.png,<texture>.jpg
    TERRAIN_EPOCH_CROPS=16 test1_nobn_bilin_both train` through cli.main
    (the heightmap a PNG made here at the texture's size, with ocean), the
    crop iterator's first batch equal to plain slicing, the default path's
    kernels launched.  Returns the epoch's launch counts."""
    import hashlib

    import numpy as np

    from terrain_tpu_torch.data.jpeg import decode_jpeg
    from terrain_tpu_torch.serve.png import encode_png
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    fixtures = _jpeg_fixtures()
    decoded = {}
    for name, (data, want) in fixtures.items():
        t0 = time.perf_counter()
        img = decode_jpeg(data)
        dt = time.perf_counter() - t0
        sha = hashlib.sha256(img.tobytes()).hexdigest()
        print(f"raster [{card}]: JPEG {name} ({len(data)} bytes) decoded "
              f"to {img.shape} in {dt * 1e3:.1f} ms "
              f"({img.nbytes / dt / 1e6:.1f} MB/s of pixels); SHA-256 "
              f"{'equal to' if sha == want['sha256'] else 'NOT'} imageio's",
              flush=True)
        if list(img.shape) != want["shape"] or sha != want["sha256"]:
            fail(f"raster: {name} decoded to other bytes than imageio's")
        decoded[name] = img
    strip = decoded[JPEG_STRIP]
    big, band, kinds = _repeat_strip(fixtures[JPEG_STRIP][0], RASTER_H)
    t0 = time.perf_counter()
    tex = decode_jpeg(big)
    dt = time.perf_counter() - t0
    print(f"raster [{card}]: a {RASTER_W}x{RASTER_H} baseline JPEG (the "
          f"strip's {kinds} restart intervals repeated, {len(big) / 1e6:.1f} "
          f"MB) decoded in {dt:.2f} s ({tex.nbytes / dt / 1e6:.1f} MB/s of "
          f"pixels)", flush=True)
    if dt > RASTER_DECODE_S:
        fail(f"raster: the full-size JPEG took {dt:.1f} s > "
             f"{RASTER_DECODE_S} s")
    inner = slice(1, band - 1)  # rows whose chroma context is their band's
    for r in range(RASTER_H // band):
        k = r % kinds
        if not np.array_equal(tex[r * band:(r + 1) * band][inner],
                              strip[k * band:(k + 1) * band][inner]):
            fail(f"raster: band {r} of the full-size JPEG is not the "
                 f"strip's band {k}")
    del tex, big
    texture = decoded[JPEG_TEXTURE]
    h, w = texture.shape[:2]
    hm = _synthetic_raster(np, seed=2, size=(h, w))[0]
    paths = [os.path.join(root, "hm_jpeg.png"),
             os.path.join(HERE, JPEG_DIR, JPEG_TEXTURE)]
    with open(paths[0], "wb") as f:
        f.write(encode_png(hm, level=1))
    got, wall, row = _raster_epoch(torch, np, "JPEG texture", hm, texture,
                                   paths, root, EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=hm.png,{JPEG_TEXTURE} "
          f"TERRAIN_EPOCH_CROPS={EPOCH_CROPS} {EXPERIMENT} train`: {wall:.1f}"
          f" s in all, epoch {float(row['time']):.3f} s; the first batch "
          f"equals plain slicing; losses "
          f"{ {k: float(row['train_' + k]) for k in TRAIN_KEYS} }; launches "
          f"{got}", flush=True)
    raster_progressive(torch, np, card, root, decoded[JPEG_PSTRIP], hm_big,
                       dec)
    return got


def _segments(data, start):
    """(marker, start, end) of each segment of JPEG bytes from `start`; a
    scan's entropy-coded data and its RST markers belong to its SOS."""
    pos = start
    while pos < len(data) - 1:
        m = data[pos + 1]
        if m == 0xD9:
            yield m, pos, pos + 2
            return
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0x00
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        yield m, pos, end
        pos = end


def _repeat_progressive(data, height):
    """The progressive strip (a DRI of one MCU row before each scan) as one
    of `height` rows: its SOF2 height patched and each scan's restart
    intervals -- rows of MCUs of the interleaved DC scans, rows of one
    component's blocks in the others -- repeated in turn, the RST markers
    between them renumbered.  Returns the bytes, the rows of a band (MCU
    row), the bands of the strip and the scans' intervals."""
    sof = data.index(b"\xff\xc2")
    comps = {data[sof + 10 + 3 * c]: data[sof + 11 + 3 * c]
             for c in range(data[sof + 9])}
    vmax = max(hv & 15 for hv in comps.values())
    strip_h = int.from_bytes(data[sof + 5:sof + 7], "big")
    out = bytearray(data[:2])
    counts = []
    for m, a, b in _segments(data, 2):
        if m != 0xDA:
            out += data[a:b]
            continue
        head = a + 2 + int.from_bytes(data[a + 2:a + 4], "big")
        ns = data[a + 4]
        if ns > 1:
            rows = -(-height // (8 * vmax))
            per = -(-strip_h // (8 * vmax))
        else:
            v = comps[data[a + 5]] & 15
            rows = -(-(-(-height * v // vmax)) // 8)
            per = -(-(-(-strip_h * v // vmax)) // 8)
        body = data[head:b]
        intervals, start = [], 0
        i = body.find(b"\xff")
        while i >= 0:
            if 0xD0 <= body[i + 1] <= 0xD7:
                intervals.append(body[start:i])
                start = i + 2
            i = body.find(b"\xff", i + 2)
        intervals.append(body[start:])
        if len(intervals) != per:
            fail(f"raster: a progressive scan of the strip has "
                 f"{len(intervals)} restart intervals, not its {per} rows")
        out += data[a:head]
        for r in range(rows):
            if r:
                out += bytes([0xFF, 0xD0 + (r - 1) % 8])
            out += intervals[r % per]
        counts.append(per)
    out[sof + 5:sof + 7] = height.to_bytes(2, "big")
    return bytes(out), 8 * vmax, strip_h // (8 * vmax), counts


# the raster phase's decode process (_DecodeProcess): one job a line on
# its stdin, one JSON result a line on its stdout
_DECODER_CODE = """\
import ctypes, gc, importlib, json, sys, threading, time
sys.path.insert(0, sys.argv[1])
import numpy as np
for m in ("jpeg", "tiff", "jp2", "pnm", "dds"):
    importlib.import_module("terrain_tpu_torch.data." + m)
libc = ctypes.CDLL(None)
def rss():
    for ln in open("/proc/self/status"):
        if ln.startswith("VmRSS"):
            return int(ln.split()[1]) * 1024
for line in sys.stdin:
    job = json.loads(line)
    decode = getattr(importlib.import_module(job["module"]), job["decode"])
    data = open(job["path"], "rb").read()
    arg = job["path"] if job["decode"] == "decode_tiff" else data
    if job["lib"]:
        importlib.import_module(job["lib"])._lib()
    else:
        importlib.import_module(job["module"]).read_header(arg)
    gc.collect()
    libc.malloc_trim(0)
    before = rss()
    seen, done = [before], threading.Event()
    def watch():
        while not done.is_set():
            seen.append(rss())
            time.sleep(0.001)
    t = threading.Thread(target=watch, daemon=True)  # not on a raise
    t.start()
    times, img = [], None
    for _ in range(job["runs"]):
        img = None
        t0 = time.perf_counter()
        img = decode(arg)
        times.append(time.perf_counter() - t0)
    done.set()
    t.join()
    cells, equal = 0, True
    if job["tile"]:
        tile = decode(open(job["tile"], "rb").read())
        n = tile.shape[0]
        for r in range(0, img.shape[0], n):
            for c in range(0, img.shape[1], n):
                cell = img[r:r + n, c:c + n]
                equal &= np.array_equal(
                    cell, tile[:cell.shape[0], :cell.shape[1]])
                cells += 1
        del tile
    elif job["plain"]:
        plain, r = np.load(job["plain"]), job["repeat"]
        equal = img.shape[1] == plain.shape[1] * r and np.array_equal(
            img.reshape(img.shape[0], -1, r, *img.shape[2:]),
            np.broadcast_to(plain[:, :, None], plain.shape[:2] + (r,)
                            + plain.shape[2:]))
        del plain
        cells = 1
    out = {"times": times, "peak": max(seen) - before,
           "samples": len(seen), "out": img.nbytes, "cells": cells,
           "equal": bool(equal)}
    del img, data, arg
    print(json.dumps(out), flush=True)
"""


class _DecodeProcess:
    """The raster phase's memory runs: one decode process for the phase
    (its imports paid once, not once a file), fed one file at a time.
    Before each file it frees the last one's arrays and hands the heap
    back (malloc_trim), so a file's peak is taken above a resident set
    that holds only the loaded libraries and the file's bytes.  Started
    where the phase starts, so that its imports run while the phase writes
    its first files; `close` ends it."""

    def __init__(self):
        import tempfile

        self._err = tempfile.TemporaryFile(mode="w+")
        self._p = subprocess.Popen(
            [sys.executable, "-c", _DECODER_CODE, HERE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._err,
            text=True)

    def close(self):
        self._p.stdin.close()
        try:
            self._p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self._p.kill()
            self._p.wait()
        self._err.close()

    def run(self, path, module, decode, lib="", tile_path=None, plain=None,
            runs=1, limit_s=600, repeat=1):
        """The file at `path` decoded `runs` times by `module`'s `decode`
        (its bytes; the path itself for a TIFF, which the decoder maps),
        the library loaded first (`lib`'s `_lib`, else the module's
        `read_header` on the file), while a thread samples VmRSS
        (/proc/self/status, read only) every millisecond (ctypes lets go
        of the GIL; getrusage's peak would carry the process's earlier
        files); then the last decode held to the decode of the tile at
        `tile_path` cell by cell (cells of the tile's size, the edge ones
        to the tile's corner), or to the .npy array at `plain` (each of its
        columns `repeat` times).  Returns
        {times, peak (bytes above the resident set before the first
        decode), samples, out, cells, equal}."""
        import select

        self._p.stdin.write(json.dumps({
            "path": path, "module": module, "decode": decode, "lib": lib,
            "tile": tile_path or "", "plain": plain or "",
            "runs": runs, "repeat": repeat}) + "\n")
        self._p.stdin.flush()
        ready, _, _ = select.select([self._p.stdout], [], [], limit_s)
        line = self._p.stdout.readline() if ready else ""
        if not line:
            self._p.kill()
            self._p.wait()
            self._err.seek(0)
            fail(f"raster: the decode runs of {path} failed (the decode "
                 f"process {'ended' if ready else 'took too long'}):\n"
                 f"{self._err.read()[-2000:]}")
        return json.loads(line)


def raster_progressive(torch, np, card, root, strip, hm, dec):
    """The progressive strip's scans repeated into a 21600 x 10800 texture:
    its decode timed (and its peak host memory in the decode process), every
    band that no vertical upsampling crosses equal to the strip's, and the
    crop iterator's first batch from it and `hm` (the raster phase's
    heightmap, hm.png's bytes) against plain slicing.  (No epoch through
    the CLI, to keep the script's time: the TIFF pair's epoch trains from a
    21600 x 10800 pair, the 2048 x 1024 JPEG's from a JPEG texture.)"""
    from terrain_tpu_torch.data import RasterCropIterator
    from terrain_tpu_torch.data.jpeg import decode_jpeg

    with open(os.path.join(HERE, JPEG_DIR, JPEG_PSTRIP), "rb") as f:
        big, band, kinds, counts = _repeat_progressive(f.read(), RASTER_H)
    path = os.path.join(root, "tex_progressive.jpg")
    with open(path, "wb") as f:
        f.write(big)
    t0 = time.perf_counter()
    tex = decode_jpeg(big)
    dt = time.perf_counter() - t0
    print(f"raster [{card}]: a {RASTER_W}x{RASTER_H} progressive JPEG (the "
          f"strip's {len(counts)} scans, {counts} restart intervals each, "
          f"repeated; {len(big) / 1e6:.1f} MB) decoded in {dt:.2f} s "
          f"({tex.nbytes / dt / 1e6:.1f} MB/s of pixels)", flush=True)
    if dt > RASTER_DECODE_S:
        fail(f"raster: the progressive JPEG took {dt:.1f} s > "
             f"{RASTER_DECODE_S} s")
    inner = slice(1, band - 1)
    for r in range(RASTER_H // band):
        k = r % kinds
        if not np.array_equal(tex[r * band:(r + 1) * band][inner],
                              strip[k * band:(k + 1) * band][inner]):
            fail(f"raster: band {r} of the progressive JPEG is not the "
                 f"strip's band {k}")
    peak = dec.run(path, "terrain_tpu_torch.data.jpeg", "decode_jpeg",
                   limit_s=300)
    print(f"raster [{card}]: in the phase's decode process the decode took "
          f"{peak['times'][0]:.2f} s and its peak host memory was "
          f"{peak['peak'] / 1e6:.1f} MB above the process's before it "
          f"({peak['samples']} samples of VmRSS; the output "
          f"{peak['out'] / 1e6:.1f} MB, the coefficients 699.8 MB)",
          flush=True)
    it = RasterCropIterator(hm, tex, TRAIN_BATCH, crop=512,
                            epoch_size=RASTER_CROPS, seed=0)
    x, y = it.next_uint8()
    px, py = _plain_crops(np, hm, tex, TRAIN_BATCH, 512, 0)
    if not (np.array_equal(x, px) and np.array_equal(y, py)):
        fail("raster: the progressive texture's first batch is not the "
             "plain slices of the decoded pair")
    os.remove(path)


def _raster_fixtures(card):
    """Every committed TIFF, PNG, BMP, WebP, PNM, TGA, JPEG 2000, PFM/PAM,
    Radiance, Sun raster, DDS, SGI, PCX, QOI, IM, ICO, ICNS and MPO fixture
    decoded to imageio's digests (shape, dtype, SHA-256): its bytes by the
    format's decoder (as imageio decodes bytes: through Pillow, or OpenCV
    where Pillow cannot open them), and its path by data/raster.py (as
    imageio reads a path: a *.tif through its tifffile plugin; a *.pbm,
    *.pfm, *.hdr or *.sr through OpenCV); where imageio raises on the bytes
    or the path, the exception the digests name.  Returns the decoded TIFF
    strips by name."""
    import builtins
    import hashlib
    import struct

    from terrain_tpu_torch.data import icns, ico, im, pcx, qoi, sgi
    from terrain_tpu_torch.data.bmp import decode_bmp
    from terrain_tpu_torch.data.dds import decode_dds
    from terrain_tpu_torch.data.hdr import decode_hdr
    from terrain_tpu_torch.data.jp2 import decode_jp2
    from terrain_tpu_torch.data.jpeg import decode_jpeg
    from terrain_tpu_torch.data.pnm import decode_pnm
    from terrain_tpu_torch.data.sun import decode_sun
    from terrain_tpu_torch.data.raster import read_raster
    from terrain_tpu_torch.data.tga import decode_tga
    from terrain_tpu_torch.data.tiff import decode_tiff
    from terrain_tpu_torch.data.webp import decode_webp
    from terrain_tpu_torch.serve.png import read_png

    def same(img, want):
        return [list(img.shape), str(img.dtype),
                hashlib.sha256(img.tobytes()).hexdigest()] == [
                    want["shape"], want["dtype"], want["sha256"]]

    def exc(name):  # the digests name struct.error or a built-in class
        return struct.error if name == "struct.error" else getattr(
            builtins, name)

    decode = {"tiff": decode_tiff, "png": read_png, "bmp": decode_bmp,
              "webp": decode_webp, "pnm": decode_pnm, "tga": decode_tga,
              "jp2": decode_jp2, "pfm_pam": decode_pnm, "hdr": decode_hdr,
              "sun": decode_sun, "dds": decode_dds, "sgi": sgi.decode_sgi,
              "pcx": pcx.decode_pcx, "qoi": qoi.decode_qoi,
              "im": im.decode_im, "ico": ico.decode_ico,
              "icns": icns.decode_icns, "mpo": decode_jpeg}
    strips, counts, t_all = {}, {}, 0.0
    for kind in RASTER_FIXTURE_DIRS:
        d = os.path.join(HERE, "tests", "data", kind)
        with open(os.path.join(d, "digests.json")) as f:
            digests = json.load(f)
        for name, want in digests.items():
            if name == "reference":  # the Pillow, imageio, libtiff versions
                continue
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                data = f.read()
            refused = [(read, want["refused"]) for read in (
                lambda: decode[kind](data), lambda: read_raster(path))
                ] if "refused" in want else []
            if "path_refused" in want:
                refused = [(lambda: read_raster(path), want["path_refused"])]
            for read, words in refused:  # refused by name
                try:
                    read()
                    fail(f"raster: {kind}/{name} was decoded")
                except NotImplementedError as e:
                    if words not in str(e):
                        fail(f"raster: {kind}/{name} refused as {e}")
            if "refused" in want:
                counts["refused"] = counts.get("refused", 0) + 1
                continue
            t0 = time.perf_counter()
            if "error" in want:  # imageio raises on its bytes
                try:
                    decode[kind](data)
                    fail(f"raster: {kind}/{name} decoded where imageio "
                         f"raises")
                except exc(want["error"]):
                    pass
            else:
                img = decode[kind](data)
                if not same(img, want):
                    fail(f"raster: {kind}/{name} decoded to {img.shape} "
                         f"{img.dtype}, not imageio's {want['shape']} "
                         f"{want['dtype']} (or other bytes)")
            t_all += time.perf_counter() - t0
            by_path = want.get("path", want)
            if by_path is None or "path_refused" in want:
                pass
            elif "error" in by_path:  # imageio raises on the path
                try:
                    read_raster(path)
                    fail(f"raster: {kind}/{name} read by its path where "
                         f"imageio raises")
                except exc(by_path["error"]):
                    pass
            elif not same(read_raster(path), by_path):
                fail(f"raster: {kind}/{name} read by its path is not "
                     f"imageio's {by_path['shape']} {by_path['dtype']}")
            if name.startswith("strip_"):
                strips[name] = img
            counts[kind] = counts.get(kind, 0) + 1
    print(f"raster [{card}]: {counts} fixtures (every PNG, TIFF, BMP, WebP, "
          f"PNM, TGA, JPEG 2000, PFM, PAM, Radiance, Sun raster, DDS, SGI, "
          f"PCX, QOI, IM, ICO, ICNS and MPO variant the port takes, an "
          f"animated WebP's first frame; where imageio raises, the port "
          f"too, with imageio's exception for the last seven) decoded to "
          f"imageio's shapes, "
          f"dtypes and "
          f"SHA-256 in {t_all:.2f} s, from their bytes and from their "
          f"paths; the refused ones refused by name", flush=True)
    return strips


def _tiff_repeat(data, height):
    """A TIFF strip file (strips of equal rows) as one of `height` rows: its
    compressed strips once, and a fresh IFD (every tag of the strip's,
    ImageLength patched) whose StripOffsets point at them in turn.
    Returns the bytes, the rows of a strip and the strips of the file."""
    import struct

    from terrain_tpu_torch.data.tiff import _ifd

    bo, tags = _ifd(data)
    rps = tags[278][0]
    offs, counts = tags[273], tags[279]
    out = bytearray(b"II*\x00" if bo == "<" else b"MM\x00*") + bytes(4)
    at = []
    for o, n in zip(offs, counts):
        at.append(len(out))
        out += data[o:o + n]
    n_strips = -(-height // rps)
    tags = dict(tags)
    tags[257] = (height,)
    tags[273] = tuple(at[i % len(at)] for i in range(n_strips))
    tags[279] = tuple(counts[i % len(counts)] for i in range(n_strips))
    types = {273: 4, 279: 4, 256: 4, 257: 4, 278: 4}
    ifd = len(out) + len(out) % 2
    out += bytes(len(out) % 2)
    struct.pack_into(bo + "I", out, 4, ifd)
    keep = sorted(t for t in tags  # numbers only: no text tags
                  if all(isinstance(v, (int, float)) for v in tags[t]))
    after = ifd + 2 + 12 * len(keep) + 4
    entries, blobs = b"", b""
    for t in keep:
        typ = types.get(t, 3)
        vals = tags[t]
        if t in (282, 283):  # resolutions: RATIONAL
            typ, payload = 5, struct.pack(bo + "II", 1, 1)
            vals = (1,)
        else:
            payload = struct.pack(bo + ("I" if typ == 4 else "H") * len(vals),
                                  *[int(v) for v in vals])
        if len(payload) <= 4:
            field = payload + bytes(4 - len(payload))
        else:
            field = struct.pack(bo + "I", after + len(blobs))
            blobs += payload
        entries += struct.pack(bo + "HHI", t, typ, len(vals)) + field
    out += struct.pack(bo + "H", len(keep)) + entries + bytes(4) + blobs
    return bytes(out), rps, len(offs)


def raster_tiff(torch, card, root, dec):
    """TIFF rasters through the port's decoder: the committed TIFF, PNG and
    BMP fixtures decoded to imageio's digests; the two full-width strips
    (an LZW RGB texture with predictor 2, and 16-bit deflate heights)
    repeated into a 21600 x 10800 pair, each decoded within
    RASTER_DECODE_S (seconds, MB/s, and the texture's peak host memory in
    the decode process), every band equal to the strip's; then one epoch of
    `TERRAIN_RASTER=hm.tif,tex.tif TERRAIN_EPOCH_CROPS=16
    test1_nobn_bilin_both train` through cli.main, its first batch against
    plain slicing of the decoded pair (the heights cast to uint8 as both
    packages cast them).  Returns the epoch's launch counts."""

    import numpy as np

    from terrain_tpu_torch.data.tiff import decode_tiff

    strips = _raster_fixtures(card)
    paths, decoded = {}, {}
    for label, name in (("tex", TIFF_TEXTURE_STRIP),
                        ("hm", TIFF_HEIGHT_STRIP)):
        with open(os.path.join(HERE, "tests", "data", "tiff", name),
                  "rb") as f:
            big, rps, kinds = _tiff_repeat(f.read(), RASTER_H)
        paths[label] = os.path.join(root, f"{label}.tif")
        with open(paths[label], "wb") as f:
            f.write(big)
        t0 = time.perf_counter()
        img = decode_tiff(paths[label])
        dt = time.perf_counter() - t0
        print(f"raster [{card}]: a {RASTER_W}x{RASTER_H} TIFF {label} ("
              f"{name}'s {kinds} strips of {rps} rows repeated, "
              f"{len(big) / 1e6:.1f} MB) decoded to {img.shape} {img.dtype} "
              f"in {dt:.2f} s ({img.nbytes / dt / 1e6:.1f} MB/s of pixels)",
              flush=True)
        if dt > RASTER_DECODE_S:
            fail(f"raster: the full-size TIFF {label} took {dt:.1f} s > "
                 f"{RASTER_DECODE_S} s")
        strip = strips[name]
        for r in range(RASTER_H // rps):
            k = r % kinds
            if not np.array_equal(img[r * rps:(r + 1) * rps],
                                  strip[k * rps:(k + 1) * rps]):
                fail(f"raster: band {r} of the full-size TIFF {label} is "
                     f"not the strip's band {k}")
        decoded[label] = img
        del big
    peak = dec.run(paths["tex"], "terrain_tpu_torch.data.tiff",
                   "decode_tiff", limit_s=300)
    print(f"raster [{card}]: in the phase's decode process the TIFF "
          f"texture's decode took {peak['times'][0]:.2f} s and its peak host "
          f"memory was "
          f"{peak['peak'] / 1e6:.1f} MB above the process's before it "
          f"({peak['samples']} samples of VmRSS; the output "
          f"{peak['out'] / 1e6:.1f} MB)", flush=True)
    got, wall, row = _raster_epoch(
        torch, np, "TIFF pair", np.asarray(decoded["hm"], np.uint8),
        decoded["tex"], [paths["hm"], paths["tex"]], root, EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=hm.tif,tex.tif "
          f"TERRAIN_EPOCH_CROPS={EPOCH_CROPS} {EXPERIMENT} train` "
          f"(21600x10800 16-bit deflate heights + LZW texture): {wall:.1f} s "
          f"in all (both decoded again), epoch {float(row['time']):.3f} s; "
          f"the first batch equals plain slicing; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got


def raster_webp(torch, card, root):
    """WebP rasters through the port's decoder: the committed 1024 x 640
    pair (lossless heights with ocean zeros, a q90 lossy texture) decoded
    from its bytes (the best of 3 timed: s and MP/s each), the crop
    iterator's first batch against plain slicing, then one epoch of
    `TERRAIN_RASTER=hm.webp,tex.webp TERRAIN_EPOCH_CROPS=16
    test1_nobn_bilin_both train` through cli.main: finite losses and the
    train steps' launches of every kernel.  Returns the epoch's counts."""
    import math

    import numpy as np

    from terrain_tpu_torch.data.webp import decode_webp

    d = os.path.join(HERE, "tests", "data", "webp")
    paths, decoded = {}, {}
    for label, name in zip(("hm", "tex"), WEBP_PAIR):
        paths[label] = os.path.join(d, name)
        with open(paths[label], "rb") as f:
            data = f.read()
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            img = decode_webp(data)
            best = min(best, time.perf_counter() - t0)
        mp = img.shape[0] * img.shape[1] / 1e6
        print(f"raster [{card}]: the WebP {label} {name} ({len(data)} "
              f"bytes) decoded to {img.shape} {img.dtype} in {best:.4f} s "
              f"(best of 3): {mp / best:.1f} MP/s on the host", flush=True)
        decoded[label] = img
    got, wall, row = _raster_epoch(
        torch, np, "WebP pair", decoded["hm"][..., 0], decoded["tex"],
        [paths["hm"], paths["tex"]], root, EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=hm.webp,tex.webp "
          f"TERRAIN_EPOCH_CROPS={EPOCH_CROPS} {EXPERIMENT} train` (1024x640 "
          f"lossless heights + q90 texture): {wall:.1f} s in all (both "
          f"decoded again), epoch {float(row['time']):.3f} s; the first "
          f"batch equals plain slicing; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got


def _jp2_repeat(data, height, width):
    """A one-tile JPEG 2000 file (a JP2 box or a bare codestream) as a
    codestream of `height` x `width` made of that tile: its main header
    with a new SIZ (the image `height` x `width` at the origin, tiles of
    the lone tile's size at the origin), then its one tile-part repeated,
    Isot counting the tiles, and EOC.  Every repeated tile decodes as the
    lone tile does: the tile is a power of two no smaller than 2^levels,
    so every tile origin is a multiple of 2^levels (the same filter
    parities at every level) and each band's origin a multiple of its
    code-block size or of its own width within one code-block (the same
    code-block partition), and with the default precincts (2^15, larger
    than the image) every resolution is one precinct in every tile.  It
    checks these.  Returns the bytes and the tile count."""
    import struct

    at = data.find(b"jp2c")
    cs = data[at + 4:] if data[:2] != b"\xffO" else data
    p, segs = 2, []
    while True:
        m, n = struct.unpack(">HH", cs[p:p + 4])
        if m == 0xFF90:
            break
        segs.append((m, cs[p + 4:p + 2 + n]))
        p += 2 + n
    siz = dict(segs)[0xFF51]
    cod = dict(segs)[0xFF52]
    x1, y1, x0, y0, tw, th, tx0, ty0 = struct.unpack(">8I", siz[2:34])
    levels = cod[5]
    if (x0, y0, tx0, ty0) != (0, 0, 0, 0) or (tw, th) != (x1, y1) or \
            tw != th or tw & (tw - 1) or tw < 1 << levels or cod[0] & 1 or \
            height % th or width % tw or max(height, width) > 1 << 15:
        fail(f"raster: the JPEG 2000 tile is not one tile of a power of two "
             f"at the origin with default precincts ({x1}x{y1}, tiles "
             f"{tw}x{th}, {levels} levels, Scod {cod[0]})")
    isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[p + 4:p + 12])
    part = cs[p + 12:p + psot]
    if isot or tpsot or tnsot != 1 or cs[p + psot:p + psot + 2] != \
            b"\xff\xd9":
        fail("raster: the JPEG 2000 tile is not one tile-part then EOC")
    siz = siz[:2] + struct.pack(">8I", width, height, 0, 0, tw, th, 0, 0) \
        + siz[34:]
    n_tiles = (height // th) * (width // tw)
    out = bytearray(b"\xff\x4f")
    for m, x in segs:
        out += struct.pack(">HH", m, len(x) + 2) + (siz if m == 0xFF51 else x)
    for k in range(n_tiles):
        out += struct.pack(">HHHIBB", 0xFF90, 10, k, psot, 0, 1) + part
    out += b"\xff\xd9"
    return bytes(out), n_tiles


def raster_jp2(torch, card, root, dec):
    """JPEG 2000 rasters through the port's decoder (the committed fixtures
    are held to imageio's digests with the others, _raster_fixtures): the
    two committed 1024 x 1024 tiles (JP2_TILES: 16-bit lossless heights,
    5/3 with five levels; an RGB 9/7 texture with the ICT and three quality
    layers) each repeated into a JP2_H x JP2_W codestream (_jp2_repeat)
    and, in the decode process (_DecodeProcess), decoded from its bytes
    JP2_RUNS times (the best: s and MP/s) with its peak host memory
    sampled, every
    tile of the decode equal to the lone tile's; then one epoch of
    `TERRAIN_RASTER=<heights>.jp2,<texture>.jp2 TERRAIN_EPOCH_CROPS=16
    test1_nobn_bilin_both train` from the two tiles through cli.main: the
    first batch against plain slicing (the heights cast to uint8 as both
    packages cast them), finite losses and the train steps' launches of
    every kernel.  Returns the epoch's counts."""
    import numpy as np

    from terrain_tpu_torch.data.jp2 import decode_jp2

    d = os.path.join(HERE, "tests", "data", "jp2")
    paths, tiles = {}, {}
    for label, name in zip(("hm", "tex"), JP2_TILES):
        paths[label] = os.path.join(d, name)
        with open(paths[label], "rb") as f:
            data = f.read()
        tiles[label] = decode_jp2(data)
        big, n_tiles = _jp2_repeat(data, JP2_H, JP2_W)
        path = os.path.join(root, f"{label}_{JP2_W}x{JP2_H}.j2k")
        with open(path, "wb") as f:
            f.write(big)
        runs = dec.run(path, "terrain_tpu_torch.data.jp2", "decode_jp2",
                       lib="terrain_tpu_torch.data.jp2",
                       tile_path=paths[label], runs=JP2_RUNS)
        if not runs["equal"] or runs["cells"] != n_tiles:
            fail(f"raster: a tile of the {JP2_W}x{JP2_H} JPEG 2000 {label} "
                 f"is not the lone tile's decode")
        best = min(runs["times"])
        mp = JP2_H * JP2_W / 1e6
        print(f"raster [{card}]: a {JP2_W}x{JP2_H} JPEG 2000 {label} ({name}'s"
              f" tile-part repeated {n_tiles} times, {len(big) / 1e6:.1f} MB) "
              f"decoded to {tiles[label].dtype} in the decode process in "
              f"{best:.3f} s (best of {len(runs['times'])}: "
              f"{', '.join(f'{t:.3f}' for t in runs['times'])}): "
              f"{mp / best:.1f} MP/s on the host, every tile the lone tile's "
              f"decode; peak host memory {runs['peak'] / 1e6:.1f} MB above "
              f"the process's after reading the codestream "
              f"({runs['samples']} samples of VmRSS; the output "
              f"{runs['out'] / 1e6:.1f} MB)", flush=True)
        del big
    got, wall, row = _raster_epoch(
        torch, np, "JPEG 2000 pair", np.asarray(tiles["hm"], np.uint8),
        tiles["tex"], [paths["hm"], paths["tex"]], root, EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=<heights>.jp2,<texture>.jp2 "
          f"TERRAIN_EPOCH_CROPS={EPOCH_CROPS} {EXPERIMENT} train` (the two "
          f"1024x1024 tiles: 16-bit 5/3 heights + 9/7 texture): {wall:.1f} s "
          f"in all (both decoded again), epoch {float(row['time']):.3f} s; "
          f"the first batch equals plain slicing; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got


def _dds_repeat(data, height, width):
    """A one-surface DDS of block-compressed 1024 x 1024 texels (a legacy
    or DX10 header, then 256 x 256 blocks) as one of `height` x `width`
    whose block rows and columns repeat the tile's (blocks decode alone,
    so every 1024 x 1024 cell of the decode, and the edge cells' corners,
    are the tile's decode).  Returns the bytes."""
    import struct

    import numpy as np

    head = bytearray(data[:148 if data[84:88] == b"DX10" else 128])
    size = (len(data) - len(head)) // (256 * 256)
    if size not in (8, 16) or len(head) + 256 * 256 * size != len(data):
        fail("raster: the DDS tile is not one 1024 x 1024 surface of "
             "blocks")
    tile = np.frombuffer(data, np.uint8, 256 * 256 * size,
                         len(head)).reshape(256, 256, size)
    by, bx = -(-height // 4), -(-width // 4)
    rows = np.tile(tile, (1, -(-bx // 256), 1))[:, :bx]
    struct.pack_into("<2I", head, 12, height, width)
    return bytes(head) + np.tile(rows, (-(-by // 256), 1, 1))[:by].tobytes()


def raster_float_dds(torch, card, root, dec):
    """Float heights and block-compressed textures through the port's
    decoders (the committed PFM, PAM, Radiance, Sun raster and DDS
    fixtures are held to imageio's digests with the others,
    _raster_fixtures): a RASTER_W x RASTER_H Pf file of seeded heights
    k / 2 (k in 0..600, so 0-300 m with a .5 tie in every other value),
    decoded as imageio reads a *.pfm path (OpenCV: rounded half to even,
    saturated at 255) and held to plain numpy (np.rint, np.clip) of the
    same values; the two committed DDS tiles (DDS_TILES: Pillow's DXT1 of
    a terrain texture, random BC7 blocks of every mode) each repeated
    block row by block row into a RASTER_W x RASTER_H texture
    (_dds_repeat), every 1024 x 1024 cell of its decode the lone tile's;
    each decoded three times in the decode process (_DecodeProcess: the
    best s and MP/s, the peak host MB); then one epoch of
    `TERRAIN_RASTER=<heights>.pfm,<texture>.dds TERRAIN_EPOCH_CROPS=16
    test1_nobn_bilin_both train` from a 1024 x 1024 Pf of the same heights
    and the DXT1 tile through cli.main: the first batch against plain
    slicing, finite losses and the train steps' launches of every kernel.
    Returns the epoch's counts."""
    import numpy as np

    from terrain_tpu_torch.data.dds import decode_dds
    from terrain_tpu_torch.data.pnm import decode_pfm_cv

    mp = RASTER_H * RASTER_W / 1e6

    def report(label, what, size_mb, runs):
        best = min(runs["times"])
        print(f"raster [{card}]: a {RASTER_W}x{RASTER_H} {label} ({what}, "
              f"{size_mb:.1f} MB) decoded in the decode process in "
              f"{best:.3f} s "
              f"(best of 3: {', '.join(f'{t:.3f}' for t in runs['times'])}): "
              f"{mp / best:.1f} MP/s on the host; peak host memory "
              f"{runs['peak'] / 1e6:.1f} MB above the process's after "
              f"reading the file ({runs['samples']} samples of VmRSS; the "
              f"output {runs['out'] / 1e6:.1f} MB)", flush=True)

    t0 = time.perf_counter()
    k = np.random.default_rng(0).integers(0, 601, (RASTER_H, RASTER_W),
                                          dtype=np.uint16)
    heights = k.astype(np.float32) * np.float32(0.5)
    del k
    hm_path = os.path.join(root, f"heights_{RASTER_W}x{RASTER_H}.pfm")
    with open(hm_path, "wb") as f:  # rows bottom-up, little-endian
        f.write(b"Pf\n%d %d\n-1.0\n" % (RASTER_W, RASTER_H))
        for r in range(RASTER_H - 1, -1, -1024):
            f.write(heights[max(r - 1023, 0):r + 1][::-1].astype(
                "<f4").tobytes())
    plain = np.clip(np.rint(heights), 0, 255).astype(np.uint8)
    plain_path = os.path.join(root, "heights_plain.npy")
    np.save(plain_path, plain)
    small = heights[:1024, :1024].copy()
    del heights, plain
    print(f"raster: wrote the {RASTER_W}x{RASTER_H} Pf heights "
          f"({os.path.getsize(hm_path) / 1e6:.1f} MB) and their plain "
          f"reading in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = dec.run(hm_path, "terrain_tpu_torch.data.pnm", "decode_pfm_cv",
                   lib="terrain_tpu_torch.data.tiff", plain=plain_path,
                   runs=3)
    if not runs["equal"]:
        fail("raster: the PFM heights are not the plain reading of their "
             "values (rint, clip to 0-255)")
    report("PFM heights", "float32, rounded half to even and saturated as "
           "OpenCV reads a *.pfm path, equal to plain numpy",
           os.path.getsize(hm_path) / 1e6, runs)
    os.remove(hm_path)
    os.remove(plain_path)
    d = os.path.join(HERE, "tests", "data", "dds")
    tiles = {}
    for name in DDS_TILES:
        tile_path = os.path.join(d, name)
        with open(tile_path, "rb") as f:
            data = f.read()
        tiles[name] = decode_dds(data)
        big = _dds_repeat(data, RASTER_H, RASTER_W)
        path = os.path.join(root, f"texture_{RASTER_W}x{RASTER_H}.dds")
        with open(path, "wb") as f:
            f.write(big)
        runs = dec.run(path, "terrain_tpu_torch.data.dds", "decode_dds",
                       lib="terrain_tpu_torch.data.tiff", tile_path=tile_path,
                       runs=3)
        if not runs["equal"]:
            fail(f"raster: a cell of the {RASTER_W}x{RASTER_H} DDS from "
                 f"{name} is not the lone tile's decode")
        report(f"DDS texture from {name}", f"{runs['cells']} cells of 1024, "
               f"each the lone tile's decode", len(big) / 1e6, runs)
        os.remove(path)
        del big
    hp = os.path.join(root, "heights_1024.pfm")
    with open(hp, "wb") as f:
        f.write(b"Pf\n%d %d\n-1.0\n" % small.shape[::-1] + small[
            ::-1].astype("<f4").tobytes())
    with open(hp, "rb") as f:
        hm = decode_pfm_cv(f.read())
    tex = tiles[DDS_TILES[0]][..., :3]
    tp = os.path.join(d, DDS_TILES[0])
    got, wall, row = _raster_epoch(torch, np, "PFM and DDS pair", hm, tex,
                                   [hp, tp], root, EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=<heights>.pfm,<texture>.dds "
          f"TERRAIN_EPOCH_CROPS={EPOCH_CROPS} {EXPERIMENT} train` (1024x1024 "
          f"Pf heights, the DXT1 tile): {wall:.1f} s in all (both decoded "
          f"again), epoch {float(row['time']):.3f} s; the first batch "
          f"equals plain slicing; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got


def _sgi_heights(np, h, w, seed):
    """Seeded heights (h, w) uint8, each row ocean (0) for its first z_r
    columns, then a window of a seeded run of values 1-255, and the same
    as a run-length SGI file (bpc 1, one channel): the ocean in run
    packets of up to 127, the land in copy packets of up to 127, rows
    bottom-up.  Returns (bytes, heights)."""
    import struct

    rng = np.random.default_rng(seed)
    base = rng.integers(1, 256, h + w, dtype=np.uint8)
    zs = rng.integers(0, w // 3, h)
    hm = np.lib.stride_tricks.sliding_window_view(base, w)[:h].copy()
    hm[np.arange(w)[None, :] < zs[:, None]] = 0
    land = w - zs
    lengths = (2 * -(-zs // 127) + land // 127 * 128
               + np.where(land % 127, land % 127 + 1, 0) + 1)[::-1]
    starts = 512 + 8 * h + np.concatenate([[0], np.cumsum(lengths)[:-1]])
    head = struct.pack(">hBBHHHHll", 474, 1, 1, 2, w, h, 1, 0, 255).ljust(
        512, b"\0")
    out = [head, starts.astype(">u4").tobytes(),
           lengths.astype(">u4").tobytes()]
    for r in range(h - 1, -1, -1):  # bottom row first
        z = int(zs[r])
        ocean = np.zeros((-(-z // 127), 2), np.uint8)
        ocean[:, 0] = 127
        if z % 127:
            ocean[-1, 0] = z % 127
        row = hm[r, z:]
        full, rem = divmod(w - z, 127)
        body = np.empty(full * 128 + (rem + 1 if rem else 0) + 1, np.uint8)
        blocks = body[:full * 128].reshape(full, 128)
        blocks[:, 0] = 0xFF
        blocks[:, 1:] = row[:full * 127].reshape(full, 127)
        if rem:
            body[full * 128] = 0x80 | rem
            body[full * 128 + 1:-1] = row[full * 127:]
        body[-1] = 0
        out += [ocean.tobytes(), body.tobytes()]
    return b"".join(out), hm


def _qoi_texture(np, h, w, seed, group=8):
    """A seeded RGB texture (h, w, 3) of runs of `group` pixels, and the
    same as a QOI file of QOI_OP_RGB and QOI_OP_RUN ops (3 channels, the
    end marker; w a multiple of `group`).  Returns (bytes, the runs'
    colours (h, w // group, 3))."""
    import struct

    colours = np.random.default_rng(seed).integers(
        0, 256, (h, w // group, 3), dtype=np.uint8)
    ops = np.empty((h * w // group, 5), np.uint8)
    ops[:, 0] = 0xFE
    ops[:, 1:4] = colours.reshape(-1, 3)
    ops[:, 4] = 0xC0 | (group - 2)  # the run repeats group - 1 pixels
    return (b"qoif" + struct.pack(">II", w, h) + b"\x03\x00" + ops.tobytes()
            + b"\0" * 7 + b"\1", colours)


def raster_sgi_qoi(torch, card, root, dec):
    """SGI heights and a QOI texture through the port's decoders (the
    committed SGI, PCX, QOI, IM, ICO, ICNS and MPO fixtures are held to
    imageio's digests with the others, _raster_fixtures): a RASTER_W x
    RASTER_H run-length SGI of seeded heights (_sgi_heights) and a QOI
    texture of seeded 8-pixel runs (_qoi_texture), each decoded once in
    the decode process (s, MP/s, peak host MB) and held to its seeded
    array; then one epoch of `TERRAIN_RASTER=<heights>.sgi,<texture>.qoi
    TERRAIN_EPOCH_CROPS=SQ_EPOCH_CROPS test1_nobn_bilin_both train` from
    SQ_W x SQ_H versions through cli.main: the first batch against plain
    slicing, finite losses and the train steps' launches of every kernel.
    Returns the epoch's counts."""
    import numpy as np

    from terrain_tpu_torch.data.qoi import decode_qoi
    from terrain_tpu_torch.data.sgi import decode_sgi

    mp = RASTER_H * RASTER_W / 1e6
    for label, make, module, decode, repeat in (
            ("SGI heights", _sgi_heights, "terrain_tpu_torch.data.sgi",
             "decode_sgi", 1),
            ("QOI texture", _qoi_texture, "terrain_tpu_torch.data.qoi",
             "decode_qoi", 8)):
        t0 = time.perf_counter()
        data, plain = make(np, RASTER_H, RASTER_W, 25)
        ext = module.rsplit(".", 1)[1]
        path = os.path.join(root, f"{RASTER_W}x{RASTER_H}.{ext}")
        plain_path = os.path.join(root, f"{ext}_plain.npy")
        with open(path, "wb") as f:
            f.write(data)
        np.save(plain_path, plain)
        size_mb = len(data) / 1e6
        del data, plain
        t_make = time.perf_counter() - t0
        runs = dec.run(path, module, decode, lib="terrain_tpu_torch.data.tiff",
                       plain=plain_path, repeat=repeat)
        if not runs["equal"]:
            fail(f"raster: the {RASTER_W}x{RASTER_H} {label} did not decode "
                 f"to its seeded array")
        dt = runs["times"][0]
        print(f"raster [{card}]: a {RASTER_W}x{RASTER_H} {label} ({size_mb:.1f} "
              f"MB, made and written in {t_make:.1f} s) decoded once in the "
              f"decode process in {dt:.3f} s: {mp / dt:.1f} MP/s on the "
              f"host, equal to its seeded array; peak host memory "
              f"{runs['peak'] / 1e6:.1f} MB above the process's after "
              f"reading the file ({runs['samples']} samples of VmRSS; the "
              f"output {runs['out'] / 1e6:.1f} MB)", flush=True)
        os.remove(path)
        os.remove(plain_path)
    data, _ = _sgi_heights(np, SQ_H, SQ_W, 26)
    hp = os.path.join(root, "heights.sgi")
    with open(hp, "wb") as f:
        f.write(data)
    hm = decode_sgi(data)
    data, _ = _qoi_texture(np, SQ_H, SQ_W, 27)
    tp = os.path.join(root, "texture.qoi")
    with open(tp, "wb") as f:
        f.write(data)
    tex = decode_qoi(data)
    got, wall, row = _raster_epoch(torch, np, "SGI and QOI pair", hm, tex,
                                   [hp, tp], root, SQ_EPOCH_CROPS)
    print(f"raster [{card}]: `TERRAIN_RASTER=<heights>.sgi,<texture>.qoi "
          f"TERRAIN_EPOCH_CROPS={SQ_EPOCH_CROPS} {EXPERIMENT} train` "
          f"({SQ_W}x{SQ_H} run-length SGI heights, a QOI texture): {wall:.1f} "
          f"s in all (both decoded again), epoch {float(row['time']):.3f} s; "
          f"the first batch equals plain slicing; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got


# ----------------------------------------------------------------- inputs
def _blocked_libraries(phase="inputs"):
    """Make h5py, imageio and PIL unimportable in this process (an import
    of a name that sys.modules maps to None raises ImportError); fails if
    one is already imported."""
    for name in BLOCKED:
        if name in sys.modules and sys.modules[name] is not None:
            fail(f"{phase}: {name} was imported before the phase began")
        sys.modules[name] = None


def _h5_fixtures(np, card):
    """The committed h5py files (tests/make_h5_fixtures.py: both libvers,
    contiguous and gzip-chunked, and one file for each of layout version
    4's five chunk indices) read by the port's reader to their digests;
    the gzip-chunked file's read rate (median of 20 reads)."""
    import hashlib

    from terrain_tpu_torch.data import h5

    with open(os.path.join(HERE, H5_DIR, "digests.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        if name == "reference":
            continue
        path = os.path.join(HERE, H5_DIR, name)
        with h5.File(path) as f:
            for k, w in want.items():
                a = np.ascontiguousarray(f[k])
                if (list(a.shape) != w["shape"] or str(a.dtype) != w["dtype"]
                        or hashlib.sha256(a.tobytes()).hexdigest()
                        != w["sha256"]):
                    fail(f"inputs: {name}/{k} is not h5py's array")
        print(f"inputs: {name}: the port's reader gives h5py's arrays "
              f"({', '.join(sorted(want))})", flush=True)
    path = os.path.join(HERE, H5_DIR, H5_GZIP)
    times, nbytes = [], 0
    for _ in range(20):
        t0 = time.perf_counter()
        with h5.File(path) as f:
            nbytes = sum(np.asarray(f[k]).nbytes for k in f.keys())
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"inputs [{card}]: {H5_GZIP} (gzip + shuffle chunks, a pair a "
          f"chunk, fletcher32 on yt) read in {dt * 1e3:.3f} ms, "
          f"{nbytes / dt / 1e6:.1f} MB/s of arrays (median of 20 reads, "
          f"warm)", flush=True)


def _h5_pairs(np, card, path):
    """INPUTS_N + 4 synthetic pairs at 512px (the arrays TERRAIN_SYNTHETIC=1
    TERRAIN_N=INPUTS_N makes) streamed row by row into an h5 by the port's
    writer, read back (memmaps) equal; returns the arrays."""
    from terrain_tpu_torch.data import h5
    from terrain_tpu_torch.data.synthetic import make_pairs

    xt, yt = make_pairs(INPUTS_N, 512, seed=0)
    xv, yv = make_pairs(max(INPUTS_N // 10, 4), 512, seed=1)
    arrays = {"xt": xt, "yt": yt, "xv": xv, "yv": yv}
    t0 = time.perf_counter()
    maps = h5.create(path, {k: (a.shape, a.dtype) for k, a in arrays.items()})
    for k, a in arrays.items():
        for i in range(len(a)):
            maps[k][i] = a[i]
        maps[k].flush()
    del maps
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    with h5.File(path) as f:
        back = {k: np.array(f[k]) for k in f.keys()}
    t_read = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in arrays.values())
    if sorted(back) != sorted(arrays) or not all(
            np.array_equal(back[k], a) for k, a in arrays.items()):
        fail("inputs: the written h5 reads back as other arrays")
    print(f"inputs [{card}]: {INPUTS_N}+{len(xv)} pairs at 512px "
          f"({nbytes / 1e6:.1f} MB) streamed into an h5 row by row in "
          f"{t_write:.3f} s; read back through the memmaps in {t_read:.3f} s "
          f"({nbytes / t_read / 1e6:.1f} MB/s, warm), equal", flush=True)
    return arrays


def _epoch(torch, card, label, env, root, n=None):
    """One epoch of `EXPERIMENT train` through cli.main under `env`, the
    default path (switches off), of `n` train pairs (TERRAIN_N, else
    INPUTS_N): (launch counts, losses, epoch s)."""
    import math

    import numpy as np

    from terrain_tpu_torch import cli
    from terrain_tpu_torch.train.losses import TRAIN_KEYS

    out = os.path.join(root, f"out_{label}")
    keep = {"TERRAIN_EPOCHS": "1", "TERRAIN_SAVE_EVERY": "10",
            "TERRAIN_ARTIFACT_EVERY": "1000", "TERRAIN_OUT": out,
            "TERRAIN_MODELS": os.path.join(root, f"models_{label}")}
    for k in ("TERRAIN_SYNTHETIC", "TERRAIN_FAST", "TERRAIN_N",
              "TERRAIN_DATA", "TERRAIN_RASTER", "TERRAIN_RESUME"):
        os.environ.pop(k, None)
    os.environ.update({**keep, **env})
    set_switches(False)
    # the prior Z comes from the global numpy stream (as in terrain_tpu):
    # seeded alike, two epochs of one process draw the same priors
    np.random.seed(0)
    _reset_counters()
    t0 = time.perf_counter()
    if cli.main([EXPERIMENT, "train"]) != 0:
        fail(f"inputs: the {label} epoch's CLI returned an error")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    with open(os.path.join(out, EXPERIMENT, "results.txt")) as f:
        header, *rows = [ln.split(",") for ln in f.read().splitlines()]
    if len(rows) != 1:
        fail(f"inputs: the {label} epoch's results.txt has {len(rows)} rows")
    row = dict(zip(header, rows[0]))
    losses = {f"{s}_{k}": row[f"{s}_{k}"] for s in ("train", "valid")
              for k in TRAIN_KEYS}
    if not all(math.isfinite(float(v)) for v in losses.values()):
        fail(f"inputs: a loss of the {label} epoch is not finite: {row}")
    n_train = (n or int(env.get("TERRAIN_N", INPUTS_N))) // TRAIN_BATCH
    for k, v in TRAIN_LAUNCHES.items():
        if got[k] < n_train * v:
            fail(f"inputs: {k} launched {got[k]} times in the {label} "
                 f"epoch's {n_train} train steps")
    print(f"inputs [{card}]: `{' '.join(f'{k}={v}' for k, v in env.items())}"
          f" {EXPERIMENT} train`: {wall:.1f} s in all, epoch "
          f"{float(row['time']):.3f} s; launches "
          f"{ {k: got[k] for k in TRAIN_LAUNCHES} }", flush=True)
    return got, losses, float(row["time"])


def _h5_epochs(torch, np, card, path, arrays, root):
    """The same epoch from TERRAIN_SYNTHETIC, from the h5 on the card
    (TERRAIN_FAST=1) and through the host iterator, each after
    np.random.seed(0): the h5 epochs launch the kernels as the synthetic
    one does; the device one's losses are its bits; the host iterator's
    first batch is plain slicing.  A shorter synthetic epoch first takes
    the warm-up (cuDNN's choices for the shapes), so every timed epoch is
    warm."""
    from terrain_tpu_torch.experiments import get_iterators

    env = {"TERRAIN_SYNTHETIC": "1", "TERRAIN_FAST": "1"}
    _, _, cold_s = _epoch(torch, card, "synthetic_warmup",
                          {**env, "TERRAIN_N": str(INPUTS_WARMUP_N)}, root)
    syn, syn_losses, syn_s = _epoch(torch, card, "synthetic",
                                    {**env, "TERRAIN_N": str(INPUTS_N)}, root)
    fast, fast_losses, fast_s = _epoch(
        torch, card, "h5_fast", {"TERRAIN_DATA": path, "TERRAIN_FAST": "1"},
        root)
    if fast != syn:
        fail(f"inputs: the h5 epoch launched {fast}, the synthetic one {syn}")
    if fast_losses != syn_losses:
        fail(f"inputs: the h5 epoch's losses {fast_losses} are not the "
             f"synthetic one's {syn_losses}")
    tr, _ = get_iterators(path, TRAIN_BATCH, True, False)
    slices = [slice(i, i + TRAIN_BATCH)
              for i in range(0, INPUTS_N, TRAIN_BATCH)]
    np.random.RandomState(0).shuffle(slices)
    x, y = next(tr)
    px = arrays["xt"][slices[0]].astype(np.float32) / 255.0
    py = (arrays["yt"][slices[0]].astype(np.float32) - 127.5) / 127.5
    if not (np.array_equal(x, px) and np.array_equal(y, py)):
        fail("inputs: the h5 host iterator's first batch is not plain "
             "slicing of the pairs")
    host, _, host_s = _epoch(torch, card, "h5_host", {"TERRAIN_DATA": path},
                             root)
    if host != syn:
        fail(f"inputs: the h5 host-iterator epoch launched {host}, the "
             f"synthetic one {syn}")
    print(f"inputs [{card}]: the {INPUTS_N}-pair epoch, warm: "
          f"TERRAIN_SYNTHETIC on the card {syn_s:.3f} s (after a warm-up "
          f"epoch of {INPUTS_WARMUP_N} pairs, {cold_s:.3f} s), the h5 on the "
          f"card {fast_s:.3f} s "
          f"(its losses the same bits), the h5 through the host iterator "
          f"{host_s:.3f} s (its first batch plain slicing)", flush=True)
    return {k: fast[k] + host[k] for k in fast}


def _h5_edge_epoch(torch, np, card, root):
    """The committed 512px pairs whose last rows lie in partial edge chunks
    stored unfiltered (H5_EDGE, held to h5py's digests by _h5_fixtures):
    the host iterator's first batch against plain slicing of the port's
    reading, then one epoch of `TERRAIN_DATA=<it> EXPERIMENT train`: finite
    losses and every kernel's launches in its train steps.  Returns the
    counts."""
    from terrain_tpu_torch.data import h5
    from terrain_tpu_torch.experiments import get_iterators

    path = os.path.join(HERE, H5_DIR, H5_EDGE)
    with h5.File(path) as f:
        xt, yt = np.array(f["xt"]), np.array(f["yt"])
    n = len(xt)
    tr, _ = get_iterators(path, TRAIN_BATCH, True, False)
    slices = [slice(i, i + TRAIN_BATCH) for i in range(0, n, TRAIN_BATCH)]
    np.random.RandomState(0).shuffle(slices)
    x, y = next(tr)
    if not (np.array_equal(x, xt[slices[0]].astype(np.float32) / 255.0)
            and np.array_equal(y, (yt[slices[0]].astype(np.float32) - 127.5)
                               / 127.5)):
        fail("inputs: the edge-chunk h5's first batch is not plain slicing "
             "of its pairs")
    got, _, epoch_s = _epoch(torch, card, "h5_edge", {"TERRAIN_DATA": path},
                             root, n=n)
    print(f"inputs [{card}]: {H5_EDGE} ({n} + {n // 2} pairs at 512px, the "
          f"last rows of each in an unfiltered partial edge chunk): the "
          f"first batch plain slicing, epoch {epoch_s:.3f} s", flush=True)
    return got


def _timed(card, name, fn, phase="inputs"):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    print(f"{phase} [{card}]: tool {name}: {dt:.3f} s", flush=True)
    return out


def _plain_dataset(np, hm, tex, crop, stride):
    """build_dataset's arrays by plain loops: windows at `stride` that lie
    whole in the rasters and whose heightmap is at most 90% zeros, in
    order, shuffled by RandomState(42), the first 90% for training."""
    keep = []
    for y in range(0, hm.shape[0], stride):
        for x in range(0, hm.shape[1], stride):
            h = hm[y:y + crop, x:x + crop]
            if h.shape == (crop, crop) and (h == 0).mean() <= 0.9:
                keep.append((y, x))
    order = np.random.RandomState(42).permutation(len(keep))
    n_train = int(len(keep) * 0.9)
    xs = np.stack([hm[y:y + crop, x:x + crop, None]
                   for y, x in (keep[i] for i in order)])
    ys = np.stack([tex[y:y + crop, x:x + crop]
                   for y, x in (keep[i] for i in order)])
    return {"xt": xs[:n_train], "yt": ys[:n_train], "xv": xs[n_train:],
            "yv": ys[n_train:]}


def _tools(torch, np, card, root):
    """The four port tools on small inputs, each timed and checked."""
    import contextlib
    import io

    from terrain_tpu_torch.data import h5
    from terrain_tpu_torch.data.jpeg import decode_jpeg
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.serve.png import encode_png
    from terrain_tpu_torch.tools import (
        build_dataset, compare_published, make_synthetic, pick_epoch)

    def arrays(path):
        with h5.File(path) as f:
            return {k: np.array(f[k]) for k in f.keys()}

    def quiet(fn, *args):  # the tool's own lines kept from the log
        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                return fn(*args)
        return run

    out = os.path.join(root, "syn.h5")
    _timed(card, "make_synthetic (8+2 pairs, 64px)",
           quiet(make_synthetic.main,
                 [out, "--n", "8", "--n-valid", "2", "--size", "64"]))
    got = arrays(out)
    xt, yt = make_pairs(8, 64, seed=0)
    if not (np.array_equal(got["xt"], xt) and np.array_equal(got["yt"], yt)):
        fail("inputs: make_synthetic wrote other pairs")
    # build_dataset: a PNG heightmap with ocean and the progressive texture
    with open(os.path.join(HERE, JPEG_DIR, JPEG_PTEXTURE), "rb") as f:
        tex = decode_jpeg(f.read())
    hm = _synthetic_raster(np, seed=2, size=tex.shape[:2])[0]
    hm_path = os.path.join(root, "bd_hm.png")
    with open(hm_path, "wb") as f:
        f.write(encode_png(hm, level=1))
    ds = os.path.join(root, "bd.h5")
    _timed(card, f"build_dataset ({tex.shape[1]}x{tex.shape[0]} PNG + "
           f"progressive JPEG, crop 512, stride 100)",
           quiet(build_dataset.main, [
               "--heightmap", hm_path, "--texture",
               os.path.join(HERE, JPEG_DIR, JPEG_PTEXTURE), "--crop", "512",
               "--stride", "100", "--out", ds]))
    got, want = arrays(ds), _plain_dataset(np, hm, tex, 512, 100)
    if sorted(got) != sorted(want) or not all(
            np.array_equal(got[k], want[k]) for k in want):
        fail("inputs: build_dataset's arrays are not the plain crops")
    ref = os.path.join(root, "brown.png")
    with open(ref, "wb") as f:
        f.write(encode_png(np.full((16, 16, 3), (150, 110, 70), np.uint8)))
    sub = os.path.join(root, "sub.h5")
    _timed(card, "build_dataset --subset-from (top 10)",
           quiet(build_dataset.main, [
               "--subset-from", ds, "--ref-img", ref, "--top-k", "10",
               "--out", sub]))
    d = [float(np.sum((np.array([150, 110, 70.0]) - np.mean(
        np.asarray(t, np.float64), axis=(0, 1))) ** 2)) for t in want["yt"]]
    chosen = sorted(np.argsort(d)[:10].tolist())
    got = arrays(sub)
    if not (np.array_equal(got["yt"], want["yt"][chosen])
            and np.array_equal(got["xv"], want["xt"][chosen])):
        fail("inputs: build_dataset's subset is not the 10 closest crops")
    print(f"inputs: build_dataset gives the plain crops ({len(want['xt'])} "
          f"train / {len(want['xv'])} valid) and the closest 10", flush=True)
    # pick_epoch on a run's swd.txt and checkpoints
    run_out, run_models = os.path.join(root, "run"), os.path.join(root, "ckpt")
    os.makedirs(run_out)
    os.makedirs(run_models)
    with open(os.path.join(run_out, "swd.txt"), "w") as f:
        f.write("epoch,swd_mean\n1,0.9\n2,0.3\n3,0.5\n")
    for e in (1, 3):
        open(os.path.join(run_models, f"{e}.model"), "wb").close()
    buf = io.StringIO()

    def pick():
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            return pick_epoch.main([run_out, run_models])

    rc = _timed(card, "pick_epoch", pick)
    if rc != 0 or buf.getvalue().strip() != os.path.join(run_models,
                                                         "3.model"):
        fail(f"inputs: pick_epoch said {buf.getvalue()!r} (rc {rc})")
    with contextlib.redirect_stderr(io.StringIO()):
        if pick_epoch.main([root, run_models]) != 1:
            fail("inputs: pick_epoch found a pick without swd.txt")
    # compare_published on the card and on the CPU
    dirs = {}
    for label, n, seed in (("ref", 20, 0), ("gen", 8, 1)):
        d = os.path.join(root, label)
        os.makedirs(d)
        rnd = np.random.RandomState(seed)
        for i in range(n):
            low = rnd.rand(64, 64)
            img = (np.kron(low, np.ones((8, 8))) * 200
                   + rnd.rand(512, 512) * 50).astype(np.uint8)
            with open(os.path.join(d, f"{i}.png"), "wb") as f:
                f.write(encode_png(np.repeat(img[..., None], 3, -1), level=1))
        dirs[label] = d
    rows = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()

        def compare():
            with contextlib.redirect_stdout(buf):
                return compare_published.main([
                    dirs["gen"], "--ref-dir", dirs["ref"], "--scale", "256",
                    "--real-h5", ds, "--device", device])

        _timed(card, f"compare_published ({device}; 20 + 8 512px PNGs at "
               f"256px, --real-h5)", compare)
        rows[device] = [ln for ln in buf.getvalue().splitlines()
                        if not ln.startswith("#")]
    if len(rows["cuda"]) != 5:
        fail(f"inputs: compare_published printed {rows['cuda']}")
    for a, b in zip(rows["cuda"], rows["cpu"]):
        va, vb = (np.array([float(v) for v in re.findall(
            r"-?\d+\.\d+", r[r.index("swd_mean="):])]) for r in (a, b))
        # printed to 4 decimals: each side rounds by up to 0.5e-4
        if len(va) != 7 or not np.isfinite(va).all() or (
                np.abs(va - vb) > SWD_TOL * np.abs(vb) + 1e-4).any():
            fail(f"inputs: compare_published's card row {a!r} is not the "
                 f"CPU's {b!r}")
    print("inputs: compare_published's rows on the card equal the CPU's "
          "(4 decimals):\n  " + "\n  ".join(rows["cuda"]), flush=True)


def _importer(torch, np, card, root):
    """The reference-weights importer at full width: a seeded flagship
    exported to a reference payload, written as the reference writes it
    (a gzip-pickle at protocol 2), imported into a model of another seed
    through the tool's CLI (a terrain_tpu/v1 checkpoint) and loaded back;
    every tensor and one generate request served from each bit-equal."""
    import gzip
    import pickle

    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.sample.samplers import TwoStagePipeline
    from terrain_tpu_torch.serve import TerrainClient, TerrainServer
    from terrain_tpu_torch.tools import import_reference_weights as tool

    t0 = time.perf_counter()
    # seed 1: the CLI builds its model with seed 0, so the import changes
    # every weight
    src, _ = build_gan(EXPERIMENT, "cuda", seed=1, verbose=False)
    payload = tool.export_from_model(src)
    ref = os.path.join(root, "reference.model")
    with gzip.open(ref, "wb", compresslevel=0) as f:  # stored: the format
        # is gzip either way, and deflating 253 MB took ~15-19 s
        pickle.dump(payload, f, protocol=2)
    out = os.path.join(root, "imported.model")
    if tool.main([ref, out, "--experiment", EXPERIMENT]) != 0:
        fail("inputs: the importer's CLI returned an error")
    dst, _ = build_gan(EXPERIMENT, "cuda", seed=2, verbose=False)
    dst.load_model(out)
    n = 0
    for name, net in src.nets.items():
        theirs = dst.nets[name].state_dict()
        for k, v in net.state_dict().items():
            if not torch.equal(v, theirs[k]):
                fail(f"inputs: the imported {name}.{k} is not the original")
            n += 1
    t_import = time.perf_counter() - t0
    answers = []
    for gan in (src, dst):
        pipe = TwoStagePipeline(gan.nets["dcgan_gen"], gan.nets["p2p_gen"],
                                latent_dim=gan.latent_dim,
                                in_shp=gan.in_shp, device="cuda",
                                compute_dtype=torch.float32)
        server = TerrainServer(pipe, port=0, max_batch=1).start_background()
        try:
            with TerrainClient(server.host, server.port) as cl:
                answers.append(cl.generate(1, seed=11))
        finally:
            server.shutdown()
    (h0, t0_), (h1, t1) = answers
    if not (np.array_equal(h0, h1) and np.array_equal(t0_, t1)):
        fail("inputs: the imported model's generate request differs")
    print(f"inputs [{card}]: the importer round trip of {EXPERIMENT} "
          f"({sum(len(p) for p in payload['dcgan'].values()) + sum(len(p) for p in payload['p2p'].values())} "
          f"reference arrays, {os.path.getsize(ref) / 1e6:.1f} MB pickle): "
          f"{n} tensors bit-equal after export, pickle, the CLI's import "
          f"and checkpoint, in {t_import:.1f} s; one generate request from "
          f"each model bit-equal ({h0.shape} heightmap, {t0_.shape} "
          f"texture)", flush=True)


def inputs_child(torch, root):
    """`chip_smoke.py _inputs <dir>`: the inputs phase in a process where
    h5py, imageio and PIL cannot be imported.  Writes its epochs' launch
    counts to <dir>/inputs.json."""
    import numpy as np

    from terrain_tpu_torch.device import strict_fp32

    _blocked_libraries()
    strict_fp32()
    card = card_line()
    _h5_fixtures(np, card)
    path = os.path.join(root, "pairs.h5")
    arrays = _h5_pairs(np, card, path)
    launches = _h5_epochs(torch, np, card, path, arrays, root)
    edge = _h5_edge_epoch(torch, np, card, root)
    launches = {k: launches[k] + edge[k] for k in launches}
    _tools(torch, np, card, root)
    _importer(torch, np, card, root)
    with open(os.path.join(root, "inputs.json"), "w") as f:
        json.dump(launches, f)
    return 0


def inputs_slice(torch, card):
    """The inputs phase (h5 files without h5py, the port's tools) in a
    child process with h5py, imageio and PIL unimportable; returns the
    launch counts of its two h5 epochs."""
    import tempfile

    root = tempfile.mkdtemp(prefix="inputs_")
    try:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "_inputs", root], capture_output=True, text=True,
                           timeout=INPUTS_LIMIT_S)
        print(p.stdout, end="", flush=True)
        if p.returncode != 0:
            fail(f"inputs: the child failed (rc {p.returncode}):\n"
                 f"{p.stderr[-3000:]}")
        with open(os.path.join(root, "inputs.json")) as f:
            launches = json.load(f)
        print(f"inputs: the phase's process took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ----------------------------------------------------------------- phase 7c
def _gif_fixtures(np, card):
    """The committed clips of tests/data/gif through the port's GIF writer
    and reader: imageio's frame counts, durations, loop and size; the gray
    and 60-colour clips' frames bit-equal to imageio's decodes; every
    full-colour frame within 1.10 x Pillow's mean error + 0.25."""
    import hashlib
    import importlib.util

    from terrain_tpu_torch.serve.gif import encode_gif, gif_meta, read_gif
    from terrain_tpu_torch.serve.png import read_png_path

    d = os.path.join(HERE, GIF_DIR)
    with open(os.path.join(d, "digests.json")) as f:
        digests = json.load(f)
    # the clip of 512 x 1024 frames is made by the fixture script (numpy
    # integers only), not stored
    spec = importlib.util.spec_from_file_location(
        "make_gif_fixtures", os.path.join(HERE, "tests",
                                          "make_gif_fixtures.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    equal = total = 0
    for clip, want in digests.items():
        if clip == "reference":
            continue
        src = ([read_png_path(os.path.join(d, n)) for n in want["frames"]]
               if want["frames"] else list(script.frames(clip)))
        data = encode_gif(src, 40)
        meta = gif_meta(data)
        got = read_gif(data)
        if (len(got), meta["durations"], meta["loop"], list(meta["size"])) \
                != (want["n_frames"], want["durations"], want["loop"],
                    want["size"]):
            fail(f"artifacts: the {clip} clip's GIF has {len(got)} frames, "
                 f"durations {meta['durations']}, loop {meta['loop']}, size "
                 f"{meta['size']}; imageio's: {want}")
        shas = [hashlib.sha256(g.tobytes()).hexdigest() for g in got]
        same = sum(a == b for a, b in zip(shas, want["decoded_sha256"]))
        if not clip.startswith("rgb") and same != len(got):
            fail(f"artifacts: the {clip} clip decodes to other pixels than "
                 f"imageio's")
        at, k = [], -1
        for i, f in enumerate(src):
            k += not (i and np.array_equal(f, src[i - 1]))
            at.append(k)
        for i, f in enumerate(src):
            rgb = f if f.ndim == 3 else np.repeat(f[..., None], 3, -1)
            err = float(np.abs(got[at[i]].astype(np.int64) - rgb).mean())
            lim = 1.10 * want["pillow_mae"][i] + 0.25
            if err > lim:
                fail(f"artifacts: {clip} frame {i}'s mean error {err:.4f} "
                     f"is over {lim:.4f} (1.10 x Pillow's + 0.25)")
        equal += same
        total += len(got)
    print(f"artifacts [{card}]: the committed GIF clips (one of 512 x 1024 "
          f"full-colour frames): frame counts, durations and loop as "
          f"imageio writes them; {equal} of {total} decoded frames "
          f"bit-equal to imageio's (the gray and 60-colour ones required, "
          f"the full-colour ones within 1.10 x Pillow's error + 0.25)",
          flush=True)


def _interp(torch, np, card, root):
    """A full-width flagship checkpoint, then `interp` and `gen` through
    cli.main; returns (the interp run's launch counts, the clip's
    directory, gen's directory)."""
    from terrain_tpu_torch import cli
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.models import convert
    from terrain_tpu_torch.train import checkpoint

    os.environ.update({"TERRAIN_OUT": os.path.join(root, "out"),
                       "TERRAIN_MODELS": os.path.join(root, "models"),
                       "TERRAIN_PICK": "name"})
    t0 = time.perf_counter()
    gan, name = build_gan(EXPERIMENT, "cuda", verbose=False)
    models = os.path.join(root, "models", name)
    os.makedirs(models)
    # the weights and BN statistics only: interp loads no optimizer state
    trees = {n: convert.to_jax(net) for n, net in gan.nets.items()}
    checkpoint.save_model(os.path.join(models, "600.model"),
                          {n: t[0] for n, t in trees.items()},
                          {n: t[1] for n, t in trees.items()})
    del gan, trees
    torch.cuda.empty_cache()
    t_ckpt = time.perf_counter() - t0
    _reset_counters()
    t0 = time.perf_counter()
    if cli.main([EXPERIMENT, "interp"]) != 0:
        fail("artifacts: the interp CLI returned an error")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    clip = os.path.join(root, "out", name, "interp_clip")
    frames = sorted(os.listdir(clip))
    n = CLIP_DISPATCHES * CLIP_BATCH
    if frames != [f"concat_{i:04d}.png" for i in range(n)]:
        fail(f"artifacts: interp wrote {len(frames)} files, not concat_0000"
             f" .. concat_{n - 1:04d}.png")
    for k, v in CLIP_LAUNCHES.items():
        if got[k] != v * CLIP_DISPATCHES:
            fail(f"artifacts: interp launched {k} {got[k]} times, expected "
                 f"{v} in each of {CLIP_DISPATCHES} dispatches")
    others = {k: v for k, v in got.items() if v and k not in CLIP_LAUNCHES}
    print(f"artifacts [{card}]: a full-width {EXPERIMENT} checkpoint "
          f"(weights and BN statistics) built and written in {t_ckpt:.1f} "
          f"s; `{EXPERIMENT} interp`: "
          f"{n} frames of 512 x 1024 in {wall:.1f} s (checkpoint load, "
          f"{CLIP_DISPATCHES} two-stage dispatches of {CLIP_BATCH}, PNG "
          f"writes): {n / wall:.2f} frames/s; launches a dispatch "
          f"{ {k: got[k] / CLIP_DISPATCHES for k in CLIP_LAUNCHES} }, "
          f"others {others}", flush=True)
    t0 = time.perf_counter()
    if cli.main([EXPERIMENT, "gen"]) != 0:
        fail("artifacts: the gen CLI returned an error")
    gen = os.path.join(root, "out", name, "gen")
    if len(os.listdir(gen)) != 100:
        fail(f"artifacts: gen wrote {len(os.listdir(gen))} samples, not "
             f"100")
    print(f"artifacts [{card}]: `{EXPERIMENT} gen`: 100 samples in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return got, clip, gen


def _grid(np, imgs, cols, rows):
    """The plain composition: rows x cols cells, row by row, zeros past
    the last image."""
    cells = list(imgs) + [np.zeros_like(imgs[0])] * (cols * rows - len(imgs))
    return np.concatenate([np.concatenate(cells[r * cols:(r + 1) * cols], 1)
                           for r in range(rows)], 0)


def _artifact_tools(np, card, root, clip, gen):
    """The port's four artifact tools on the interp clip, the gen samples
    and a trainer-shaped directory, each timed and its outputs checked."""
    import concurrent.futures
    from terrain_tpu_torch.serve.gif import gif_meta, read_gif
    from terrain_tpu_torch.serve.png import read_png_path, write_png_path
    from terrain_tpu_torch.tools import (make_filmstrip, make_gen_sheet,
                                         pack_artifacts, render_clip)

    out = os.path.join(root, "tools")
    os.makedirs(out)
    files = [os.path.join(clip, f) for f in sorted(os.listdir(clip))]
    # make_filmstrip: 8 evenly spaced frames side by side
    strip = os.path.join(out, "strip.png")
    _timed(card, "make_filmstrip", lambda: make_filmstrip.main(
        [clip, strip]), "artifacts")
    picks = make_filmstrip.picks(files, 8)
    if not np.array_equal(read_png_path(strip), np.concatenate(
            [read_png_path(f) for f in picks], 1)):
        fail("artifacts: the filmstrip is not its 8 frames side by side")
    # render_clip: the GIF, read back
    gif_path = os.path.join(out, "clip.gif")
    t0 = time.perf_counter()
    _timed(card, "render_clip", lambda: render_clip.main([clip, gif_path]),
           "artifacts")
    dt = time.perf_counter() - t0
    runs = []  # [first frame, length] of each run of equal frames
    prev = None
    for f in files:
        with open(f, "rb") as fh:
            data = fh.read()  # the encoder is deterministic: equal bytes
        if data == prev:      # are equal frames and the reverse
            runs[-1][1] += 1
        else:
            runs.append([f, 1])
        prev = data
    meta = gif_meta(gif_path)
    frames = read_gif(gif_path)
    if len(frames) != len(runs) or meta["loop"] != 0 or \
            meta["durations"] != [40 * k for _, k in runs]:
        fail(f"artifacts: the GIF has {len(frames)} frames (durations "
             f"{sorted(set(meta['durations']))}, loop {meta['loop']}); its "
             f"{len(files)} frames have {len(runs)} runs of equal frames")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        srcs = list(pool.map(read_png_path, [f for f, _ in runs]))
    errs = [float(np.abs(g.astype(np.int16) - s).mean())
            for g, s in zip(frames, srcs)]
    colours = len(np.unique(srcs[0].reshape(-1, 3).astype(np.uint32)
                            @ np.array([65536, 256, 1], np.uint32)))
    del srcs
    if max(errs) > CLIP_MAE_LIMIT:
        fail(f"artifacts: a GIF frame's mean error is {max(errs):.3f}, over "
             f"{CLIP_MAE_LIMIT}")
    print(f"artifacts [{card}]: clip.gif: {len(frames)} frames from "
          f"{len(files)} ({len(files) - len(frames)} merged into the frame "
          f"before), {os.path.getsize(gif_path) / 2**20:.1f} MiB, "
          f"{dt * 1e3 / len(files):.1f} ms a 512 x 1024 frame (PNG read, "
          f"quantize on {min(8, os.cpu_count() or 1)} threads, LZW); mean "
          f"error against the sources {min(errs):.3f}-{max(errs):.3f} grey "
          f"levels; the first frame has {colours} colours", flush=True)
    gray_dir = os.path.join(out, "gray")
    os.makedirs(gray_dir)
    grays = []
    for i, f in enumerate(files[:CLIP_GRAY_FRAMES]):
        # the heightmap, 0 lifted to 1: a first frame whose gray levels are
        # exactly 0 .. 2^k - 1 reads as L in Pillow, and imageio cannot
        # stack it with the RGB frames after it (read_gif raises alike)
        g = np.maximum(read_png_path(f)[:, :512, 0], 1)
        grays.append(g)
        write_png_path(os.path.join(gray_dir, f"concat_{i:04d}.png"), g)
    gray_gif = os.path.join(out, "gray.gif")
    _timed(card, "render_clip (gray)", lambda: render_clip.main(
        [gray_dir, gray_gif]), "artifacts")
    got = read_gif(gray_gif)
    keep = [g for i, g in enumerate(grays)
            if not (i and np.array_equal(g, grays[i - 1]))]
    if len(got) != len(keep) or any(
            not np.array_equal(a, np.repeat(b[..., None], 3, -1))
            for a, b in zip(got, keep)):
        fail("artifacts: the gray clip does not decode to its frames")
    try:
        render_clip.main([gray_dir, os.path.join(out, "c.mp4")])
        fail("artifacts: render_clip wrote an .mp4")
    except NotImplementedError as e:
        if "ffmpeg" not in str(e):
            fail(f"artifacts: the .mp4 refusal does not name ffmpeg: {e}")
    # make_gen_sheet: 5 x 5 of the first 25 samples (sorted by name)
    sheet = os.path.join(out, "sheet.png")
    _timed(card, "make_gen_sheet", lambda: make_gen_sheet.main(
        [gen, sheet]), "artifacts")
    samples = sorted(os.path.join(gen, f) for f in os.listdir(gen))[:25]
    if not np.array_equal(read_png_path(sheet), _grid(
            np, [read_png_path(f) for f in samples], 5, 5)):
        fail("artifacts: the gen sheet is not its 25 tiles")
    # pack_artifacts on a trainer-shaped directory
    run = os.path.join(out, "run")
    os.makedirs(os.path.join(run, "dump_a"))
    header = "epoch,train_loss,valid_loss,lr,time,mode"
    rows = [f"{e},{1 / e:.5f},{2 / e:.5f},2e-4,{e * 1.5:.2f},both"
            for e in range(1, 7)]
    text = [header] + rows[:4] + ["3,0.5", "2,junk"] + [
        r.replace("both", "resumed") for r in rows[2:]]
    with open(os.path.join(run, "results.txt"), "w") as f:
        f.write("\n".join(text) + "\n")
    want_csv = "\n".join([header] + rows[:2] + [
        r.replace("both", "resumed") for r in rows[2:]]) + "\n"
    for e, f in enumerate(samples[:6]):
        shutil.copy(f, os.path.join(run, f"out_{e + 1}.png"))
    shutil.copy(samples[6], os.path.join(run, "arch_p2p_gen.png"))
    for i, f in enumerate(samples[:20]):
        shutil.copy(f, os.path.join(run, "dump_a", f"{i}.png"))
    packed = os.path.join(out, "packed")
    _timed(card, "pack_artifacts", lambda: pack_artifacts.main(run, packed),
           "artifacts")
    with open(os.path.join(packed, "results.txt")) as f:
        if f.read() != want_csv:
            fail("artifacts: pack_artifacts' results.txt is not the last "
                 "row of each epoch without the torn ones")
    want_files = {"results.txt", "arch_p2p_gen.png", "out_1.png",
                  "out_4.png", "out_6.png", "dump_a_final.png"}
    if set(os.listdir(packed)) != want_files:
        fail(f"artifacts: pack_artifacts wrote {sorted(os.listdir(packed))}")
    for name in want_files - {"results.txt", "dump_a_final.png"}:
        with open(os.path.join(packed, name), "rb") as a, \
                open(os.path.join(run, name), "rb") as b:
            if a.read() != b.read():
                fail(f"artifacts: pack_artifacts' {name} is not a copy")
    dump = sorted(os.path.join(run, "dump_a", f) for f in
                  os.listdir(os.path.join(run, "dump_a")))
    if not np.array_equal(read_png_path(os.path.join(
            packed, "dump_a_final.png")), _grid(
            np, [read_png_path(f) for f in dump], 5, 4)):
        fail("artifacts: dump_a_final.png is not its 20 samples, 5 a row")


def artifacts_child(torch, root):
    """`chip_smoke.py _artifacts <dir>`: the artifacts phase in a process
    where h5py, imageio and PIL cannot be imported.  Writes the interp
    run's launch counts to <dir>/artifacts.json."""
    import numpy as np

    from terrain_tpu_torch.device import strict_fp32

    _blocked_libraries("artifacts")
    strict_fp32()
    card = card_line()
    t0 = time.perf_counter()
    _gif_fixtures(np, card)
    launches, clip, gen = _interp(torch, np, card, root)
    t1 = time.perf_counter()
    _artifact_tools(np, card, root, clip, gen)
    print(f"artifacts [{card}]: the four tools and their checks took "
          f"{time.perf_counter() - t1:.1f} s; the phase's work "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(root, "artifacts.json"), "w") as f:
        json.dump(launches, f)
    return 0


def artifacts_slice(torch, card):
    """The artifacts phase (the flagship's interp clip at full width and
    the port's four artifact tools) in a child process with h5py, imageio
    and PIL unimportable; returns the interp run's launch counts."""
    import tempfile

    root = tempfile.mkdtemp(prefix="artifacts_")
    try:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "_artifacts", root], capture_output=True,
                           text=True, timeout=ARTIFACTS_LIMIT_S)
        print(p.stdout, end="", flush=True)
        if p.returncode != 0:
            fail(f"artifacts: the child failed (rc {p.returncode}):\n"
                 f"{p.stderr[-3000:]}")
        with open(os.path.join(root, "artifacts.json")) as f:
            launches = json.load(f)
        print(f"artifacts: the phase's process took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


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


def _chunk(torch, np, gan, ds, k, seed, n=TRAIN_BATCH):
    """k seeded global batches of n over ds: gan's rank's rows of each
    (the batch arguments of its chunk, as the trainer's epoch slices
    them)."""
    rnd = np.random.RandomState(seed)
    rows = gan._local(n)
    Z = torch.from_numpy(np.ascontiguousarray(rnd.rand(
        k, n, gan.latent_dim).astype(np.float32)[:, rows])).cuda()
    idx = torch.from_numpy(np.ascontiguousarray(rnd.randint(
        0, ds.N, (k, n)).astype(np.int32)[:, rows])).cuda()
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


def traced_replay(card, what, replay, per_step):
    """`replay()`, one replay of a graph of SCAN_K steps, traced
    (utils/profiling.trace) and summarized: every hand-written kernel event
    in its family under the cudaGraphLaunch, SCAN_K times `per_step`
    ({kernel: launches in one bare step}; summarize_checked)."""
    import tempfile

    from terrain_tpu_torch.utils.profiling import trace

    for first in (True, False):
        root = tempfile.mkdtemp(prefix="replay_trace_")
        try:
            t0 = time.perf_counter()
            with trace(root, "cuda"):
                replay()
            TRACE_WORK_S.append(time.perf_counter() - t0)
            summarize_checked(os.path.join(root, os.listdir(root)[0]), card,
                              what, per_step=(SCAN_K, per_step), quiet=True,
                              lost_ok=first)
            return
        except LostEvents:
            pass
        finally:
            shutil.rmtree(root, ignore_errors=True)


def scan_equivalence(torch, np, card):
    """Eager steps against one CUDA graph of SCAN_K steps, from one saved
    state (networks, BN statistics, optimizer state, generator seeds), by
    default (the fp32 step is run-to-run deterministic since the port's
    repairs: device.strict_fp32, ops/resize.Bilinear2xLib), in fp32 and
    bf16, with the opt-in switches off and on: k eager steps twice, then
    two replays, every tensor bit-equal; then, fp32 switches off, the same
    at half the lr (the graph captured anew), and with adam, whose step
    count the graph advances on the device.  Returns the bf16 setup
    (rmsprop) for timing.  At the lr as given with rmsprop, a third replay
    is traced and summarized (traced_replay)."""
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
                rngs = start()
                traced_replay(
                    card, f"scan {what}, one traced replay of {SCAN_K} steps",
                    lambda: scan(gan.opt_states, batches, rngs, lr),
                    expected_launches(on))
            start()  # the saved state back
            del scan, e1, e2, g, g2, saved, every, cats
        set_switches(False)
        if gan.optimizer.name != "rmsprop":
            gan.optimizer = optim.get_optimizer("rmsprop")
            gan._init_opt_states()
            tr, _ = gan._build_steps(ds.make_prepare(augment=True))
        torch.cuda.empty_cache()
        if label == "bf16":
            kept[label] = (gan, ds, tr)
        del gan, ds, tr
    return kept


def scan_timing(torch, np, card, kept):
    """bf16 per step at TERRAIN_SCAN=16, switches off, eager and graph in
    turns (eager, graph, graph, eager: host clock around a synchronized
    chunk).  The depth cut to keep the whole script's time as the
    parallel phase took TERRAIN_SCAN over a mesh: fp32 per step (the
    replays against eager steps) and both graphs' profiled device time
    and busy share are read there, on the world-1 mesh and without one."""
    import tempfile

    from terrain_tpu_torch.tools.summarize_trace import borrow_bounds
    from terrain_tpu_torch.train.step import build_scan_step
    from terrain_tpu_torch.utils.profiling import trace

    k = SCAN_TIME_K
    gan, ds, tr = kept.pop("bf16")
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
    print(f"scan [{card}] bf16 switches off, TERRAIN_SCAN={k}: per step "
          f"eager {per['eager'][0]:.3f}, graph {per['graph'][0]:.3f}, graph "
          f"{per['graph'][1]:.3f}, eager {per['eager'][1]:.3f} ms (host "
          f"clock, in turns)", flush=True)
    # one eager step and one replay traced and summarized: every
    # hand-written kernel of the replay's k steps in its family, k times the
    # eager step's launches; the replay's kernels given the eager step's op
    # instances and bounds (by name and order) for its headroom table
    root = tempfile.mkdtemp(prefix="scan_trace_")
    t_block = time.perf_counter()
    try:
        rngs = gan._next_rngs(0)
        _reset_counters()
        with trace(os.path.join(root, "eager"), "cuda"):
            tr(gan.opt_states, batches[0], rngs, gan.lr)
        one = {n: c for n, c in _read_counters().items() if n in _counters()}
        eager_s, _ = summarize_checked(
            os.path.join(root, "eager", os.listdir(
                os.path.join(root, "eager"))[0]), card,
            "scan bf16, one traced eager step", eager=True, quiet=True)
        for first in (True, False):
            d = os.path.join(root, f"replay{int(first)}")
            t0 = time.perf_counter()
            with trace(d, "cuda"):
                graph()
            t_trace = time.perf_counter() - t0
            try:
                replay_s, _ = summarize_checked(
                    os.path.join(d, os.listdir(d)[0]), card,
                    f"scan bf16 TERRAIN_SCAN={k}, one traced replay "
                    f"({t_trace:.1f} s with the trace)", per_step=(k, one),
                    quiet=True, lost_ok=first)
                break
            except LostEvents:
                pass
        borrowed = borrow_bounds(replay_s, eager_s, k)
        summarize_checked(None, card, f"scan bf16 TERRAIN_SCAN={k}, the "
                          f"replay with the eager step's bounds",
                          summary=borrowed)
        print(f"scan bf16: kernels not run {k} times as often in the replay "
              f"as in the eager step, left unbounded (replayed, eager): "
              f"{ {n[:60]: c for n, c in borrowed.unmatched.items()} }",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the traces and the borrowing (the summaries are counted by
    # summarize_checked itself)
    TRACE_WORK_S.append(time.perf_counter() - t_block
                        - eager_s.seconds - replay_s.seconds)
    del scan, batches, gan, ds, tr
    torch.cuda.empty_cache()


def scan_trainer(torch, np, card):
    """The trainer on SCAN_TRAINER_N pairs held on the card at
    TERRAIN_SCAN=16 (train and eval chunks as _scan_k cuts the epoch),
    dumps off: first `python -m terrain_tpu_torch test1_nobn_bilin_both
    train` in fp32 through cli.main, two epochs, with the counters set to
    0 just before and read just after (its dW and dX kernels show one
    warm-up step and one capture of a chunk, not both epochs' steps: the
    graph outlives the epoch); then, on the same
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
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    root = tempfile.mkdtemp(prefix="scan_")
    env = {"TERRAIN_SYNTHETIC": "1", "TERRAIN_FAST": "1",
           "TERRAIN_N": str(SCAN_TRAINER_N), "TERRAIN_EPOCHS": "2",
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
    n_train = SCAN_TRAINER_N // TRAIN_BATCH
    n_eval = (SCAN_TRAINER_N // 10) // TRAIN_BATCH
    k_train = TwoStageGAN._scan_k(n_train)
    k_eval = TwoStageGAN._scan_k(n_eval)
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
            if counts[k] != (1 + k_train) * TRAIN_LAUNCHES[k]:
                fail(f"scan trainer: {k} launched {counts[k]} times, "
                     f"expected {1 + k_train} x {TRAIN_LAUNCHES[k]} (a "
                     f"warm-up step and a capture of {k_train})")
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
                  f"{SCAN_TRAINER_N} pairs on the card, {n_train} train + "
                  f"{n_eval} eval steps an epoch: at TERRAIN_SCAN="
                  f"{SCAN_TIME_K} (chunks of {k_train} and {k_eval}) epoch 1 "
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
    """The three parts in turn, each one's seconds printed."""
    import numpy as np

    t0 = time.perf_counter()
    kept = scan_equivalence(torch, np, card)
    t1 = time.perf_counter()
    scan_timing(torch, np, card, kept)
    t2 = time.perf_counter()
    counts = scan_trainer(torch, np, card)
    print(f"scan: equivalence {t1 - t0:.1f} s, timing {t2 - t1:.1f} s, "
          f"trainer {time.perf_counter() - t2:.1f} s", flush=True)
    return counts


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
    Then TERRAIN_SCAN over the same mesh (parallel_world1_scan).  Returns
    (the launch counts of the mesh's steps, those of its TERRAIN_SCAN
    chunks, failures, the twin's errors {"<label>, seed <s>": errors}, the
    epoch rows {seed: {"one": row, "twin": row}})."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.parallel import initialize, make_mesh
    from terrain_tpu_torch.parallel.distributed import COLLECTIVE_TIMEOUT_S

    initialize(f"file://{root}/nccl", 1, 0, backend="nccl",
               timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
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
        t0 = time.perf_counter()
        scan_counts, more = parallel_world1_scan(torch, np, card, mesh, root)
        bad += more
        print(f"parallel: the world-1 mesh's TERRAIN_SCAN part "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
    return counts, scan_counts, bad, twins, rows


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


class _ChunkRuns:
    """gan's TERRAIN_SCAN path over the DeviceDataset ds, as its epoch
    runs it (TwoStageGAN._chunk_fn; `train` or eval steps): `eager` k
    single steps, `graph` the chunk of k (one CUDA graph over NCCL groups,
    a loop over gloo), each from gan's state at the call, its generators
    re-seeded step by step.  `held` runs one chunk of seeded batches both
    ways from one state and compares the losses and every tensor the step
    updates, bit for bit, with the launch counters read around each."""

    def __init__(self, torch, gan, ds, train=True):
        self.torch, self.gan, self.ds, self.train = torch, gan, ds, train

    def eager(self, batches):
        from terrain_tpu_torch.train.losses import TRAIN_KEYS

        one = self.gan._chunk_fn(self.ds, self.train, 1)
        outs = [one([b], [self.gan._next_rngs(0)]) for b in batches]
        return {k: self.torch.stack([o[k] for o in outs]) for k in TRAIN_KEYS}

    def graph(self, batches):
        chunk = self.gan._chunk_fn(self.ds, self.train, len(batches))
        return chunk(batches, [self.gan._next_rngs(t)
                               for t in range(len(batches))])

    def _result(self, losses):
        from terrain_tpu_torch.train.losses import TRAIN_KEYS
        from terrain_tpu_torch.train.step import step_state

        return ([losses[k].float().clone() for k in TRAIN_KEYS],
                [t.detach().clone() for t in step_state(
                    self.gan.nets, self.gan.opt_states)])

    def held(self, np, k, seed, n=TRAIN_BATCH):
        """{"off": the tensors that differ, "of": of how many, "worst":
        the max abs difference, "eager"/"chunk": the launch counts around
        each, "eager_s"/"s": the seconds of each (host clock, synchronized;
        the result's copies included), "peak": the peak MiB allocated
        during the chunk's call, "losses": the chunk's losses}."""
        torch = self.torch
        batches = _chunk(torch, np, self.gan, self.ds, k, seed, n)
        back = _snapshot(self.gan)
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = self._result(self.eager(batches))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager = _read_counters()
        back()
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = self._result(self.graph(batches))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        pairs = list(zip(want[0] + want[1], got[0] + got[1]))
        return {"off": sum(not a.equal(b) for a, b in pairs),
                "of": len(pairs),
                "worst": max(float((a.float() - b.float()).abs().max())
                             if a.numel() else 0.0 for a, b in pairs),
                "eager": eager, "chunk": _read_counters(), "s": secs,
                "eager_s": eager_s, "peak": peak, "losses": got[0]}


def _free(torch):
    """The card's memory of every object no longer reachable, reference
    cycles included: a trainer's cached chunk functions close over the
    trainer, so a dropped one holds its CUDA graphs' pools until the
    collector runs, and ranks spawned onto the same card later would find
    the memory short (cuDNN then takes other algorithms: other bits)."""
    gc.collect()
    torch.cuda.empty_cache()


def _capture_counts(chunk, eager, k, captures):
    """The kernels (not the op counters) whose count around a chunk's call
    is not `captures` x (a warm-up step + k captured steps) x an eager
    step's: a capture calls each wrapper once a launch it records, a
    replay calls none."""
    return [f"{name} {chunk[name]} != {captures} x {k + 1} x "
            f"{eager[name]} / {k}" for name in _counters()
            if chunk[name] * k != captures * (k + 1) * eager[name]]


def parallel_world1_scan(torch, np, card, mesh, root):
    """TERRAIN_SCAN over the world-1 NCCL mesh: TwoStageGAN(mesh=mesh)'s
    chunks (the trainer's path, 16 pairs on the card), each one CUDA graph
    with its NCCL collectives inside.  fp32: on each seed of PAR_SEEDS a
    chunk of PAR_SCAN_K steps bit-equal to PAR_SCAN_K eager steps of the
    same mesh from the same state (losses, parameters, BN statistics,
    optimizer state), captured once and replayed; then an lr change and a
    load_model, each shown to capture anew exactly once, their chunks
    bit-equal to eager; then chunks of SCAN_K with the opt-in switches on
    and with the unfused decoder, likewise, each one's replay traced and
    summarized for the hand-written kernels (traced_replay: SCAN_K x their
    per-step counts).  bf16: per
    step at PAR_SCAN_K, the mesh's eager steps, its graph and the graph
    without a mesh, in turns (host clock around a synchronized chunk,
    median of 2), with profiled device ms a step and peak MiB (eager: one
    chunk of steps; a graph: its warm-up step and capture).  Returns (the
    launch counts around the fp32 chunks' calls, failures)."""
    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.experiments import build_gan

    counts, bad = {}, []
    ds = DeviceDataset(*make_pairs(SCAN_N, 512, seed=0), device="cuda")
    gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
    runs = _ChunkRuns(torch, gan, ds)

    def check(what, k, seed, captures, r=runs):
        h = r.held(np, k, seed)
        if r.train:
            for key, v in h["chunk"].items():
                counts[key] = counts.get(key, 0) + v
        wrong = _capture_counts(h["chunk"], h["eager"], k, captures)
        print(f"parallel [{card}] NCCL world 1, fp32, TERRAIN_SCAN={k}, "
              f"{what}: the chunk ("
              f"{'capture + replay' if captures else 'replay'} "
              f"{h['s'] * 1e3 / k:.3f} ms a step) against {k} eager steps "
              f"of the mesh ({h['eager_s'] * 1e3 / k:.3f} ms a step; "
              f"peak {h['peak']:.1f} MiB during the chunk's call): "
              f"{h['of'] - h['off']} of {h['of']} tensors bit-equal (max abs "
              f"difference {h['worst']:.3e}); its launch calls "
              f"{ {n: v for n, v in h['chunk'].items() if v} }", flush=True)
        if h["off"]:
            bad.append(f"world-1 scan {what}: {h['off']} of {h['of']} "
                       f"tensors differ from eager")
        if wrong:
            bad.append(f"world-1 scan {what}: {captures} capture(s) "
                       f"expected, launch calls {wrong}")

    for i, seed in enumerate(PAR_SEEDS):
        check(f"seed {seed}", PAR_SCAN_K, seed, int(i == 0))
    check("the eval chunk", PAR_SCAN_K, PAR_SEEDS[0], 1,
          _ChunkRuns(torch, gan, ds, train=False))
    gan.lr *= 0.5
    check("after an lr change", PAR_SCAN_K, PAR_SEEDS[0], 1)
    path = os.path.join(root, "world1_scan.model")
    gan.save_model(path)
    gan.load_model(path, exact=True)
    os.remove(path)
    check("after load_model", PAR_SCAN_K, PAR_SEEDS[0], 1)
    check("a replay after them", PAR_SCAN_K, PAR_SEEDS[1], 0)
    for label, switches, per_step in (
            ("switches on", SWITCHES, expected_launches(True)),
            ("unfused decoder", UNFUSED, expected_launches(False, True))):
        # one setting's graphs at a time: each holds its private pool, and
        # cuDNN falls back to other algorithms (other bits) for want of
        # workspace when the pools crowd the card
        gan._chunks.clear()
        _free(torch)
        set_switches(True, switches)
        check(label, SCAN_K, PAR_SEEDS[0], 1)
        batches = _chunk(torch, np, gan, ds, SCAN_K, PAR_SEEDS[0])
        try:
            traced_replay(card, f"parallel NCCL world 1, {label}, one "
                          f"traced replay of {SCAN_K} steps",
                          lambda: runs.graph(batches), per_step)
        except SystemExit:  # its FAIL line printed; the phase reads on
            bad.append(f"world-1 scan {label}: the traced replay failed "
                       f"its checks")
        set_switches(False, switches)
    # TERRAIN_CHECK_NANS=2 on the mesh's graph: a planted NaN raises on the
    # rank after the chunk's collectives, with no hang
    gan._chunks.clear()
    _free(torch)
    back = _snapshot(gan)
    batches = _chunk(torch, np, gan, ds, SCAN_K, PAR_SEEDS[0])
    _checks_on(True)
    try:
        runs.graph(batches)  # a clean chunk: warm-up, capture, replay
        back()
        with torch.no_grad():
            gan.nets["p2p_gen"].enc[0].conv.w.mul_(float("nan"))
        msg, secs = _raises_nan(torch, lambda: runs.graph(batches),
                                ["p2p_gen enc.0.conv: ",
                                 f"step 1 of {SCAN_K}"])
    finally:
        _checks_on(False)
    print(f"parallel [{card}] NCCL world 1, TERRAIN_CHECK_NANS=2, "
          f"TERRAIN_SCAN={SCAN_K}: a NaN-poisoned p2p_gen weight raised "
          f"after the replay in {secs:.2f} s: {msg}", flush=True)
    back()
    gan._chunks.clear()
    del gan, runs, check, back, batches
    _free(torch)
    print(f"parallel: this process holds "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB of the card after "
          f"the world-1 mesh's chunks", flush=True)
    bad += _w1_scan_time(torch, np, card, mesh, ds)
    return counts, bad


def _w1_scan_time(torch, np, card, mesh, ds):
    """bf16 per step at PAR_SCAN_TIME_K: the world-1 mesh's eager steps and its
    graph, and the graph without a mesh, in turns; profiled device ms a
    step and peak MiB.  Returns failures (a non-finite loss)."""
    from terrain_tpu_torch.experiments import build_gan

    k = PAR_SCAN_TIME_K
    runs = {m: _ChunkRuns(torch, build_gan(
        EXPERIMENT, "cuda", compute_dtype=torch.bfloat16, verbose=False,
        mesh=m)[0], ds) for m in (mesh, None)}
    modes = {"mesh eager": (runs[mesh], "eager"),
             "mesh graph": (runs[mesh], "graph"),
             "no mesh graph": (runs[None], "graph")}
    batches = {m: _chunk(torch, np, r.gan, ds, k, 7) for m, r in runs.items()}

    def call(mode):
        r, how = modes[mode]
        return getattr(r, how)(batches[mesh if r is runs[mesh] else None])

    peak, capture_s, finite = {}, {}, True
    for mode in modes:  # the graphs' first calls capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call(mode)
        torch.cuda.synchronize()
        capture_s[mode] = time.perf_counter() - t0
        peak[mode] = torch.cuda.max_memory_allocated() / 2**20
        finite &= all(bool(torch.isfinite(v).all()) for v in out.values())
    ms = {m: [] for m in modes}
    order = list(modes)
    # two turns each, cut from three to keep the whole script's time
    for mode in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(mode)
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / k)
    dev = {}  # (the eager step's device time is _par_time's)
    for mode in ("mesh graph", "no mesh graph"):
        _, rows = profiled(torch, lambda: call(mode))
        dev[mode] = sum(r[0] for r in rows) / k
    print(f"parallel [{card}] NCCL world 1, bf16, TERRAIN_SCAN={k}, per step "
          f"(host clock around a synchronized chunk, in turns; median of 2): "
          + "; ".join(f"{m} " + " / ".join(f"{t:.3f}" for t in ms[m])
                      + f" ms (median {statistics.median(ms[m]):.3f}), "
                      + (f"profiled device {dev[m]:.3f} ms, " if m in dev
                         else "") + f"peak {peak[m]:.1f} MiB" for m in modes)
          + "; first calls (the graphs' warm-up + capture + replay) "
          + ", ".join(f"{m} {capture_s[m]:.2f} s" for m in modes), flush=True)
    bad = [] if finite else ["world-1 scan bf16: a non-finite loss"]
    for mode in ("mesh graph", "no mesh graph"):
        step_ms = statistics.median(ms[mode])
        if step_ms > SCAN_BUSY_LIMIT * dev[mode]:
            bad.append(f"world-1 scan bf16: the {mode}'s step {step_ms:.3f} "
                       f"ms is more than {SCAN_BUSY_LIMIT} x its device "
                       f"time {dev[mode]:.3f} ms")
    del runs, modes, batches, call
    _free(torch)
    return bad


def _spawned(work, rank, world, root, backend, *args):
    """work(rank, world, root, *args) in a spawned rank, in a process
    group of `backend` joined through a file in root
    (parallel.distributed.run_rank: the group ended once work has
    returned)."""
    sys.path.insert(0, HERE)
    from terrain_tpu_torch.parallel.distributed import run_rank

    run_rank(f"file://{root}/{work.__name__}", world, rank, work, rank,
             world, root, *args, backend=backend)


def _par_work(rank, world, root, env):
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
    os.environ.update(env)
    import torch

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.parallel import make_mesh

    strict_fp32()
    out = {"counts": {}, "step_ms": [], "err": {}, "faults": {}, "rows": {},
           "epoch_s": []}

    def counted(fn):
        _reset_counters()
        r = fn()
        torch.cuda.synchronize()
        for k, v in _read_counters().items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        return r

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
    # TERRAIN_SCAN over gloo: the chunk's loop, against k = 1
    ds = DeviceDataset(*make_pairs(PAR_SCAN_GLOO_N, 512, seed=PAR_SEEDS[0]),
                       device="cuda")
    out["scan"] = {}
    for scan in (str(PAR_SCAN_GLOO_K), "1"):
        os.environ["TERRAIN_SCAN"] = scan
        gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
        gan.sampler = _tiled_sampler(rank, PAR_SEEDS[0])
        d = os.path.join(root, f"rank{rank}_scan{scan}")
        t0 = time.perf_counter()
        gan.train(ds, ds, TRAIN_BATCH, 1, d, save_every=10)
        out["scan"][scan] = {"row": _results_row(d),
                             "ks": sorted({key[1] for key in gan._chunks}),
                             "s": time.perf_counter() - t0}
        del gan
    del os.environ["TERRAIN_SCAN"], ds
    torch.cuda.empty_cache()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _par_rank(rank, world, root, env):
    _spawned(_par_work, rank, world, root, "gloo", env)


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
    k = str(PAR_SCAN_GLOO_K)
    for r, got in enumerate(res):
        chunked, steps = got["scan"][k], got["scan"]["1"]
        print(f"parallel [{card}] {PAR_WORLD} gloo ranks, rank {r}: an epoch "
              f"over {PAR_SCAN_GLOO_N} pairs at TERRAIN_SCAN={k} (chunk sizes "
              f"{chunked['ks']}, a loop over gloo; {chunked['s']:.1f} s) and "
              f"at 1 ({steps['s']:.1f} s): loss columns equal "
              f"{chunked['row'] == steps['row']}", flush=True)
        if chunked["ks"] != [PAR_SCAN_GLOO_K] or \
                chunked["row"] != steps["row"]:
            bad.append(f"rank {r}: the TERRAIN_SCAN={k} epoch {chunked} is "
                       f"not the k = 1 epoch {steps}")
    counts = [r["counts"] for r in res]
    for r, c in enumerate(counts):
        print(f"parallel: rank {r}'s launches at its {TRAIN_BATCH // PAR_WORLD}"
              f" rows {c}", flush=True)
        missing = [k for k in _counters() if not c.get(k)]
        if missing:
            bad.append(f"rank {r} launched no {missing} at the local batch")
    return counts, bad


def parallel_slice(torch, card):
    """Data parallelism over torch.distributed: NCCL at world 1 (its steps,
    then its TERRAIN_SCAN chunks), then two gloo ranks sharing the card.
    Every reading is printed before any failure ends the run.  Returns the
    launch counts of the world-1 mesh's steps, of its chunks, and of the
    two ranks, added."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="parallel_")
    saved = os.environ.get("TERRAIN_ARTIFACT_EVERY")
    os.environ["TERRAIN_ARTIFACT_EVERY"] = "1000"
    try:
        world1, world1_scan, bad, twins, rows = parallel_world1(torch, card,
                                                                root)
        _free(torch)
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
    _free(torch)
    print(f"parallel: this process holds "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB of the card after "
          f"the phase; the card has {torch.cuda.mem_get_info()[0] / 2**20:.1f}"
          f" MiB free", flush=True)
    print(f"parallel: launches of the world-1 mesh's steps {world1}; of its "
          f"TERRAIN_SCAN chunks (warm-up steps and captures) {world1_scan}; "
          f"of the two ranks {gloo}", flush=True)
    return world1, world1_scan, gloo


# ---------------------------------------------------------------- scan4
# TERRAIN_SCAN on four NCCL ranks, a card each (on request: `scan4`): a
# 4 x 1 data mesh's trainer epoch over SCAN4_N pairs at global batch
# SCAN4_BATCH (one card's TRAIN_BATCH a rank) at TERRAIN_SCAN=16 against
# the same ranks' k = 1 epoch, fp32, bit for bit; bf16 step ms a rank,
# graph against eager; a 2 x 2 mesh's chunk (tensor parallelism at the
# default tp_min_features) and the 1 x 4 spatial `both` step of
# SP_EXPERIMENT as a chunk of SCAN_K, each bit-equal to its eager steps,
# with each rank's launch calls a capture's.  A collective replayed inside
# a graph has no timeout, so each rank's wall clock is bounded by the
# parent (SCAN4_RANK_S).
SCAN4_WORLD = 4
SCAN4_N = 256        # 16 train steps an epoch at SCAN4_BATCH
SCAN4_VALID_N = 64   # 4 eval steps
SCAN4_BATCH = 16
SCAN4_RANK_S = 900


def _scan4_work(rank, world, root):
    """One NCCL rank of scan4_slice.  Writes root/scan4_<r>.json."""
    os.environ["TERRAIN_ARTIFACT_EVERY"] = "1000"
    import numpy as np
    import torch

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_gan, build_train
    from terrain_tpu_torch.parallel import make_mesh
    from terrain_tpu_torch.train.losses import TRAIN_KEYS
    from terrain_tpu_torch.train.step import build_scan_step, step_state

    strict_fp32()
    out = {"data": {}}
    mesh = make_mesh()
    train = DeviceDataset(*make_pairs(SCAN4_N, 512, seed=0), device="cuda")
    valid = DeviceDataset(*make_pairs(SCAN4_VALID_N, 512, seed=1),
                          device="cuda")
    for scan in (str(PAR_SCAN_K), "1"):
        os.environ["TERRAIN_SCAN"] = scan
        gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
        gan.sampler = _tiled_sampler(rank, 0)
        d = os.path.join(root, f"data{rank}_{scan}")
        t0 = time.perf_counter()
        gan.train(train, valid, SCAN4_BATCH, 1, d, save_every=10)
        out["data"][scan] = {"row": _results_row(d),
                             "ks": sorted({key[1] for key in gan._chunks}),
                             "s": time.perf_counter() - t0}
        del gan
    del os.environ["TERRAIN_SCAN"]
    torch.cuda.empty_cache()

    # bf16 per step, the mesh's eager steps and graph in turns
    k = PAR_SCAN_TIME_K
    runs = _ChunkRuns(torch, build_gan(
        EXPERIMENT, "cuda", compute_dtype=torch.bfloat16, verbose=False,
        mesh=mesh)[0], train)
    batches = _chunk(torch, np, runs.gan, train, k, 7, n=SCAN4_BATCH)
    ms = {"eager": [], "graph": []}
    for how in ("graph", "eager") + ("eager", "graph") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(runs, how)(batches)
        torch.cuda.synchronize()
        ms[how].append((time.perf_counter() - t0) * 1e3 / k)
    # each one's first call left out: the graph's captures
    out["bf16"] = {h: v[1:] for h, v in ms.items()}
    del runs, batches
    torch.cuda.empty_cache()
    grid = make_mesh(n_data=2, n_model=2)
    quad = make_mesh(n_data=1, n_model=world)
    if rank == 0:  # one card's graph at TRAIN_BATCH, without a mesh
        one = _ChunkRuns(torch, build_gan(
            EXPERIMENT, "cuda", compute_dtype=torch.bfloat16,
            verbose=False)[0], train)
        batches = _chunk(torch, np, one.gan, train, k, 7)
        one_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.graph(batches)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3 / k)
        out["one_graph"] = one_ms[1:]
        del one, batches
        torch.cuda.empty_cache()

    # the 2 x 2 mesh: tensor parallelism on 'model', data over 2
    gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=grid)
    out["grid_sharded"] = {n: len(v) for n, v in gan.sharded.items()}
    out["grid"] = _ChunkRuns(torch, gan, train).held(np, SCAN_K, 0)
    out["grid"].pop("losses")
    del gan
    torch.cuda.empty_cache()

    # the 1 x 4 spatial step, all four networks on slabs
    setup = build_train(SP_EXPERIMENT, "cuda", mesh=quad)
    state = step_state(setup.nets, setup.opt_states)
    saved = [t.detach().clone() for t in state]
    batches = [_train_batch(torch, TRAIN_BATCH, setup.in_shp,
                            setup.latent_dim, seed) for seed in range(SCAN_K)]

    def result(losses):
        return [losses[key].float().clone() for key in TRAIN_KEYS] + [
            t.detach().clone() for t in state]

    _reset_counters()
    outs = [setup.train_step(setup.opt_states, b, {}, setup.lr)
            for b in batches]
    want = result({key: torch.stack([o[key] for o in outs])
                   for key in TRAIN_KEYS})
    torch.cuda.synchronize()
    eager = _read_counters()
    with torch.no_grad():
        for t, v in zip(state, saved):
            t.copy_(v)
    scan = build_scan_step(setup.train_step)
    _reset_counters()
    t0 = time.perf_counter()
    got = result(scan(setup.opt_states, batches, [{}] * SCAN_K, setup.lr))
    torch.cuda.synchronize()
    out["spatial"] = {
        "off": sum(not a.equal(b) for a, b in zip(want, got)),
        "of": len(want), "s": time.perf_counter() - t0,
        "worst": max(float((a - b).abs().max()) if a.numel() else 0.0
                     for a, b in zip(want, got)),
        "eager": eager, "chunk": _read_counters()}
    with open(os.path.join(root, f"scan4_{rank}.json"), "w") as f:
        json.dump(out, f)


def _scan4_rank(rank, world, root):
    _spawned(_scan4_work, rank, world, root, "nccl")


def _spawn_bounded(torch, fn, args, nprocs, limit_s, what):
    """fn(rank, *args) in nprocs spawned processes, each one's wall clock
    bounded by limit_s: past it every rank still running is killed and
    the phase fails (a collective replayed inside a CUDA graph waits for
    its peers with no timeout)."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + limit_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            fail(f"{what}: a rank ran past {limit_s} s and was killed")


def scan4_slice(torch, card):
    """TERRAIN_SCAN on SCAN4_WORLD NCCL ranks, a card each (the comment
    above SCAN4_WORLD).  Every reading is printed before a failure ends
    the run."""
    import shutil
    import tempfile

    world = SCAN4_WORLD
    if torch.cuda.device_count() < world:
        fail(f"scan4: {world} NCCL ranks need {world} cards, found "
             f"{torch.cuda.device_count()}")
    root = tempfile.mkdtemp(prefix="scan4_")
    try:
        _spawn_bounded(torch, _scan4_rank, (world, root), world,
                       SCAN4_RANK_S, "scan4")
        res = []
        for r in range(world):
            with open(os.path.join(root, f"scan4_{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = []
    k = str(PAR_SCAN_K)
    for r, got in enumerate(res):
        chunked, steps = got["data"][k], got["data"]["1"]
        print(f"scan4 [{card}] rank {r} of a {world} x 1 NCCL mesh, fp32: "
              f"an epoch of {SCAN4_N // SCAN4_BATCH} train and "
              f"{SCAN4_VALID_N // SCAN4_BATCH} eval steps at global batch "
              f"{SCAN4_BATCH} at TERRAIN_SCAN={k} (chunk sizes "
              f"{chunked['ks']}; {chunked['s']:.1f} s, captures included) "
              f"and at 1 ({steps['s']:.1f} s): loss columns equal "
              f"{chunked['row'] == steps['row']}; bf16 per step (host "
              f"clock, synchronized chunks of {k}, in turns) eager "
              + " / ".join(f"{t:.3f}" for t in got["bf16"]["eager"])
              + f" ms (median {statistics.median(got['bf16']['eager']):.3f}"
              f"), graph " + " / ".join(f"{t:.3f}" for t in
                                        got["bf16"]["graph"])
              + f" ms (median {statistics.median(got['bf16']['graph']):.3f})"
              + (f"; one card's graph at batch {TRAIN_BATCH} without a mesh "
                 + " / ".join(f"{t:.3f}" for t in got["one_graph"])
                 + f" ms (median {statistics.median(got['one_graph']):.3f})"
                 if r == 0 else ""), flush=True)
        if chunked["ks"] != sorted([PAR_SCAN_K,
                                    SCAN4_VALID_N // SCAN4_BATCH]) or \
                chunked["row"] != steps["row"]:
            bad.append(f"rank {r}: the TERRAIN_SCAN={k} epoch {chunked} is "
                       f"not the k = 1 epoch {steps}")
        if chunked["row"] != res[0]["data"][k]["row"]:
            bad.append(f"rank {r} recorded other losses than rank 0")
        for what, h in (("2 x 2 mesh (tensor parallelism, sharded "
                         f"{got['grid_sharded']})", got["grid"]),
                        (f"1 x {world} spatial `both` step",
                         got["spatial"])):
            wrong = _capture_counts(h["chunk"], h["eager"], SCAN_K, 1)
            print(f"scan4 [{card}] rank {r}, {what}, fp32: a chunk of "
                  f"{SCAN_K} (capture + replay {h['s']:.2f} s) against "
                  f"{SCAN_K} eager steps: {h['of'] - h['off']} of {h['of']} "
                  f"tensors bit-equal (max abs difference {h['worst']:.3e});"
                  f" launch calls eager "
                  f"{ {n: v for n, v in h['eager'].items() if v} }, chunk "
                  f"{ {n: v for n, v in h['chunk'].items() if v} }",
                  flush=True)
            if h["off"]:
                bad.append(f"rank {r}, {what}: {h['off']} tensors differ")
            if wrong:
                bad.append(f"rank {r}, {what}: launch calls {wrong}")
    if bad:
        fail(f"scan4: {bad}")


# ------------------------------------------------------------------- tp
# Tensor parallelism on 'model': a 1 x TP_WORLD mesh of gloo ranks sharing
# the card (NCCL refuses two ranks on one device), the flagship at full
# width with the default tp_min_features (256), whose rule shards
# TP_SHARDED layers a network.  A sharded step computes one process's
# function with two sums in another order: each sharded conv's output
# features as calls on their slices, and its dX as the sum of the slices'
# dX (and its BatchNorms' statistics as sums over a data group of one
# rank, as on the world-1 mesh of `parallel`).  Its twin in one process
# changes those alone (each wide layer called as TP_WORLD calls on its
# weight's slices, autograd adding their dX; the BatchNorms over rank 0's
# own group), so
# the ranks are held to PAR_TWIN x the twin's error against one process on
# the same seed (never less than PAR_TOL), losses, gradients (the sharded
# ones gathered) and each network's update; each of TP_FAULTS must fail
# that.  The biases are seeded nonzero (the init's are zeros), so that a
# bias added on every shard shows.
TP_WORLD = 2
TP_SHARDED = {"dcgan_gen": 3, "dcgan_disc": 3, "p2p_gen": 13, "p2p_disc": 2}
TP_FAULTS = ("dX partial sums not reduced", "slices at the wrong offset",
             "bias added on every shard before the gather")


def _seed_biases(torch, gan):
    """Every layer's bias drawn from U(-0.05, 0.05), seeded by network:
    the same on every rank and in every process."""
    for i, net in enumerate(gan.nets.values()):
        g = torch.Generator().manual_seed(100 + i)
        with torch.no_grad():
            for m in net.modules():
                if hasattr(m, "OUT_AXIS"):
                    m.b.copy_((torch.rand(m.b.shape, generator=g) - 0.5)
                              * 0.1)


def _whole(net, tensors):
    """`tensors` in net.parameters() order, each one of a sharded weight
    (a slice) gathered whole over the model group (a collective)."""
    from terrain_tpu_torch.parallel import tp

    where = {id(m.w): m for m in net.modules()
             if getattr(m, "shard", None) is not None}
    return [tp.gather_axis(t.detach(), where[id(p)].OUT_AXIS,
                           where[id(p)].shard) if id(p) in where
            else t.detach().clone()
            for p, t in zip(net.parameters(), tensors)]


def _tp_step(torch, gan, batch, init):
    """One step of gan on the whole batch: (losses, {network: gradients},
    {network: the update, parameters after minus `init`}), each sharded
    tensor gathered whole."""
    losses, grads = _par_step(torch, gan, batch)
    grads = {n: _whole(gan.nets[n], g) for n, g in grads.items()}
    upd = {n: [a - b for a, b in zip(_whole(net, list(net.parameters())),
                                     init[n])]
           for n, net in gan.nets.items()}
    return losses, grads, upd


def _tp_errors(got, want):
    """_errors of the losses and gradients, and "update <network>": the
    update's relative L2."""
    out = _errors(got[:2], want[:2])
    out.update({k.replace("grad", "update"): v for k, v in
                _errors(({}, got[2]), ({}, want[2])).items()})
    return out


@contextlib.contextmanager
def _tp_twin(torch, gan, n):
    """gan's wide layers (the ones a 1 x n mesh shards) each called as n
    calls on its weight's output-feature slices, the outputs
    concatenated, then the bias (and conv2d_leaky's activation): one
    process with the sharded step's summation orders."""
    from terrain_tpu_torch.ops.activations import leaky_relu
    from terrain_tpu_torch.ops.conv import conv2d, conv2d_leaky
    from terrain_tpu_torch.parallel import tp

    def split(layer):
        def forward(op, x, **kw):
            slope = None
            if op is conv2d_leaky:
                op, slope = conv2d, kw.pop("slope", 0.2)
            # one node that sums the slices' dX before the input's other
            # users see it, as enter_sharded's all-reduce does
            x = x.view_as(x)
            y = torch.cat([op(x, w, None, **kw) for w in
                           layer.w.chunk(n, layer.OUT_AXIS)], -1)
            y = y + layer.b.to(y.dtype)
            return y if slope is None else leaky_relu(y, slope)
        return forward

    layers = [m for net in gan.nets.values()
              for m in tp.wide_layers(net, n).values()]
    for m in layers:
        m.forward = split(m)
    try:
        yield
    finally:
        for m in layers:
            del m.forward


@contextlib.contextmanager
def _tp_fault(torch, gan, fault):
    """gan (on a mesh) with one of TP_FAULTS planted."""
    from terrain_tpu_torch.parallel import tp

    if fault == "dX partial sums not reduced":
        real = tp.EnterSharded.backward
        tp.EnterSharded.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            yield
        finally:
            tp.EnterSharded.backward = real
    elif fault == "slices at the wrong offset":
        # each rank holds the next rank's slice (restored by the snapshot)
        with torch.no_grad():
            for net in gan.nets.values():
                for m in net.modules():
                    sh = getattr(m, "shard", None)
                    if sh is not None:
                        full = tp.gather_axis(m.w, m.OUT_AXIS, sh)
                        m.w.copy_(full.chunk(sh.count, m.OUT_AXIS)[
                            (sh.index + 1) % sh.count])
        yield
    elif fault == "bias added on every shard before the gather":
        # the all-reduce of the ranks' padded outputs then sums the bias
        # once per rank
        real = tp.call
        tp.call = lambda op, x, w, b, shard, **kw: real(
            op, x, w, b if shard is None or b is None else b * shard.count,
            shard, **kw)
        try:
            yield
        finally:
            tp.call = real
    else:
        fail(f"tp: unknown fault {fault}")


def _tp_work(rank, world, root, env):
    """One rank of a 1 x world mesh, spawned by tp_slice: gloo ranks
    sharing the card, or NCCL ranks a card each: the flagship's fp32 step
    on each seed of PAR_SEEDS, each of TP_FAULTS on the first, a
    checkpoint written and loaded back on the last, then a step with the
    opt-in switches on and one with the unfused decoder.  Rank 0 also
    takes each seed's step in one process (timed, on its card) and as the
    twin (_tp_twin) and compares.  The launch counters are read around
    this rank's sound mesh steps alone.  Writes root/tp<r>.json; raises
    on any failure."""
    os.environ.update(env)
    import numpy as np
    import torch

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.ops.norm import BatchNorm
    from terrain_tpu_torch.parallel import make_mesh

    strict_fp32()
    out = {"counts": {}, "step_ms": [], "one_ms": [], "err": {}, "twin": {},
           "faults": {}, "losses_finite": True}

    def counted(fn):
        _reset_counters()
        r = fn()
        torch.cuda.synchronize()
        for k, v in _read_counters().items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        return r

    def built(mesh=None, bn_group=None):
        gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False, mesh=mesh)
        for m in (m for net in gan.nets.values() for m in net.modules()):
            if bn_group is not None and isinstance(m, BatchNorm):
                m.process_group = bn_group
        _seed_biases(torch, gan)
        init = {n: _whole(net, list(net.parameters()))
                for n, net in gan.nets.items()}
        return gan, init, _snapshot(gan)

    mesh = make_mesh(n_data=1, n_model=world)
    gan, init, back = built(mesh)
    out["sharded"] = {n: len(v) for n, v in gan.sharded.items()}
    if rank == 0:
        one, one_init, back_one = built()
        # the mesh's BatchNorm sums (over a data group of one rank)
        twin, twin_init, back_twin = built(bn_group=mesh.data_group)
    for seed in PAR_SEEDS:
        batch = _train_batch(torch, TRAIN_BATCH, gan.in_shp,
                             gan.latent_dim, seed)
        back()
        t0 = time.perf_counter()
        got = counted(lambda: _tp_step(torch, gan, batch, init))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            back_one()
            t0 = time.perf_counter()
            ref = _tp_step(torch, one, batch, one_init)
            torch.cuda.synchronize()
            out["one_ms"].append((time.perf_counter() - t0) * 1e3)
            back_twin()
            with _tp_twin(torch, twin, world):
                tw = _tp_step(torch, twin, batch, twin_init)
            out["err"][seed] = _tp_errors(got, ref)
            out["twin"][seed] = _tp_errors(tw, ref)
        if seed == PAR_SEEDS[-1]:
            # (its reload replaces the optimizer states the snapshot
            # restores: the last seed's step)
            out["ckpt_full"], out["ckpt_loads_back"] = _tp_checkpoint(
                torch, gan, os.path.join(root, f"tp{rank}.model"))
        if seed != PAR_SEEDS[0]:
            continue
        for fault in TP_FAULTS:
            back()
            with _tp_fault(torch, gan, fault):
                faulty = _tp_step(torch, gan, batch, init)
            if rank == 0:
                out["faults"][fault] = _tp_errors(faulty, ref)
    del batch, got
    if rank == 0:
        del one, twin, back_one, back_twin, ref, tw
    torch.cuda.empty_cache()
    for switches in (SWITCHES, UNFUSED):
        set_switches(True, switches)
        back()
        batch = _train_batch(torch, TRAIN_BATCH, gan.in_shp,
                             gan.latent_dim, PAR_SEEDS[0])
        losses = counted(lambda: _par_step(torch, gan, batch))[0]
        out["losses_finite"] &= all(np.isfinite(v)
                                    for v in losses.values())
        set_switches(False, switches)
    with open(os.path.join(root, f"tp{rank}.json"), "w") as f:
        json.dump(out, f)


def _tp_rank(rank, world, root, env, backend):
    _spawned(_tp_work, rank, world, root, backend, env)


def _tp_checkpoint(torch, gan, path):
    """gan's checkpoint, written and read back: (the file holds the
    mesh's parameters gathered whole, bit for bit; loading it back leaves
    every parameter the shape and the value it had)."""
    import numpy as np

    from terrain_tpu_torch.models import convert
    from terrain_tpu_torch.train import checkpoint as ckpt

    held = {n: [p.detach().clone() for p in net.parameters()]
            for n, net in gan.nets.items()}
    gan.save_model(path)
    saved = ckpt.load_model(path)[0]
    full = all(np.array_equal(a, b) for n, (p, _) in saved.items()
               for a, b in zip(_leaves_np(p), _leaves_np(
                   convert.to_jax(gan.nets[n])[0])))
    gan.load_model(path, exact=True)
    back = all(p.shape == q.shape and p.equal(q)
               for n, net in gan.nets.items()
               for p, q in zip(net.parameters(), held[n]))
    os.remove(path)
    return full, back


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_np(v)]
    return [tree]


def tp_slice(torch, card, world=TP_WORLD, backend="gloo"):
    """Tensor parallelism on a 1 x world mesh, fp32, the flagship at batch
    TRAIN_BATCH: by default TP_WORLD gloo ranks sharing the card (a
    correctness path: gloo stages every collective through the host);
    `tp4` asks for four NCCL ranks, a card each.  The sharded layers'
    count by network, each seed's step against one process to
    PAR_TWIN x the twin's error, TP_FAULTS failing it, the checkpoint,
    and every kernel launched on each rank.  Every reading is printed
    before a failure ends the run.  Returns the ranks' launch counts,
    added."""
    import shutil
    import tempfile

    if torch.cuda.device_count() < (world if backend == "nccl" else 1):
        fail(f"tp: {world} NCCL ranks need {world} cards, found "
             f"{torch.cuda.device_count()}")
    root = tempfile.mkdtemp(prefix="tp_")
    try:
        torch.multiprocessing.spawn(
            _tp_rank, args=(world, root, {"TERRAIN_ARTIFACT_EVERY": "1000"},
                            backend),
            nprocs=world, join=True)
        res = []
        for r in range(world):
            with open(os.path.join(root, f"tp{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = []
    for r, got in enumerate(res):
        print(f"tp [{card}] {backend} rank {r} of a 1 x {world} mesh: "
              f"sharded layers {got['sharded']} (want {TP_SHARDED}); steps "
              f"(ms, host clock" + (", a correctness path: gloo stages "
                                    "through the host" if backend == "gloo"
                                    else "") + ") "
              + " ".join(f"{t:.1f}" for t in got["step_ms"])
              + (" against one process on one card " + " ".join(
                  f"{t:.1f}" for t in got["one_ms"]) if r == 0 else "")
              + f"; its checkpoint the mesh's parameters whole "
              f"{got['ckpt_full']}, loaded back sharded and equal "
              f"{got['ckpt_loads_back']}", flush=True)
        if got["sharded"] != TP_SHARDED:
            bad.append(f"rank {r} sharded {got['sharded']}")
        if not (got["ckpt_full"] and got["ckpt_loads_back"]):
            bad.append(f"rank {r}'s checkpoint")
        if not got["losses_finite"]:
            bad.append(f"rank {r}: a non-finite loss with the switches on "
                       f"or the decoder unfused")
    first = str(PAR_SEEDS[0])
    for seed, err in res[0]["err"].items():
        twin = res[0]["twin"][seed]
        bad += _show(f"tp [{card}] {backend} 1 x {world} mesh, fp32, seed "
                     f"{seed}: "
                     f"one step vs one process (sharded tensors gathered)",
                     err, _twin_limits(twin), twin)
    lim = _twin_limits(res[0]["twin"][first])
    for fault, err in res[0]["faults"].items():
        caught = _over(err, lim)
        print(f"tp [{card}] the planted fault '{fault}' fails the comparison "
              f"on {caught}", flush=True)
        if not caught:
            bad.append(f"the planted fault '{fault}' passes")
    counts = [r["counts"] for r in res]
    for r, c in enumerate(counts):
        print(f"tp: rank {r}'s launches {c}", flush=True)
        missing = [k for k in _counters() if not c.get(k)]
        if missing:
            bad.append(f"rank {r} launched no {missing}")
    if bad:
        fail(f"tp: {bad}")
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# -------------------------------------------------------------- spatial
# Spatial parallelism: the four-network step of SP_EXPERIMENT at full
# width (512px, batch TRAIN_BATCH), fp32, every network holding each
# image's rows in slabs over a 1 x SP_WORLD mesh of gloo ranks sharing the
# card (NCCL refuses two ranks on one device), built by
# experiments.build_train(..., mesh=): slabs while the rows a rank holds
# are at least parallel/spatial.MIN_ROWS (8), the deeper layers on whole
# rows.  Such a step computes one process's function with some sums in
# another order: a slab layer's dW and db as the ranks' parts added (the
# DCGAN discriminator's Conv5x5 dW in fixed blocks of each slab), a slab
# BatchNorm's statistics and the losses likewise.  Its twin in one
# process changes those alone: each slab layer called once per slab
# through parallel/spatial.on_slab (its halo cut from the whole tensor,
# the kernel route the ranks take), autograd adding the slabs' dW; each
# slab BatchNorm's sums and the losses over a slab added slab by slab in
# the ranks' order; the pools, which sum nothing across rows, on whole
# rows.  The ranks are held to PAR_TWIN x the twin's error against one
# process on the same seed (never less than PAR_TOL), the losses and the
# four networks' gradients; each of SP_FAULTS must fail that.  The twin
# runs the slab code the ranks run (the crops, the stride-2 phase, the
# kernels at the slabs' heights), so it is held itself to fixed limits
# against one process (SP_TWIN_TOL), and the planted faults in that
# shared code (SP_SHARED_FAULTS) must fail them in the twin.  The seeds'
# steps run at the default switches, then one with both opt-in switches
# (pool2 fwd and bwd on the discriminator's slabs, conv_s2 fwd and dW+db)
# and one with the unfused decoder (bilinear), each compared alike; then
# one seed of SP_P2P_EXPERIMENT's pix2pix step (its DCGAN pair forward
# only, on slabs too).  The biases are seeded nonzero.  Each rank counts
# its own launches around its sound steps: each kernel as often as one
# process launches it under the same switches, and a bf16 step.
SP_EXPERIMENT = "test1_nobn_bilin_both"
SP_P2P_EXPERIMENT = "test1_nobn_finetunep2p_bilin"
SP_WORLD = 2
SP_SHARED_FAULTS = ("stride-2 crop one row off", "stem crop one row off")
SP_FAULTS = ("halo rows zeroed", "halo shifted by one row",
             "BatchNorm over the data group only",
             "slab dW not summed over 'model'",
             "whole-row dW summed over 'model'",
             "5x5 halo one row short",
             "DCGAN discriminator's slab dW not summed over 'model'",
             "conv_thin's halo rows zeroed") + SP_SHARED_FAULTS
# the twin against one process: the losses and PatchGAN's gradients to
# PAR_TOL (PatchGAN's read 1.6e-6 on seed 0); the generators' gradients
# pass back through BatchNorms over a few values (the U-Net's down to
# 1 x 1, the DCGAN generator's from 4 x 4), so a new summation order
# moves them: the U-Net's 1.1e-3 to 5.7e-3 on seeds 0-2, held to 2e-2,
# the DCGAN generator's 3.0e-3 to 4.8e-3, held to 1.7e-2; the DCGAN
# discriminator's slab convs round otherwise than the whole image's, and
# where a max pool's two largest values lie that close its gradient goes
# to the other one: 6.5e-5 to 4.9e-4, held to 1.7e-3 (each limit about
# 3.5x the largest reading; NVIDIA H100 80GB HBM3, 700 W)
# path (a): the flagship's step with the DCGAN generator's
# bilinear_upsample (h 5: each stage's bilinear x2 and 5x5 conv on the slab
# with two low-resolution halo rows a side), one seed, and two faults
SP_BILINEAR_FAULTS = ("bilinear x2's halo row zeroed",
                      "bilinear x2 + 5x5 conv's halo one row short")
SP_TWIN_TOL = {"grad p2p_gen": 2e-2, "grad p2p_disc": PAR_TOL,
               "grad dcgan_gen": 1.7e-2, "grad dcgan_disc": 1.7e-3}
SP_SWITCHED = (("switches", SWITCHES), ("unfused", UNFUSED))
# each kernel's launches in one step on every rank, and in one process:
# the stem twice forward (the fake batch, generator path, and concat
# [real, fake]), dX in the first and dW+db in the second; conv_thin as
# the DCGAN generator's output conv; the U-Net's two fused decoder
# stages; with the switches six of the discriminator's seven pools in its
# two passes, the U-Net's first conv (dW+db: live parameters) and
# PatchGAN's in its two passes (dW+db in the discriminator's); the
# unfused decoder's last stage; the pix2pix mode runs the DCGAN pair
# forward only
_SP_DEFAULT = {"conv_stem_fwd": 2, "conv_stem_dw": 1, "conv_stem_dx": 1,
               "conv_thin": 1, "conv_thin_dx": 1, "conv_thin_dw": 1,
               "bilinear_conv": 2}
SP_LAUNCHES = {"default": _SP_DEFAULT,
               "switches": dict(_SP_DEFAULT, pool2_fwd=12, pool2_bwd=12,
                                conv_s2_fwd=3, conv_s2_dw=2),
               "unfused": dict(_SP_DEFAULT, bilinear=1, bilinear_conv=0),
               "p2p": {"conv_stem_fwd": 2, "conv_stem_dw": 0,
                       "conv_stem_dx": 0, "conv_thin": 1, "conv_thin_dx": 0,
                       "conv_thin_dw": 0, "bilinear_conv": 2},
               "bf16": _SP_DEFAULT,
               # the generator's 5x5 output conv is no conv_thin
               "bilinear": dict(_SP_DEFAULT, conv_thin=0, conv_thin_dx=0,
                                conv_thin_dw=0)}
SP_STEPS = {"default": len(PAR_SEEDS), "switches": 1, "unfused": 1, "p2p": 1,
            "bf16": 1, "bilinear": 1}
# every hand-written kernel runs on the slabs (pool2 and conv_s2 with the
# switches, bilinear with the unfused decoder)
SP_KERNELS = ("bilinear_conv", "conv_thin", "conv_thin_dx", "conv_thin_dw",
              "conv_stem_fwd", "conv_stem_dw", "conv_stem_dx", "conv_s2_fwd",
              "conv_s2_dw", "pool2_fwd", "pool2_bwd", "bilinear")


def _recorder(setup):
    """The gradients setup's step gives its optimizer, by network, kept
    at each update: the frozen optimizer that the step holds gets its
    update wrapped in place.  Returns the dict they go to."""
    rec, opt = {}, setup.optimizer
    real = opt.update
    names = list(setup.opt_states)

    def update(params, grads, state, lr):
        rec[names[len(rec) % len(names)]] = [g.detach().clone()
                                             for g in grads]
        real(params, grads, state, lr)

    object.__setattr__(opt, "update", update)
    return rec


def _setup_snapshot(setup):
    """A function that puts setup's networks and optimizer states back."""
    import torch

    from terrain_tpu_torch.train.step import step_state

    state = step_state(setup.nets, setup.opt_states)
    saved = [t.detach().clone() for t in state]

    def restore():
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)

    return restore


def _sp_step(torch, setup, rec, batch):
    """One step of setup on the batch: (losses, {network: gradients})."""
    rec.clear()
    losses = setup.train_step(setup.opt_states, batch, {}, setup.lr)
    return ({k: float(v) for k, v in losses.items()}, dict(rec))


def _sp_twin_limits(err):
    return {k: SP_TWIN_TOL.get(k, PAR_TOL) for k in err}


@contextlib.contextmanager
def _sp_twin(torch, nets, n):
    """One process's pix2pix networks (no row shard) computing as the n
    ranks of a 1 x n mesh do: each layer the rule puts on slabs called
    once per slab through parallel/spatial.on_slab, its halo cut from the
    whole tensor (the route of the whole image); each slab BatchNorm on
    each slab with its own copy of the statistics, their sums and the
    sums of their cotangents added slab by slab in rank order (as
    parallel/distributed.ordered_sum adds the ranks'); each loss over a
    slab added likewise."""
    from terrain_tpu_torch.ops.norm import ALPHA, EPS, BatchNorm
    from terrain_tpu_torch.parallel import spatial
    from terrain_tpu_torch.train import losses as losses_mod

    rule = spatial.RowShard(0, n, None)

    class Slab(spatial.RowShard):
        __slots__ = ("whole",)

        def __init__(self, i, whole):
            super().__init__(i, n, None)
            self.whole = whole

        def halo(self, x, top, bottom):
            r = x.shape[1]
            lo = self.index * r - (0 if self.first else top)
            hi = (self.index + 1) * r + (0 if self.last else bottom)
            return self.whole.narrow(1, lo, hi - lo).contiguous()

    class SlabSums(torch.autograd.Function):
        """The slabs' partial sums added in rank order, a copy for each
        slab; the backward adds the copies' cotangents the same way."""

        @staticmethod
        def forward(ctx, *parts):
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return tuple(total.clone() for _ in parts)

        @staticmethod
        def backward(ctx, *gs):
            total = gs[0]
            for g in gs[1:]:
                total = total + g
            return tuple(total for _ in gs)

    def slabs(x):
        return [c.contiguous() for c in x.chunk(n, 1)]

    def layer_forward(layer):
        def forward(op, x, **kw):
            return torch.cat([spatial.on_slab(op, c, layer.w, layer.b,
                                              Slab(i, x), layer.io_rows, **kw)
                              for i, c in enumerate(slabs(x))], 1)
        return forward

    def bn_forward(bn):
        def forward(x, train=False, update_stats=False):
            if not train:
                return BatchNorm.forward(bn, x, train, update_stats)
            axes = (0, 1, 2)
            xs = slabs(x)
            count = x.numel() // x.shape[-1]
            means = [s / count for s in SlabSums.apply(
                *[c.float().sum(dim=axes) for c in xs])]
            ds = [c.float() - m for c, m in zip(xs, means)]
            vs = [s / count for s in SlabSums.apply(
                *[(d * d).sum(dim=axes) for d in ds])]
            ys = []
            for c, m, v in zip(xs, means, vs):
                binv = torch.rsqrt(v + EPS)
                scale = (binv * bn.gamma).to(x.dtype)
                shift = (bn.beta - m * binv * bn.gamma).to(x.dtype)
                ys.append(c * scale + shift)
            if update_stats:
                with torch.no_grad():
                    binv = torch.rsqrt(vs[0] + EPS)
                    bn.mean.copy_((1.0 - ALPHA) * bn.mean + ALPHA * means[0])
                    bn.inv_std.copy_((1.0 - ALPHA) * bn.inv_std
                                     + ALPHA * binv)
            return torch.cat(ys, 1)
        return forward

    def mean(v, rows):
        if v.ndim == 4 and rule.slab(v.shape[1]):
            parts = [c.sum() for c in slabs(v)]
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total / v.numel()
        return torch.mean(v)

    patched = []
    for net in nets:
        for m in net.modules():
            io = getattr(m, "io_rows", None)
            if io is None or not rule.slab(min(io)):
                continue
            m.forward = (bn_forward(m) if isinstance(m, BatchNorm)
                         else layer_forward(m))
            patched.append(m)
    real_mean = losses_mod._mean
    losses_mod._mean = mean
    try:
        yield
    finally:
        losses_mod._mean = real_mean
        for m in patched:
            del m.forward


@contextlib.contextmanager
def _sp_fault(torch, nets, fault):
    """One of SP_FAULTS planted in the spatial path of `nets`."""
    import torch.nn.functional as F

    from terrain_tpu_torch.models.dcgan import (
        DCGANDiscriminator, DCGANGenerator)
    from terrain_tpu_torch.ops import bilinear2x_conv
    from terrain_tpu_torch.parallel import spatial

    nets = list(nets)
    real_halo = spatial.halo_exchange
    real_same = spatial.RowShard.same_conv
    real_on_slab = spatial.on_slab
    real_sum = spatial.sum_slab_grads
    real_up_halo = spatial.upsample_halo
    thin_w = next(n for n in nets if isinstance(n, DCGANGenerator)) \
        .conv_out.w

    def zeroed(x, top, bottom, rows):
        ext = real_halo(x, top, bottom, rows)
        t = 0 if rows.first else top
        b = ext.shape[1] - t - x.shape[1]
        return torch.cat([torch.zeros_like(ext[:, :t]),
                          ext.narrow(1, t, x.shape[1]),
                          torch.zeros_like(ext[:, ext.shape[1] - b:])], 1)

    def shifted(x, top, bottom, rows):
        # each halo row one row further from the slab than it belongs
        ext = real_halo(x, top + 1, bottom + 1, rows)
        t = 0 if rows.first else top + 1
        r = x.shape[1]
        parts = [ext[:, :t - 1]] if t else []
        parts.append(ext.narrow(1, t, r))
        if ext.shape[1] > t + r:
            parts.append(ext[:, t + r + 1:])
        return torch.cat(parts, 1)

    def crop_off(self, fn, x, k, s):
        # below the first slab, the stride-2 output's row that reads the
        # zero row kept and its last row dropped
        if s != 2 or self.first:
            return real_same(self, fn, x, k, s)
        ext = F.pad(self.halo(x, 1, 0), (0, 0, 0, 0, 1, 0))
        return fn(ext).narrow(1, 0, x.shape[1] // 2)

    def stem_crop_off(self, fn, x, k, s):
        # below the first slab, the stem's output kept from one row above
        # the slab
        if k != 5 or x.shape[-1] != 1 or self.first:
            return real_same(self, fn, x, k, s)
        return fn(self.halo(x, 2, 2)).narrow(1, 1, x.shape[1])

    def halo_short(self, fn, x, k, s):
        # a 5x5 conv's halo with its outer row (the second from the slab)
        # zeroed
        if k != 5 or s != 1:
            return real_same(self, fn, x, k, s)
        r, top = x.shape[1], 0 if self.first else 2
        ext = self.halo(x, 2, 2)
        keep = torch.ones((1, ext.shape[1], 1, 1), dtype=ext.dtype,
                          device=ext.device)
        if top:
            keep[:, 0] = 0
        if ext.shape[1] > top + r:
            keep[:, -1] = 0
        return fn(ext * keep).narrow(1, top, r)

    def thin_zeroed(op, x, w, b, rows, io_rows, **kw):
        # the DCGAN generator's output conv (conv_thin) on its slab with
        # the halo rows zeroed
        if w is not thin_w:
            return real_on_slab(op, x, w, b, rows, io_rows, **kw)

        class Zeroed(type(rows)):
            __slots__ = ()

            def halo(self, x, top, bottom):
                return zeroed(x, top, bottom, rows)

        return real_on_slab(op, x, w, b,
                            Zeroed(rows.index, rows.count, rows.group),
                            io_rows, **kw)

    def up_row_zeroed(op, x, w, b, rows, io_rows, **kw):
        # the DCGAN generator's bilinear x2 + conv on its slab with the
        # halo row next to the slab (the one the upsample reads) zeroed
        if op is not bilinear2x_conv:
            return real_on_slab(op, x, w, b, rows, io_rows, **kw)

        class Zeroed(type(rows)):
            __slots__ = ()

            def halo(self, x, top, bottom):
                ext = rows.halo(x, top, bottom)
                t, r = 0 if rows.first else top, x.shape[1]
                keep = torch.ones((1, ext.shape[1], 1, 1), dtype=ext.dtype,
                                  device=ext.device)
                if t:
                    keep[:, t - 1] = 0
                if ext.shape[1] > t + r:
                    keep[:, t + r] = 0
                return ext * keep

        return real_on_slab(op, x, w, b,
                            Zeroed(rows.index, rows.count, rows.group),
                            io_rows, **kw)

    slab_bns = [m for net in nets for m in net.modules()
                if spatial.on_slabs(m) and hasattr(m, "process_group")]
    groups = [m.process_group for m in slab_bns]

    def local_bns(on):
        for m, g in zip(slab_bns, groups):
            m.process_group = None if on else g  # a 1 x n mesh's data group

    def patch(owner, name, fn):
        def put(on, real=getattr(owner, name)):
            setattr(owner, name, fn if on else real)
        return put

    patches = {
        "halo rows zeroed": patch(spatial, "halo_exchange", zeroed),
        "halo shifted by one row": patch(spatial, "halo_exchange", shifted),
        "BatchNorm over the data group only": local_bns,
        "slab dW not summed over 'model'": patch(
            spatial, "sum_slab_grads", lambda net, grads: list(grads)),
        "whole-row dW summed over 'model'": patch(
            spatial, "slab_parameters",
            lambda net: [True] * len(list(net.parameters()))),
        "5x5 halo one row short": patch(spatial.RowShard, "same_conv",
                                        halo_short),
        "DCGAN discriminator's slab dW not summed over 'model'": patch(
            spatial, "sum_slab_grads",
            lambda net, grads: list(grads)
            if isinstance(net, DCGANDiscriminator) else real_sum(net, grads)),
        "conv_thin's halo rows zeroed": patch(spatial, "on_slab",
                                              thin_zeroed),
        "stride-2 crop one row off": patch(spatial.RowShard, "same_conv",
                                           crop_off),
        "stem crop one row off": patch(spatial.RowShard, "same_conv",
                                       stem_crop_off),
        "bilinear x2's halo row zeroed": patch(spatial, "on_slab",
                                               up_row_zeroed),
        "bilinear x2 + 5x5 conv's halo one row short": patch(
            spatial, "upsample_halo",
            lambda k, taps: real_up_halo(k, taps) - (k == 5 and taps == 2)),
    }
    if fault not in patches:
        fail(f"spatial: unknown fault {fault}")
    patches[fault](True)
    try:
        yield
    finally:
        patches[fault](False)


def _sp_rank(rank, world, root, backend):
    _spawned(_sp_work, rank, world, root, backend)


def _sp_work(rank, world, root):
    """One rank of a 1 x world mesh, spawned by spatial_slice (gloo ranks
    sharing the card, or NCCL ranks a card each): the flagship's step on
    each seed of PAR_SEEDS on the mesh, each of SP_FAULTS on the first,
    then one step under each of SP_SWITCHED, one of SP_P2P_EXPERIMENT's
    pix2pix step and one in bf16.  Rank 0 also takes each of those fp32
    steps in one process (timed, its launches counted) and as the twin
    (_sp_twin), the twin under SP_SHARED_FAULTS too, and compares.
    Writes root/sp<r>.json."""
    import numpy as np
    import torch

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.parallel import make_mesh
    from terrain_tpu_torch.parallel.spatial import on_slabs

    strict_fp32()
    out = {"counts": {}, "one_counts": {}, "step_ms": [], "one_ms": [],
           "err": {}, "twin": {}, "faults": {}, "shared_fault_twin": {},
           "finite": True}

    def counted(label, fn, into="counts"):
        _reset_counters()
        r = fn()
        torch.cuda.synchronize()
        c = out[into].setdefault(label, {})
        for k, v in _read_counters().items():
            c[k] = c.get(k, 0) + v
        return r

    def built(experiment, mesh=None, cd=None, bilinear=False):
        setup = build_train(experiment, "cuda", mesh=mesh, compute_dtype=cd,
                            dcgan_bilinear=bilinear)
        _seed_biases(torch, setup)
        return setup, _recorder(setup), _setup_snapshot(setup)

    mesh = make_mesh(n_data=1, n_model=world)

    def stage(experiment, bilinear=False):
        """The step on the mesh, and on rank 0 one process's and the
        twin's; returns (compared(key, label, batch, timed), twin_step,
        setup)."""
        setup, rec, back = built(experiment, mesh, bilinear=bilinear)
        out["slabs_bilinear" if bilinear else "slabs"] = {
            n: sum(on_slabs(m) for m in net.modules())
            for n, net in setup.nets.items()}
        if rank == 0:
            one, rec_one, back_one = built(experiment, bilinear=bilinear)
            twin, rec_twin, back_twin = built(experiment,
                                              bilinear=bilinear)

        def twin_step(batch):
            back_twin()
            with _sp_twin(torch, list(twin.nets.values()), world):
                return _sp_step(torch, twin, rec_twin, batch)

        def compared(key, label, batch, timed=False):
            """This rank's step on the mesh (its launches counted under
            `label`); on rank 0 one process's and the twin's too,
            compared."""
            back()
            t0 = time.perf_counter()
            got = counted(label, lambda: _sp_step(torch, setup, rec, batch))
            if timed:
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["finite"] &= all(np.isfinite(v) for v in got[0].values())
            if rank != 0:
                return None
            back_one()
            t0 = time.perf_counter()
            ref = counted(label,
                          lambda: _sp_step(torch, one, rec_one, batch),
                          "one_counts")
            if timed:
                out["one_ms"].append((time.perf_counter() - t0) * 1e3)
            out["err"][key] = _errors(got, ref)
            out["twin"][key] = _errors(twin_step(batch), ref)
            return ref

        def faulty(fault, batch, ref):
            back()
            with _sp_fault(torch, setup.nets.values(), fault):
                bad = _sp_step(torch, setup, rec, batch)
                if rank == 0 and fault in SP_SHARED_FAULTS:
                    out["shared_fault_twin"][fault] = _errors(
                        twin_step(batch), ref)
            if rank == 0:
                out["faults"][fault] = _errors(bad, ref)

        return setup, compared, faulty

    setup, compared, faulty = stage(SP_EXPERIMENT)
    for seed in PAR_SEEDS:
        batch = _train_batch(torch, TRAIN_BATCH, setup.in_shp,
                             setup.latent_dim, seed)
        ref = compared(f"seed {seed}", "default", batch, timed=True)
        if seed == PAR_SEEDS[0]:
            for fault in SP_FAULTS:
                faulty(fault, batch, ref)
    batch = _train_batch(torch, TRAIN_BATCH, setup.in_shp, setup.latent_dim,
                         PAR_SEEDS[0])
    for label, switches in SP_SWITCHED:
        set_switches(True, switches)
        compared(label, label, batch)
        set_switches(False, switches)
    del setup, compared, faulty, ref
    torch.cuda.empty_cache()
    setup, compared, _ = stage(SP_P2P_EXPERIMENT)
    compared(f"p2p seed {PAR_SEEDS[0]}", "p2p", batch)
    del setup, compared
    torch.cuda.empty_cache()
    setup, compared, faulty = stage(SP_EXPERIMENT, bilinear=True)
    ref = compared(f"bilinear seed {PAR_SEEDS[0]}", "bilinear", batch)
    for fault in SP_BILINEAR_FAULTS:
        faulty(fault, batch, ref)
    del setup, compared, faulty, ref
    torch.cuda.empty_cache()
    bf16, rec16, _ = built(SP_EXPERIMENT, mesh, torch.bfloat16)
    losses = counted("bf16", lambda: _sp_step(torch, bf16, rec16, batch))[0]
    out["finite"] &= all(np.isfinite(v) for v in losses.values())
    with open(os.path.join(root, f"sp{rank}.json"), "w") as f:
        json.dump(out, f)


def spatial_slice(torch, card, world=SP_WORLD, backend="gloo"):
    """Spatial parallelism on a 1 x world mesh: by default SP_WORLD gloo
    ranks sharing the card (a correctness path: gloo stages every
    collective through the host); `spatial4` asks for four NCCL ranks, a
    card each.  Each step against one process to PAR_TWIN x the twin's
    error, the twin to SP_TWIN_TOL, SP_FAULTS failing the first and
    SP_SHARED_FAULTS the second, and each kernel launched on each rank
    as often as in one process (SP_LAUNCHES).  Every reading is printed
    before a failure ends the run.  Returns the ranks' launch counts,
    added."""
    import shutil
    import tempfile

    if torch.cuda.device_count() < (world if backend == "nccl" else 1):
        fail(f"spatial: {world} NCCL ranks need {world} cards, found "
             f"{torch.cuda.device_count()}")
    root = tempfile.mkdtemp(prefix="sp_")
    t0 = time.perf_counter()
    try:
        torch.multiprocessing.spawn(_sp_rank, args=(world, root, backend),
                                    nprocs=world, join=True)
        res = []
        for r in range(world):
            with open(os.path.join(root, f"sp{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = []
    for r, got in enumerate(res):
        print(f"spatial [{card}] {backend} rank {r} of a 1 x {world} mesh "
              f"({SP_EXPERIMENT}, 512px, batch {TRAIN_BATCH}, fp32): "
              f"layers and BatchNorms on slabs "
              f"{got['slabs']} (with the bilinear DCGAN generator "
              f"{got['slabs_bilinear']}); steps (ms, host clock" + (
                  ", a correctness path: gloo stages through the host"
                  if backend == "gloo" else "") + ") "
              + " ".join(f"{t:.1f}" for t in got["step_ms"])
              + (" against one process on one card " + " ".join(
                  f"{t:.1f}" for t in got["one_ms"]) if r == 0 else ""),
              flush=True)
        if not got["finite"]:
            bad.append(f"rank {r}: a non-finite loss")
    what = f"spatial [{card}] {backend} 1 x {world} mesh, fp32"
    for key, err in res[0]["err"].items():
        twin = res[0]["twin"][key]
        bad += _show(f"{what}, {key}: the twin vs one process", twin,
                     _sp_twin_limits(twin))
        bad += _show(f"{what}, {key}: one step vs one process", err,
                     _twin_limits(twin), twin)
    for fault, err in res[0]["faults"].items():
        seed = ("bilinear " if fault in SP_BILINEAR_FAULTS else "") \
            + f"seed {PAR_SEEDS[0]}"
        caught = _over(err, _twin_limits(res[0]["twin"][seed]))
        print(f"spatial [{card}] the planted fault '{fault}' fails the "
              f"comparison on {caught}", flush=True)
        if not caught:
            bad.append(f"the planted fault '{fault}' passes")
    for fault, err in res[0]["shared_fault_twin"].items():
        caught = _over(err, _sp_twin_limits(err))
        print(f"spatial [{card}] the planted fault '{fault}' in the twin "
              f"fails its comparison with one process on {caught}",
              flush=True)
        if not caught:
            bad.append(f"the planted fault '{fault}' passes the twin")
    one = res[0]["one_counts"]
    for r, got in enumerate(res):
        for label, want in SP_LAUNCHES.items():
            c = got["counts"][label]
            steps = SP_STEPS[label]
            print(f"spatial: rank {r}'s launches, {label} ({steps} "
                  f"steps): {c}", flush=True)
            for k, v in want.items():
                if c.get(k, 0) != v * steps:
                    bad.append(f"rank {r} {label}: {k} launched "
                               f"{c.get(k, 0)} times, not {v * steps}")
        for label, c1 in one.items():  # one process's route, on every slab
            for k in SP_KERNELS:
                if got["counts"][label].get(k, 0) != c1.get(k, 0):
                    bad.append(f"rank {r} {label}: {k} "
                               f"{got['counts'][label]} against one "
                               f"process's {c1}")
    print(f"spatial [{card}]: the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        fail(f"spatial: {bad}")
    total = {}
    for got in res:
        for c in got["counts"].values():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


# ----------------------------------------------------------------- nans
# TERRAIN_CHECK_NANS=2 (utils/nan_check.py) on the flagship at full width:
# checked steps and chunks give the unchecked bits; planted NaNs raise
# naming the network, the layer and the step; every kernel is checked.
NAN_SETTINGS = (("default", {}), ("switches on, decoder unfused",
                                  {**SWITCHES, **UNFUSED}))
NAN_EAGER = 2      # checked eager steps held against unchecked ones
NAN_TIME_K = 8     # the bf16 graph's chunk when timed (16 before PR 24)


def _checks_on(on):
    if on:
        os.environ["TERRAIN_CHECK_NANS"] = "2"
    else:
        os.environ.pop("TERRAIN_CHECK_NANS", None)


def _raises_nan(torch, fn, want):
    """fn() must raise FloatingPointError naming every string of `want`;
    returns its message and the seconds it took."""
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    except FloatingPointError as e:
        msg = str(e)
        missing = [w for w in want if w not in msg]
        if missing:
            fail(f"nans: the NaN raised without naming {missing}: {msg}")
        return msg, time.perf_counter() - t0
    fail(f"nans: no FloatingPointError for a planted NaN (want {want})")


def nans_slice(torch, card):
    """The flagship trainer's steps (fp32, 512px, batch 4, augmentation
    on, SCAN_N pairs on the card) under TERRAIN_CHECK_NANS=2, in each of
    NAN_SETTINGS: NAN_EAGER checked eager steps bit-equal to unchecked ones
    from the same state (by default also a TERRAIN_SCAN=SCAN_K chunk,
    checked and unchecked, bit-equal to eager steps); a NaN-poisoned weight
    of p2p_gen's first encoder conv raising eagerly and in the graph,
    naming p2p_gen, enc.0.conv and step 1; a NaN in step 3's prior
    raising in the graph naming step 3.  Then bf16 at
    TERRAIN_SCAN=NAN_TIME_K, the graph checked and unchecked, per step;
    every kernel's outputs
    checked at least once.  Returns the kernels' checked launches."""
    import numpy as np

    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.utils import nan_check

    ds = None
    nan_check.KERNEL_CHECKS.clear()
    # the layer's first op to hold the NaN: the library conv by default, a
    # copy of the weight or the conv_s2 kernel with the switches on
    poison = ["p2p_gen enc.0.conv: ", "(forward)"]
    try:
        for label, switches in NAN_SETTINGS:
            set_switches(True, switches)
            gan, _ = build_gan(EXPERIMENT, "cuda", verbose=False)
            if ds is None:
                ds = DeviceDataset(*make_pairs(SCAN_N, gan.in_shp, seed=0),
                                   device="cuda")
            runs = _ChunkRuns(torch, gan, ds)
            back = _snapshot(gan)
            batches = _chunk(torch, np, gan, ds, SCAN_K, 11)
            got, secs = {}, {}
            ways = [("eager", False), ("eager", True)]
            if label == "default":
                ways += [("graph", False), ("graph", True)]
            for way, checked in ways:
                _checks_on(checked)
                n = NAN_EAGER if way == "eager" else SCAN_K
                back()
                # a first call (the graph's warm-up and capture) off the
                # clock, then from `back` again
                (runs.eager(batches[:1]) if way == "eager"
                 else runs.graph(batches))
                back()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = (runs.eager(batches[:n]) if way == "eager"
                       else runs.graph(batches))
                torch.cuda.synchronize()
                secs[way, checked] = (time.perf_counter() - t0) * 1e3 / n
                got[way, checked] = runs._result(out)
            eager4 = None
            if label == "default":  # SCAN_K unchecked eager steps
                _checks_on(False)
                back()
                eager4 = runs._result(runs.eager(batches))
            for (way, checked), res in got.items():
                want = eager4 if way == "graph" else got["eager", False]
                pairs = list(zip(want[0] + want[1], res[0] + res[1]))
                off = sum(not a.equal(b) for a, b in pairs)
                print(f"nans [{card}] fp32 {label}: {way}"
                      f"{' checked' if checked else ''} "
                      f"({secs[way, checked]:.3f} ms a step, host clock"
                      f"{', the replay' if way == 'graph' else ''}) against "
                      f"unchecked eager steps: {len(pairs) - off} of "
                      f"{len(pairs)} tensors bit-equal", flush=True)
                if off:
                    fail(f"nans {label}: the {way} steps"
                         f"{' under the checks' if checked else ''} are "
                         f"off unchecked eager steps in {off} tensors")
            _checks_on(True)
            back()
            w = gan.nets["p2p_gen"].enc[0].conv.w
            with torch.no_grad():
                w.mul_(float("nan"))
            msg, s = _raises_nan(torch, lambda: runs.eager(batches[:1]),
                                 poison + ["step 1 of 1"])
            print(f"nans {label}: poisoned p2p_gen weight, eager, raised in "
                  f"{s:.2f} s: {msg}", flush=True)
            if label == "default":
                back()
                with torch.no_grad():
                    w.mul_(float("nan"))
                msg, s = _raises_nan(torch, lambda: runs.graph(batches),
                                     poison + [f"step 1 of {SCAN_K}"])
                print(f"nans {label}: poisoned p2p_gen weight, the graph of "
                      f"{SCAN_K} steps, raised in {s:.2f} s: {msg}",
                      flush=True)
                back()
                planted = [tuple(t.clone() for t in b) for b in batches]
                planted[2][0][0, 0] = float("nan")  # step 3's prior
                msg, s = _raises_nan(torch, lambda: runs.graph(planted),
                                     ["dcgan_gen ", f"step 3 of {SCAN_K}"])
                print(f"nans {label}: NaN in step 3's prior, the graph, "
                      f"raised in {s:.2f} s: {msg}", flush=True)
            _checks_on(False)
            set_switches(False, switches)
            del gan, runs, back, batches, got
            _free(torch)
        nans_timing(torch, np, card, ds)
    finally:
        _checks_on(False)
        set_switches(False, SWITCHES)
        set_switches(False, UNFUSED)
    checked = dict(nan_check.KERNEL_CHECKS)
    print(f"nans: each hand-written kernel's checked launches {checked}",
          flush=True)
    missing = [k for k in _counters() if not checked.get(k)]
    if missing:
        fail(f"nans: kernels never checked {missing}")
    del ds
    _free(torch)
    print(f"nans: this process holds "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB of the card after "
          f"the phase", flush=True)
    return checked


def nans_timing(torch, np, card, ds):
    """bf16, default switches, TERRAIN_SCAN=NAN_TIME_K: the graph's
    replay per step, unchecked and checked, in turns (host clock around a
    synchronized chunk; each captured first)."""
    from terrain_tpu_torch.experiments import build_gan

    gan, _ = build_gan(EXPERIMENT, "cuda", compute_dtype=torch.bfloat16,
                       verbose=False)
    runs = _ChunkRuns(torch, gan, ds)
    batches = _chunk(torch, np, gan, ds, NAN_TIME_K, 12)
    per = {False: [], True: []}
    for checked in (False, True, True, False):
        _checks_on(checked)
        if not per[checked]:
            t0 = time.perf_counter()
            runs.graph(batches)  # warm-up and capture
            torch.cuda.synchronize()
            print(f"nans bf16: {'checked ' if checked else ''}capture of "
                  f"{NAN_TIME_K} steps {time.perf_counter() - t0:.1f} s",
                  flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.graph(batches)
        torch.cuda.synchronize()
        per[checked].append((time.perf_counter() - t0) * 1e3 / NAN_TIME_K)
    _checks_on(False)
    print(f"nans [{card}] bf16 TERRAIN_SCAN={NAN_TIME_K} graph per step: "
          f"unchecked {per[False][0]:.3f} / {per[False][1]:.3f} ms, checked "
          f"{per[True][0]:.3f} / {per[True][1]:.3f} ms (host clock, in "
          f"turns)", flush=True)
    del gan, runs, batches
    _free(torch)


# -------------------------------------------------------------- ballast
# One fp32 step of the flagship (512px, batch 4, full width) from one
# seeded state in two fresh processes: one holds the card whole, the other
# first allocates ballast that leaves free only the step's peak (the free
# run's peak reserved) plus BALLAST_MARGIN_MIB, a negative margin: below
# the peak, where cuDNN's FFT engines (up to 9 GiB of workspace) could not
# get theirs before device.strict_fp32 blocked them, and above what the
# step's allocations need (its peak allocated is ~2.3 GiB under its peak
# reserved; at 1 GiB under it the step runs out of memory).  Every
# parameter, BN statistic, optimizer slot and loss must be bit-equal: the
# cuDNN engine a conv takes must not depend on the card's free memory.
BALLAST_MARGIN_MIB = -256
BALLAST_LIMIT_S = 240


def ballast_child(torch, out_path, need_mib):
    """`chip_smoke.py _ballast <out> <MiB>`: one profiled fp32 step, after
    a ballast allocation that leaves `need_mib` MiB beyond what this
    process has reserved (0: no ballast).  Saves the state, the losses,
    the device kernels by name, the peaks and the step ms to `out`."""
    from torch.profiler import ProfilerActivity, profile

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.train.step import step_state

    strict_fp32()
    ts = build_train(EXPERIMENT, "cuda", seed=0, compute_dtype=torch.float32)
    batch = _train_batch(torch, TRAIN_BATCH, ts.in_shp, ts.latent_dim, 7)
    torch.cuda.synchronize()
    ballast = None
    free, total = torch.cuda.mem_get_info()
    if need_mib:
        leave = need_mib * 2**20 - torch.cuda.memory_reserved()
        ballast = torch.empty(max(free - leave, 0), dtype=torch.uint8,
                              device="cuda")
    free_at_step = torch.cuda.mem_get_info()[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        losses = ts.train_step(ts.opt_states, batch, None, ts.lr)
        torch.cuda.synchronize()
    kernels = {ev.key: ev.count for ev in device_rows(prof)}
    state = [t.detach().cpu() for t in step_state(ts.nets, ts.opt_states)]
    out = {"state": state,
           "losses": {k: v.detach().cpu() for k, v in losses.items()},
           "kernels": kernels, "free": free, "total": total,
           "free_at_step": free_at_step,
           "ballast": 0 if ballast is None else ballast.numel(),
           "peak_alloc": torch.cuda.max_memory_allocated(),
           "peak_reserved": torch.cuda.max_memory_reserved()}
    times = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        ts.train_step(ts.opt_states, batch, None, ts.lr)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    out["step_ms"] = statistics.median(times)
    torch.save(out, out_path)
    return 0


def _ballast_run(root, name, need_mib):
    path = os.path.join(root, f"{name}.pt")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "_ballast", path,
         str(need_mib)], capture_output=True, text=True,
        timeout=BALLAST_LIMIT_S)
    if p.returncode != 0:
        fail(f"ballast: the {name} step failed (rc {p.returncode}):\n"
             f"{p.stdout[-3000:]}{p.stderr[-3000:]}")
    import torch

    out = torch.load(path)
    out["wall_s"] = time.perf_counter() - t0
    return out


def ballast_compare(a, b):
    """(tensors that differ, their count, max abs difference, kernels only
    in a, kernels only in b)."""
    import torch

    pairs = list(zip(a["state"], b["state"])) + [
        (a["losses"][k], b["losses"][k]) for k in a["losses"]]
    diff = [(x - y).abs().max().item() for x, y in pairs
            if not torch.equal(x, y)]
    ka, kb = set(a["kernels"]), set(b["kernels"])
    return (len(diff), len(pairs), max(diff, default=0.0), sorted(ka - kb),
            sorted(kb - ka))


def ballast_slice(torch, card):
    """The free run and the ballast run, compared bit for bit; fails unless
    they are equal, and unless the card's cuDNN is the build whose engine
    numbers device.CUDNN_ERRATA names (device.CUDNN_MEASURED: under
    another one the rules could apply to nothing, or to other engines, and
    the check would have to be made again)."""
    import shutil
    import tempfile

    from terrain_tpu_torch.device import CUDNN_ERRATA, CUDNN_MEASURED

    major, minor, patch = torch._C._cudnn.getCompileVersion()
    have = {"compiled": major * 10000 + minor * 100 + patch,
            "runtime": torch.backends.cudnn.version()}
    print(f"ballast [{card}]: cuDNN {have}; {CUDNN_ERRATA}'s engine numbers "
          f"were measured on {CUDNN_MEASURED}", flush=True)
    if have != CUDNN_MEASURED:
        fail(f"ballast: cuDNN {have} is not the build the errata's engine "
             f"numbers were measured on ({CUDNN_MEASURED}); find the FFT "
             f"engines' numbers for it and pin the rules to it")
    root = tempfile.mkdtemp(prefix="ballast_")
    free = _ballast_run(root, "free", 0)
    need = int(free["peak_reserved"] / 2**20) + BALLAST_MARGIN_MIB
    tight = _ballast_run(root, "ballast", need)
    shutil.rmtree(root, ignore_errors=True)
    n, of, err, only_free, only_tight = ballast_compare(free, tight)
    for name, r in (("free", free), ("ballast", tight)):
        print(f"ballast [{card}]: {name} run: {r['free'] / 2**20:.0f} "
              f"of {r['total'] / 2**20:.0f} MiB free before, "
              f"{r['free_at_step'] / 2**20:.0f} at the step (ballast "
              f"{r['ballast'] / 2**20:.0f} MiB), peak allocated "
              f"{r['peak_alloc'] / 2**20:.1f} MiB, reserved "
              f"{r['peak_reserved'] / 2**20:.1f}; fp32 step "
              f"{r['step_ms']:.3f} ms (CUDA events, median of 3); "
              f"{len(r['kernels'])} device kernels; {r['wall_s']:.1f} s",
              flush=True)
    print(f"ballast: {n} of {of} tensors differ (max abs {err:.3e}); "
          f"kernels only in the free run: {only_free}; only in the ballast "
          f"run: {only_tight}", flush=True)
    if n:
        fail(f"ballast: the step's bits depend on the free memory "
             f"({n} of {of} tensors differ)")


# ------------------------------------------------------------ coldstart
# TERRAIN_AOT (utils/aot.py) on the card: the cost of a cold start as the
# port had it (a fresh process to the end of one bf16 eager flagship step,
# the libraries already built, plus the nvcc and g++ builds a cold machine
# adds), then a fresh store filled, a process with no compiler reachable
# taking the same step from it, and a store entry recorded for another
# compute capability: raising in that process, rebuilt with a compiler,
# never loaded.
COLD_LIMIT_S = 300
COLD_ENTRY = "bilinear"  # the store entry given another card's record


def cold_child(torch, out_path, other=None):
    """`chip_smoke.py _cold <out> [<store>]`: one bf16 eager step of the
    flagship (full width, batch 4) in a fresh process; saves the seconds
    of its imports (torch and the package), of building the model and of
    the step, the launch counts, the losses and the compilers it can find.
    With a second store, then builds from it and saves what it raised."""
    t_main = time.perf_counter()
    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.experiments import build_train
    from terrain_tpu_torch.ops.kernels import _build

    strict_fp32()
    ts = build_train(EXPERIMENT, "cuda", seed=0, compute_dtype=torch.bfloat16)
    batch = _train_batch(torch, TRAIN_BATCH, ts.in_shp, ts.latent_dim, 7)
    torch.cuda.synchronize()
    t_built = time.perf_counter()
    _reset_counters()
    losses = ts.train_step(ts.opt_states, batch, None, ts.lr)
    torch.cuda.synchronize()
    out = {"main_s": t_main - T_IMPORT, "built_s": t_built - t_main,
           "step_s": time.perf_counter() - t_built,
           "counts": _read_counters(),
           "losses": {k: float(v) for k, v in losses.items()},
           "compilers": {c: shutil.which(c) for c in
                         ("nvcc", "g++", "c++", "gcc")}}
    if other:
        os.environ["TERRAIN_AOT"] = other
        try:
            _build.build()
            out["other"] = None
        except RuntimeError as e:
            out["other"] = str(e)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def _no_compiler_env(root):
    """os.environ with no compiler reachable: PATH an empty directory,
    CUDA_HOME and CUDA_PATH unset."""
    empty = os.path.join(root, "empty_bin")
    os.makedirs(empty, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = empty
    return env


def _cold_run(root, name, env, *args):
    """The _cold child under `env`: (its result, wall seconds from the
    process's start to its exit, its output)."""
    path = os.path.join(root, f"{name}.json")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "_cold",
                        path, *args], env=env, capture_output=True,
                       text=True, timeout=COLD_LIMIT_S)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        fail(f"coldstart: the {name} step failed (rc {p.returncode}):\n"
             f"{p.stdout[-3000:]}{p.stderr[-3000:]}")
    with open(path) as f:
        return json.load(f), wall, p.stdout


def coldstart_slice(torch, card, build_s):
    """ROADMAP A.7's cold-start cost, then the TERRAIN_AOT store: filled,
    loaded by a process with no compiler, and a mismatched entry never
    loaded.  `build_s`: phase 1's nvcc build of the six sources."""
    import concurrent.futures
    import contextlib
    import ctypes
    import io
    import tempfile

    from terrain_tpu_torch.ops.kernels import _build
    from terrain_tpu_torch.utils import aot

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cold_")
    store = os.path.join(root, "store")
    other = os.path.join(root, "other")
    saved = {k: os.environ.get(k) for k in ("TERRAIN_AOT", "TERRAIN_AOT_KEY")}
    for k in saved:
        os.environ.pop(k, None)
    try:
        # as things stand: the libraries in _build/ (phase 1 built them)
        warm, warm_wall, _ = _cold_run(root, "built", dict(os.environ))
        # the host libraries from nothing, as a cold machine builds them:
        # one g++ a source, all started together
        os.environ["TERRAIN_AOT"] = os.path.join(root, "host_only")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                len(_build.HOST_SOURCES)) as pool:
            built = list(pool.map(
                lambda s: _build.build_host(os.path.join(aot.PACKAGE, s)),
                _build.HOST_SOURCES))
        host_s = time.perf_counter() - t0
        os.environ.pop("TERRAIN_AOT")
        # the later phases load them from _build/ instead of building them
        # again at first use
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        for path in built:
            for f in (path, aot.record_path(path)):
                if not os.path.exists(os.path.join(_build.BUILD_DIR,
                                                   os.path.basename(f))):
                    shutil.copy(f, _build.BUILD_DIR)
        # a fresh store: phase 1's six libraries and the six host ones just
        # built, with their records, then the trainer's fill (every record
        # checked)
        os.makedirs(store)
        for path, _ in _build.build().values():
            for f in (path, aot.record_path(path)):
                shutil.copy(f, store)
        for f in os.listdir(os.path.join(root, "host_only")):
            shutil.copy(os.path.join(root, "host_only", f), store)
        os.environ["TERRAIN_AOT"] = store
        t0 = time.perf_counter()
        paths = aot.fill()
        fill_s = time.perf_counter() - t0
        records = {os.path.basename(p): aot.read_record(p) for p in paths}
        print(f"coldstart [{card}]: the store {sorted(os.listdir(store))}; "
              f"filled in {fill_s:.1f} s (phase 1's six CUDA libraries and "
              f"the six host libraries built above copied in, their records "
              f"checked); a record {records[os.path.basename(paths[0])]}",
              flush=True)
        if len(paths) != len(_build.SOURCES) + len(_build.HOST_SOURCES) or \
                any(r is None for r in records.values()):
            fail(f"coldstart: the store lacks a library or a record: "
                 f"{records}")
        # a copy whose COLD_ENTRY record names another compute capability,
        # its library bytes that cannot load
        shutil.copytree(store, other)
        os.environ["TERRAIN_AOT"] = other
        lib = _build.lib_path(COLD_ENTRY)
        os.environ.pop("TERRAIN_AOT")
        aot.write_record(lib, dict(aot.read_record(lib), capability="8.0",
                                   device="another card"))
        with open(lib, "wb") as f:
            f.write(b"not a library: loading it fails")
        # a process with no compiler: the step from the store, then a
        # build from the other store
        env = _no_compiler_env(root)
        env["TERRAIN_AOT"] = store
        got, got_wall, out = _cold_run(root, "store", env, other)
        want = expected_launches(False)
        bad = {k: (got["counts"].get(k), v) for k, v in want.items()
               if got["counts"].get(k) != v}
        finite = all(v == v and abs(v) != float("inf")
                     for v in got["losses"].values())
        print(f"coldstart [{card}]: a fresh process to the end of one bf16 "
              f"eager step of {EXPERIMENT} (512px, batch {TRAIN_BATCH}): "
              f"libraries built in _build/ {warm_wall:.1f} s (imports "
              f"{warm['main_s']:.1f}, model {warm['built_s']:.1f}, step "
              f"{warm['step_s']:.1f}); a cold machine adds phase 1's nvcc "
              f"build {build_s:.1f} s and the six g++ builds (in parallel) "
              f"{host_s:.1f} s: "
              f"{warm_wall + build_s + host_s:.1f} s; from a TERRAIN_AOT "
              f"store with no compiler reachable (PATH an empty directory, "
              f"CUDA_HOME unset; found {got['compilers']}) {got_wall:.1f} s "
              f"(imports {got['main_s']:.1f}, model {got['built_s']:.1f}, "
              f"step {got['step_s']:.1f}, then the other store's build); "
              f"its launches {got['counts']}", flush=True)
        if any(got["compilers"].values()) or bad or not finite \
                or "rebuilding" in out:
            fail(f"coldstart: the step from the store: compilers "
                 f"{got['compilers']}, launches off {bad}, losses "
                 f"{got['losses']}")
        print(f"coldstart: in that process, the store whose {COLD_ENTRY} "
              f"record names compute capability 8.0: {got['other']}",
              flush=True)
        if not got["other"] or lib not in got["other"] \
                or "8.0" not in got["other"]:
            fail("coldstart: a mismatched entry without a compiler did not "
                 "raise naming it")
        os.environ["TERRAIN_AOT"] = other
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            _build.build((COLD_ENTRY,))
        rebuild_s = time.perf_counter() - t0
        os.environ.pop("TERRAIN_AOT")
        ctypes.CDLL(lib)  # the rebuilt library loads
        new = aot.read_record(lib)
        print(f"coldstart: with nvcc, the same store: "
              f"{text.getvalue().strip()!r} ({rebuild_s:.1f} s); the new "
              f"record's capability {new['capability']}; the phase took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        if f"rebuilding {lib}" not in text.getvalue() \
                or new["capability"] == "8.0":
            fail("coldstart: a mismatched entry was not rebuilt")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


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
               for ev in device_rows(prof)}
    return statistics.median(times), sum(kernels.values()), kernels


def _conv_calls(torch, run):
    """{key: (x shape, w shape, layouts, library fn(x, w), port fn(x, w))}
    of every distinct F.conv2d and F.conv_transpose2d call of DET_STEPS
    fp32 train steps of `run` (bias left out: it moves neither dX nor dW),
    and the stem's conv as check_autograd runs it through its plain
    version.  The port's fn is the library's, except for the convs the
    step sends through ops/conv.Conv5x5 (the accurate dW): those are
    recorded where Conv5x5 is called, their library fn being F.conv2d at
    padding 2, and the F.conv2d inside Conv5x5 is not a call of its
    own."""
    import torch.nn.functional as F

    from terrain_tpu_torch.ops import conv

    calls = {}
    real = {"conv2d": F.conv2d, "conv_transpose2d": F.conv_transpose2d}
    route = conv.Conv5x5.apply
    inside = []

    def layout(t):
        return ("channels_last" if t.dim() == 4 and not t.is_contiguous()
                and t.is_contiguous(memory_format=torch.channels_last)
                else "contiguous")

    def record(kind, x, w, lib, port, args, kwargs):
        key = (f"{kind} x{tuple(x.shape)} {layout(x)} w{tuple(w.shape)}"
               f" {layout(w)} {args} {kwargs}")
        calls.setdefault(key, (tuple(x.shape), tuple(w.shape),
                               (layout(x), layout(w)), lib, port))

    def recording(kind):
        def call(x, w, bias=None, *args, **kwargs):
            if not inside:
                lib = (lambda a, b: real[kind](a, b, None, *args, **kwargs))
                record(kind, x, w, lib, lib, args, kwargs)
            return real[kind](x, w, bias, *args, **kwargs)
        return call

    def routed(x, w):
        record("conv2d Conv5x5", x, w,
               lambda a, b: real["conv2d"](a, b, padding=2), route, (), {})
        inside.append(1)
        try:
            return route(x, w)
        finally:
            inside.pop()

    for kind in real:
        setattr(F, kind, recording(kind))
    conv.Conv5x5.apply = routed
    try:
        run.steps()
    finally:
        for kind, fn in real.items():
            setattr(F, kind, fn)
        conv.Conv5x5.apply = route
    stem = (lambda a, b: F.conv2d(a, b, padding=2))
    calls["conv2d stem x(2, 1, 256, 256) w(64, 1, 5, 5) pad 2"] = (
        (2, 1, 256, 256), (64, 1, 5, 5), ("contiguous", "contiguous"),
        stem, stem)
    return calls


def _accuracy(torch, calls):
    """{key: {setting: [dX error, dW error]}}, each the largest error
    against fp64 gradients over their largest entry, on seeded normal
    inputs; settings "default" and "deterministic" (the library's fn in
    fp32 on cuDNN's default and deterministic algorithms), "fp64" (cuDNN in
    fp64 on its default algorithms) and "port" (the port's fn in fp32
    under the step's deterministic algorithms, with "port_twice": whether
    it gave the same bits twice).  The fp64 reference is cuDNN's on its
    deterministic algorithms on the card (a CPU's fp64 took ~100 s of the
    script on a slow host); on the ACC_ANCHORS calls of fewest operations
    it is held to the CPU's fp64 within ACC_ANCHOR_TOL, else the phase
    fails, and "anchor" holds that difference."""
    gen = torch.Generator().manual_seed(0)
    fmts = {"channels_last": torch.channels_last,
            "contiguous": torch.contiguous_format}
    out = {}
    size = {k: (v[0][0] * v[1][0] * v[1][1] * v[1][2] * v[1][3]
                * v[0][2] * v[0][3]) for k, v in calls.items()}
    anchors = sorted(calls, key=size.get)[:ACC_ANCHORS]
    for key, (xs, ws, layouts, lib, port) in calls.items():
        fan_in = (ws[1] if "transpose" not in key else ws[0]) * ws[2] * ws[3]
        x, w = (torch.randn(shape, generator=gen, dtype=torch.float64)
                .contiguous(memory_format=fmts[f])
                for shape, f in zip((xs, ws), layouts))
        w = w * fan_in ** -0.5
        # the output's shape from meta tensors: a CPU fp64 forward of the
        # step's largest convs took seconds each
        cot = torch.randn(lib(x.to("meta"), w.to("meta")).shape,
                          generator=gen, dtype=torch.float64)

        def grads(fn, dtype, dev):
            xd = x.to(dev, dtype).requires_grad_()  # keeps the layout
            wd = w.to(dev, dtype).requires_grad_()
            return torch.autograd.grad(fn(xd, wd), (xd, wd),
                                       cot.to(dev, dtype))

        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            ref = [r.cpu() for r in grads(lib, torch.float64, "cuda")]
        out[key] = {}
        if key in anchors:
            out[key]["anchor"] = max(
                float((r - c).abs().max() / c.abs().max())
                for r, c in zip(ref, grads(lib, torch.float64, "cpu")))
        for label, fn, dtype, det in (
                ("default", lib, torch.float32, False),
                ("deterministic", lib, torch.float32, True),
                ("fp64", lib, torch.float64, False),
                ("port", port, torch.float32, True)):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=det,
                                            allow_tf32=False):
                got = grads(fn, dtype, "cuda")
                if label == "port":
                    again = grads(fn, dtype, "cuda")
                    out[key]["port_twice"] = all(
                        a.equal(b) for a, b in zip(got, again))
            out[key][label] = [
                float((a.cpu().double() - r).abs().max() / r.abs().max())
                for a, r in zip(got, ref)]
    return out


def accuracy(torch, card):
    """Every distinct library conv of one fp32 flagship step (_conv_calls)
    against fp64 (_accuracy: the card's, held to the CPU's on the smallest
    calls): the port's gradients within
    ACC_ROUTE_TOL where ops/conv.Conv5x5 computes dW (the same bits
    twice), within ACC_TOL elsewhere; the fp32 step (the port's settings)
    with Conv5x5's dW and with cuDNN's, in turns: CUDA-event and profiled
    device times; then Conv5x5's dW (conv5x5_dw) timed beside cuDNN's fp32
    dW on its default and deterministic algorithms at the three shapes
    where cuDNN takes its Winograd dW."""
    import numpy as np

    from terrain_tpu_torch.ops import conv
    from terrain_tpu_torch.ops.conv import conv5x5_dw
    from terrain_tpu_torch.tools import conv5_dw

    run = _DetRun(torch, np, torch.float32)
    # the stem's conv runs the conv_stem kernel on the step's path; its
    # library call is no conv of the step
    calls = {k: v for k, v in _conv_calls(torch, run).items()
             if " stem " not in k}
    regime = conv._conv5x5_regime
    try:
        for label in ("route", "cuDNN's dW", "cuDNN's dW", "route"):
            conv._conv5x5_regime = (regime if label == "route"
                                    else lambda *a: False)
            run.restore()
            ms, dev, _ = _det_step_ms(torch, run)
            print(f"accuracy [{card}] fp32 step, the port's settings, the "
                  f"5x5 convs' dW by the {label}: {ms:.3f} ms (CUDA events, "
                  f"median of {DET_REPS}), profiled device time {dev:.3f} "
                  f"ms", flush=True)
    finally:
        conv._conv5x5_regime = regime
    del run
    torch.cuda.empty_cache()
    bad = []
    acc = _accuracy(torch, calls)
    anchored = {k: v["anchor"] for k, v in acc.items() if "anchor" in v}
    print(f"accuracy: the card's fp64 reference (deterministic cuDNN) "
          f"against the CPU's fp64 on the {len(anchored)} smallest calls: "
          f"largest relative difference {max(anchored.values()):.2e} (limit "
          f"{ACC_ANCHOR_TOL:.0e})", flush=True)
    if len(anchored) < ACC_ANCHORS or \
            max(anchored.values()) > ACC_ANCHOR_TOL:
        bad.append(f"the card's fp64 reference is not the CPU's: {anchored}")
    for key, v in sorted(acc.items(), key=lambda kv: -max(kv[1]["port"])):
        routed = "Conv5x5" in key
        tol = ACC_ROUTE_TOL if routed else ACC_TOL
        twice = (f", same bits twice {v['port_twice']}" if routed
                 else "")
        print(f"accuracy [{card}] {key}: dX, dW relative to fp64: "
              f"port {v['port'][0]:.2e}, {v['port'][1]:.2e} (limit "
              f"{tol:.0e}{twice}); cuDNN fp32 default "
              f"{v['default'][0]:.2e}, {v['default'][1]:.2e}; "
              f"deterministic {v['deterministic'][0]:.2e}, "
              f"{v['deterministic'][1]:.2e}; fp64 {v['fp64'][0]:.2e}, "
              f"{v['fp64'][1]:.2e}", flush=True)
        if max(v["port"]) > tol or (routed and not v["port_twice"]):
            bad.append(key)
    if not any("Conv5x5" in k for k in calls):
        bad.append("no conv of the step went through Conv5x5")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for xs, cout in conv5_dw.shapes()[:3]:
        x = torch.randn(xs, device="cuda", generator=gen).permute(0, 3, 1, 2)
        g = torch.randn(xs[:3] + (cout,), device="cuda",
                        generator=gen).permute(0, 3, 1, 2)
        w = torch.randn((cout, xs[3], 5, 5), device="cuda", generator=gen)
        times = {"route": time_ms(lambda: conv5x5_dw(x, g), reps=10)}
        for label, det in (("cuDNN default", False),
                           ("cuDNN deterministic", True)):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=det,
                                            allow_tf32=False):
                times[label] = time_ms(lambda: torch.ops.aten.
                                       convolution_backward(
                    g, x, w, None, (1, 1), (2, 2), (1, 1), False, (0, 0), 1,
                    (False, True, False)), reps=10)
        print(f"accuracy [{card}] dW of x{tuple(x.shape)} w{tuple(w.shape)}:"
              f" " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + " (CUDA events, median of 10)", flush=True)
        del x, g, w
    torch.cuda.empty_cache()
    if bad:
        fail(f"accuracy: {bad}")


def determinism(torch, card):
    """Run-to-run determinism of the fp32 flagship step in each of
    DET_SETTINGS, what the repairs cost (fp32 and bf16, two rounds of
    opposite order, and the kernels whose device time moved most), and the
    accuracy of cuDNN's and the port's fp32 gradients of every library
    conv of the step against fp64.  Leaves the port's own setting
    (`repaired`)."""
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
        print(f"determinism accuracy [{card}] {key}: dX, dW relative to "
              f"fp64: port {v['port'][0]:.2e}, {v['port'][1]:.2e}; "
              f"cuDNN fp32 default {v['default'][0]:.2e}, "
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
    if sys.argv[1:2] == ["_ballast"]:  # the ballast phase's child process
        return ballast_child(torch, sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["_cold"]:  # the coldstart phase's child process
        return cold_child(torch, *sys.argv[2:4])
    if sys.argv[1:2] == ["_inputs"]:  # the inputs phase's child process
        return inputs_child(torch, sys.argv[2])
    if sys.argv[1:2] == ["_artifacts"]:  # the artifacts phase's child
        return artifacts_child(torch, sys.argv[2])
    if not (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or shutil.which("nvcc")) and os.path.exists(CUDA_NVCC):
        os.environ["CUDA_HOME"] = os.path.dirname(os.path.dirname(CUDA_NVCC))
    only = set(sys.argv[1:])  # e.g. `kernels train`; none = every phase
    unknown = only - PHASES
    if unknown:
        print(f"FAIL: unknown phases {sorted(unknown)}; one of "
              f"{sorted(PHASES)}")
        return 4

    def want(phase):  # "conditioning", "determinism", "tp4" when asked for
        return not only or phase in only

    strict_fp32()
    _memoize_pairs()
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(report)} in {build_s:.1f} s with "
          f"{_build.nvcc_path()}", flush=True)
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
    inputs_launches, artifacts_launches = {}, {}
    world1_launches, tp_launches, spatial_launches = {}, {}, {}
    world1_scan_launches = {}
    if want("coldstart"):
        coldstart_slice(torch, card, build_s)
        print(f"phase coldstart done at {time.perf_counter() - t_start:.0f} "
              f"s", flush=True)
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
    if want("ballast"):
        _free(torch)
        ballast_slice(torch, card)
        print(f"phase ballast done at {time.perf_counter() - t_start:.0f} s",
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
    if want("inputs"):
        inputs_launches = inputs_slice(torch, card)
        print(f"phase inputs done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("artifacts"):
        artifacts_launches = artifacts_slice(torch, card)
        print(f"phase artifacts done at {time.perf_counter() - t_start:.0f} "
              f"s", flush=True)
    if want("scan"):
        scan_launches = scan_slice(torch, card)
        print(f"phase scan done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("nans"):
        nans_slice(torch, card)
        print(f"phase nans done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if want("parallel"):
        world1_launches, world1_scan_launches, parallel_launches = \
            parallel_slice(torch, card)
        print(f"phase parallel done at {time.perf_counter() - t_start:.0f} "
              f"s", flush=True)
    if want("accuracy"):
        accuracy(torch, card)
        print(f"phase accuracy done at {time.perf_counter() - t_start:.0f} "
              f"s", flush=True)
    if want("tp"):
        tp_launches = tp_slice(torch, card)
        print(f"phase tp done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if "tp4" in only:
        tp_slice(torch, card, world=4, backend="nccl")
    if want("spatial"):
        spatial_launches = spatial_slice(torch, card)
        print(f"phase spatial done at {time.perf_counter() - t_start:.0f} s",
              flush=True)
    if "spatial4" in only:
        spatial_slice(torch, card, world=4, backend="nccl")
    if "scan4" in only:
        scan4_slice(torch, card)
    if only:
        print(f"phases {sorted(only)} passed (the trace summaries, the "
              f"traced replays and eager step and train's label check "
              f"{sum(TRACE_WORK_S):.1f} s); run without arguments for the "
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
    # the artifacts phase's interp clip: the served two-stage dispatch
    for name in CLIP_LAUNCHES:
        paths[name].append("artifacts")
    # the raster epochs, the inputs phase's h5 epochs and the TERRAIN_SCAN
    # epoch run the default path;
    # the parallel phase's steps every kernel of the train path (the
    # opt-in ones with the switches on, bilinear with the unfused decoder):
    # "parallel" the two gloo ranks at their local batch of 2 (each rank
    # checked on its own in the phase), "parallel_world1" the world-1
    # NCCL mesh at batch 4, "parallel_world1_scan" the captures of its
    # TERRAIN_SCAN graphs (a warm-up step and the k steps recorded; the
    # replays, which run them, call no wrapper)
    for name in TRAIN_LAUNCHES:
        if name in paths:
            paths[name] += ["raster", "inputs", "scan"]
    for name in meta:
        paths[name] += ["parallel", "parallel_world1",
                        "parallel_world1_scan", "tp"]
    # the spatial phase's steps on slabs: every kernel
    for name in SP_KERNELS:
        paths[name].append("spatial")
    launches = {"serve": serve_launches, "train": train_launches,
                "trainer": trainer_launches, "quality": quality_launches,
                "raster": raster_launches, "inputs": inputs_launches,
                "artifacts": artifacts_launches,
                "scan": scan_launches,
                "parallel": parallel_launches,
                "parallel_world1": world1_launches,
                "parallel_world1_scan": world1_scan_launches,
                "tp": tp_launches,
                "spatial": spatial_launches}
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
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s; "
          f"the trace summaries, the traced replays and eager step and "
          f"train's label check took {sum(TRACE_WORK_S):.1f} s of it (the "
          f"traced epoch's own cost is printed by quality)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

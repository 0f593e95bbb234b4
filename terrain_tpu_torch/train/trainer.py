"""TwoStageGAN -- the two-stage DCGAN -> pix2pix trainer
(terrain_tpu/train/trainer.py), around the eager four-network step.

Public surface kept from terrain_tpu: a constructor taking architecture
factory functions and kwargs dicts, `train(it_train, it_val, batch_size,
num_epochs, out_dir, model_dir, save_every, resume, quick_run,
reduce_on_plateau)`, `save_model`/`load_model(mode, exact)`,
`generate_atob`, `generate_gz`, `generate_interpolation`,
`generate_interpolation_clip`, `train_keys`, and the results.txt CSV schema
(epoch, 5 train losses, 5 valid losses, lr, time, mode).

`train` accepts host iterators (Hdf5Iterator) or DeviceDatasets (uint8 data
on the device; per step the host ships one index vector and the latent
batch), and the paired augmentation runs on the device inside the step
(`da=True`).  Host iterators are read ahead on a worker thread and copied
to the device behind the step (data/prefetch.py; TERRAIN_PREFETCH=0 reads
them in the step loop).  TERRAIN_SWD=1 appends the sample-quality metrics
of every epoch to <out_dir>/swd.txt (eval/), which `gen`, `interp` and the
server read to pick a checkpoint; TERRAIN_PROFILE=<dir> traces the second
epoch (utils/profiling.py).

TERRAIN_SCAN=k runs the epoch over a DeviceDataset in chunks of k steps,
train and eval alike, as terrain_tpu does: on the card each chunk is one
replay of a CUDA graph of its k steps (train/step.py), captured once and
cached per (train or eval, k, dataset, TERRAIN_* switches), with a mesh's
collectives inside when its groups are NCCL's; on the CPU, and over gloo
groups, a plain loop.  Either way the numbers are the per-step path's.

Random streams.  The prior Z comes from `sampler` (default `np.random.rand`,
the global numpy stream) and the epoch order from
`np.random.RandomState(seed)`: both streams are the JAX package's own, so
the two trainers see the same Z and the same batches.  Augmentation and
dropout draw from `torch.Generator`s re-seeded at every step from (seed,
step counter), so the counter alone restores them; their numbers are not
JAX's.  The generators are persistent, five for each step slot of a chunk,
because a CUDA graph draws from the generator objects it was captured
with.

Checkpoints are terrain_tpu/v1 files whose `extra` payload (optimizer
states as terrain_tpu trees, lr, step counter, both numpy RNG states, the
plateau state) lets either package resume the other's run exactly.

Data parallelism (`mesh=parallel.make_mesh()` over a process group, one
rank a device; terrain_tpu's mesh on 'data').  Every rank holds every
network; the data group's first rank's parameters, BN statistics and
optimizer states are broadcast to the others at init and after
`load_model`.  Each rank takes its rows of every global batch: a host
iterator is wrapped in parallel.HostShardIterator (experiments.py), a
DeviceDataset is replicated on every rank and each rank gathers its slice
of the global index batch.  The prior Z is drawn per rank, its own rows
(terrain_tpu trainer.py:379-385); the augmentation's and dropout's draws
are made for the global batch on every rank from the same seeds, each rank
keeping its rows, so a step equals one process's step on the global batch.
The step all-reduces the BatchNorms' statistics, the gradients and the
losses over the data group (train/step.py).  TERRAIN_SCAN chunks an epoch
over a DeviceDataset as without a mesh: the ranks' replicated datasets
are terrain_tpu's single-process mesh, which scans (its host-iterator
streams, which cannot be stacked into a scan, take k = 1 in either
package).  Each chunk draws this rank's prior rows and slices its index
rows step by step, as k single steps do, and on the card every rank
replays one graph with the chunk's collectives in it.  The triggers of a
new capture (an lr change, a load_model, the first chunk of a pass) are
made rank-symmetric by one small all-reduce a chunk (train/step.py
`_replay`: a capture on every rank when the key changed on any), not by
construction alone: an lr change follows losses whose last bits two
model groups need not share.  Every rank writes its results.txt, dumps
and checkpoints, as every terrain_tpu process does.

Tensor parallelism (a mesh with n_model > 1, terrain_tpu's 'model' axis):
each network's wide weights, those whose output features number at least
`tp_min_features` and divide over the model group (terrain_tpu's
tp_shardings rule), hold one contiguous slice a rank, and each such
layer gathers its features in its call (parallel/tp.py); everything else
is replicated.  The optimizer states take the slices' shapes.  The ranks
of a model group hold the same rows of every batch (the data index), so
they draw the same prior, augmentation and dropout.  A checkpoint holds
the full arrays, gathered by every rank (each writes its file), and
loading one takes each rank's slices again, so a checkpoint moves between
meshes, one process and terrain_tpu.  Host iterators are sharded by the
data index (HostShardIterator's process_index=mesh.data_index,
process_count=n_data).

TERRAIN_CHECK_NANS=2 runs every train and eval step, and every chunk's
CUDA graph, under the NaN checks of utils/nan_check.py (the JAX package's
checkify float checks): the first op whose output holds a NaN raises
FloatingPointError naming the step within its chunk, the network, the
layer and the op; k stays as TERRAIN_SCAN chose it.

TERRAIN_AOT=dir (and its TERRAIN_AOT_KEY) keeps the port's built
libraries in `dir` (utils/aot.py): on the card the trainer loads or builds
every one of them there when it is made, so a store filled by one run
starts the next without a compiler.
"""

import glob
import os
from time import time

import numpy as np
import torch

from terrain_tpu_torch.data import (
    DeviceDataset, augment_pair, epoch_index_schedule)
from terrain_tpu_torch.data.prefetch import Prefetcher
from terrain_tpu_torch.device import resolve_device
from terrain_tpu_torch.models import convert, param_count
from terrain_tpu_torch.models.core import describe
from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.parallel.mesh import place
from terrain_tpu_torch.parallel.tp import shard_module
from terrain_tpu_torch.sample import TwoStagePipeline
from terrain_tpu_torch.train import checkpoint as ckpt
from terrain_tpu_torch.train.losses import TRAIN_KEYS
from terrain_tpu_torch.train.optim import get_optimizer
from terrain_tpu_torch.train.schedule import ReduceLROnPlateau
from terrain_tpu_torch.train.step import (
    ACTIVE, NET_NAMES, build_eval_step, build_scan_eval, build_scan_step,
    build_train_step, step_state)
from terrain_tpu_torch.utils.async_writer import AsyncWriter
from terrain_tpu_torch.utils import aot, nan_check
from terrain_tpu_torch.utils.arch_diagram import draw_network
from terrain_tpu_torch.utils.images import (
    convert_to_rgb, save_png_u8, to_u8, write_image_grid)
from terrain_tpu_torch.utils.profiling import trace


def _floatX(x):
    return np.asarray(x, dtype=np.float32)


# the random streams of a step: 0 the paired augmentation, then each
# network's dropout
_STREAMS = ("augment",) + NET_NAMES


def _rgb(a8):
    return np.repeat(a8, 3, axis=-1) if a8.shape[-1] == 1 else a8


class TwoStageGAN:
    """Given pairs [A, B], the DCGAN maps prior samples z -> A and the
    pix2pix GAN synthesizes B from A."""

    train_keys = list(TRAIN_KEYS)

    def __init__(self,
                 gen_fn_dcgan, disc_fn_dcgan, gen_params_dcgan,
                 disc_params_dcgan,
                 gen_fn_p2p, disc_fn_p2p, gen_params_p2p, disc_params_p2p,
                 in_shp, latent_dim, is_a_grayscale, is_b_grayscale,
                 alpha=100, opt="adam", opt_args=None, train_mode="both",
                 reconstruction="l1", sampler=np.random.rand, lsgan=False,
                 verbose=True, seed=0, compute_dtype=None, da=True, mesh=None,
                 lr_mults=None, tp_min_features=256, device=None):
        if train_mode not in ACTIVE:
            raise ValueError(f"train_mode must be one of {sorted(ACTIVE)}")
        if mesh is not None and mesh.ranks.size > 1 \
                and mesh.data_group is None:
            raise ValueError(f"a {mesh.shape} mesh needs a process group: "
                             f"call parallel.initialize() before make_mesh()")
        self.device = resolve_device(device)
        if aot.store_dir() and self.device.type == "cuda":
            aot.fill()  # TERRAIN_AOT: the built libraries, loaded or stored
        self.in_shp = in_shp
        self.latent_dim = latent_dim
        self.is_a_grayscale = is_a_grayscale
        self.is_b_grayscale = is_b_grayscale
        self.train_mode = train_mode
        self.sampler = sampler
        self.verbose = verbose
        self.da = da
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        # the least output features of a weight sharded on 'model'; small
        # test and dryrun configurations lower it to shard real convs
        self.tp_min_features = tp_min_features
        # data parallelism: the data group, and this rank's (index, count)
        # place in every global batch
        self._group = mesh.data_group if mesh is not None else None
        self._shard = ((mesh.data_index, mesh.shape["data"])
                       if self._group is not None else None)

        # one init generator per network, seeded as experiments.build_model
        # seeds the two generators: equal seeds give equal weights
        gens = [torch.Generator().manual_seed(1_000_003 * self.seed + i)
                for i in range(4)]
        kw = [dict(d or {}, compute_dtype=compute_dtype, generator=g)
              for d, g in zip((gen_params_dcgan, disc_params_dcgan,
                               gen_params_p2p, disc_params_p2p), gens)]
        self.nets = {
            "dcgan_gen": gen_fn_dcgan(latent_dim, is_a_grayscale, **kw[0]),
            "dcgan_disc": disc_fn_dcgan(in_shp, is_a_grayscale, **kw[1]),
            "p2p_gen": gen_fn_p2p(in_shp, is_a_grayscale, is_b_grayscale,
                                  **kw[2]),
            "p2p_disc": disc_fn_p2p(in_shp, is_a_grayscale, is_b_grayscale,
                                    **kw[3]),
        }
        for net in self.nets.values():
            net.to(self.device)
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.process_group = self._group
            if hasattr(net, "data_shard"):
                net.data_shard = self._shard
        if verbose:
            for name, net in self.nets.items():
                print(f"{name}: {param_count(net):,} learnable params")
            print(f"train_mode: {train_mode}")

        self.optimizer = get_optimizer(opt, opt_args)
        self.lr = float(self.optimizer.default_lr)
        self._init_opt_states()
        self.sharded = {n: [] for n in self.nets}  # layer names, by net
        self._place_on_mesh()
        self._step_counter = 0
        self._rng_slots = []     # _next_rngs' generators, one dict a slot
        self._sample_rng = None  # _next_generator's
        self._chunks = {}        # _chunk_fn's cache
        self._sched_rnd = np.random.RandomState(self.seed)
        self._plateau = None
        self._writer = None

        self._step_kw = dict(alpha=alpha, lsgan=lsgan,
                             reconstruction=reconstruction)
        self._train_kw = dict(self._step_kw, train_mode=train_mode,
                              lr_mults=lr_mults)
        # host-batch steps: batch = (Z, X, Y), augmented on the device
        self.train_step, self.eval_step = self._build_steps(
            self._host_prepare if da else None)
        # the samplers share the two generator modules with the step
        self.pipeline = TwoStagePipeline(
            self.nets["dcgan_gen"], self.nets["p2p_gen"],
            latent_dim=latent_dim, in_shp=in_shp, device=self.device,
            compute_dtype=compute_dtype)

    def _init_opt_states(self):
        self.opt_states = {
            n: self.optimizer.init(list(self.nets[n].parameters()))
            for n in ACTIVE[self.train_mode]}

    def _place_on_mesh(self):
        """terrain_tpu's _place_on_mesh (trainer.py:777-793): each
        network's wide weights sharded over 'model' at tp_min_features (a
        sharded layer stays so), their optimizer states cut to the slices,
        then every tensor placed over the data group."""
        if self.mesh is None:
            return
        saved = ({n: self._opt_state_to_jax(n) for n in self.opt_states}
                 if self.mesh.shape["model"] > 1 else {})
        new = {n: shard_module(net, self.mesh, self.tp_min_features)
               for n, net in self.nets.items()}
        if any(new.values()):
            for n, names in new.items():
                self.sharded[n] += names
            self.opt_states = {n: self._opt_state_from_jax(n, saved[n])
                               for n in saved}
        self._place()

    def _place(self):
        """Every rank of the data group takes its first rank's parameters
        (slices of the sharded ones: a data group shares one model index),
        BN statistics and optimizer states (terrain_tpu's
        _place_on_mesh)."""
        if self._group is not None:
            place(step_state(self.nets, self.opt_states), self.mesh)

    def _build_steps(self, prepare):
        """(train step, eval step) on `prepare`'s batches, under NaN checks
        when TERRAIN_CHECK_NANS=2 (read here, at build time, as the JAX
        package's _jit_step reads it)."""
        check = nan_check.enabled()
        return (build_train_step(self.nets, self.optimizer, prepare=prepare,
                                 data_group=self._group, check_nans=check,
                                 **self._train_kw),
                build_eval_step(self.nets, prepare=prepare,
                                data_group=self._group, check_nans=check,
                                **self._step_kw))

    # ------------------------------------------------------------- artifacts
    def _submit(self, fn, *args):
        # PNG encoding and file IO on a worker thread, so the card keeps
        # stepping
        if self._writer is None:
            self._writer = AsyncWriter()
        self._writer.submit(fn, *args)

    def flush_artifacts(self):
        """Wait for every submitted artifact, re-raise a job's failure, and
        end the worker thread (the next dump starts a new one)."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()

    # ------------------------------------------------------------------ rng
    def _seed(self, stream):
        return ((self.seed * 1_000_003 + self._step_counter) << 3) + stream

    def _next_rngs(self, slot=0):
        """The step's generators, re-seeded from (seed, step counter):
        "augment" for the paired transform and one per network for its
        dropout.  Each step slot of a chunk keeps its own five generators,
        the same objects at every call (a CUDA graph draws from those it
        was captured with); re-seeding one draws what a new generator with
        the same seed draws."""
        self._step_counter += 1
        while len(self._rng_slots) <= slot:
            self._rng_slots.append({n: torch.Generator(device=self.device)
                                    for n in _STREAMS})
        rngs = self._rng_slots[slot]
        for i, n in enumerate(_STREAMS):
            rngs[n].manual_seed(self._seed(i))
        return rngs

    def _next_generator(self):
        """One generator for a stochastic sampler call."""
        self._step_counter += 1
        if self._sample_rng is None:
            self._sample_rng = torch.Generator(device=self.device)
        return self._sample_rng.manual_seed(self._seed(0))

    @staticmethod
    def _scan_k(n_steps):
        """TERRAIN_SCAN as a chunk size that divides the epoch's step count
        (terrain_tpu/train/trainer.py's rule), with or without a mesh.  The
        numbers do not depend on k: a chunk runs the same steps, as one
        CUDA graph on the card."""
        want = int(os.environ.get("TERRAIN_SCAN", "1") or "1")
        if want <= 1 or n_steps <= 1:
            return 1
        k = min(want, n_steps)
        while n_steps % k:
            k -= 1
        return k

    def _chunk_fn(self, itr, train, k):
        """run(batches, rngs) -> dict of (k,) losses for k steps over the
        DeviceDataset `itr`: the step itself at k = 1, else the chunk of
        train/step.py (one CUDA graph on the card), cached per (train or
        eval, k, dataset, TERRAIN_* switches) so the graph outlives the
        epoch.  lr and the optimizer states are read at each call."""
        switches = tuple(sorted((n, v) for n, v in os.environ.items()
                                if n.startswith("TERRAIN_")))
        key = (train, k, itr, switches)
        fn = self._chunks.get(key)
        if fn is None:
            tr_step, ev_step = self._build_steps(
                itr.make_prepare(augment=self.da, shard=self._shard))
            if train:
                scan = (build_scan_step(tr_step) if k > 1 else
                        lambda o, b, r, lr: tr_step(o, b[0], r[0], lr))
                fn = lambda b, r: scan(self.opt_states, b, r, self.lr)
            else:
                fn = (build_scan_eval(ev_step) if k > 1 else
                      lambda b, r: ev_step(b[0], r[0]))
            self._chunks[key] = fn
        return fn

    def _host_prepare(self, batch, rngs):
        Z, X, Y = batch
        X, Y = augment_pair(rngs["augment"], X, Y, shard=self._shard)
        return Z, X, Y

    # ---------------------------------------------------------------- epochs
    def _put(self, x):
        """A host array of this rank's rows onto its device."""
        return torch.as_tensor(x).to(self.device)

    def _local(self, n):
        """This rank's rows of a global batch of n: a slice (all of it
        without data parallelism)."""
        if self._shard is None:
            return slice(0, n)
        index, count = self._shard
        if n % count:
            raise ValueError(f"the global batch {n} does not divide over "
                             f"{count} data-parallel ranks")
        return slice(index * n // count, (index + 1) * n // count)

    def _sample_z(self, n):
        """The prior for a global batch of n: each rank draws only its own
        rows (terrain_tpu trainer.py:379-385)."""
        rows = self._local(n)
        return self._put(_floatX(self.sampler(rows.stop - rows.start,
                                              self.latent_dim)))

    def _run_epoch(self, itr, batch_size, *, train, quick_run=False):
        """One pass over `itr` (host iterator or DeviceDataset); returns the
        mean of each loss.  TERRAIN_EVAL_STEPS caps the eval pass."""
        recs = []
        cap = None
        if not train:
            v = os.environ.get("TERRAIN_EVAL_STEPS")
            cap = int(v) if v else None
        rows = self._local(batch_size)
        if isinstance(itr, DeviceDataset):
            sched = epoch_index_schedule(itr.N, batch_size, self._sched_rnd)
            steps = sched[:cap] if cap else sched
            if quick_run:
                steps = steps[:1]
            # one rule with or without a mesh: a rank's chunk holds its
            # rows of k global batches (a quick run's one step: k = 1)
            k = self._scan_k(len(steps))
            run = self._chunk_fn(itr, train, k)
            for c in range(0, len(steps), k):
                # one copy of the chunk's k latent batches (drawn as the
                # per-step path draws them, this rank's rows) and one of
                # its k index vectors (this rank's slice)
                Z = self._put(np.stack([_floatX(self.sampler(
                    rows.stop - rows.start, self.latent_dim))
                    for _ in range(k)]))
                idx = self._put(np.stack(steps[c:c + k])[:, rows])
                recs.append(run([itr.batch_args(Z[t], idx[t])
                                 for t in range(k)],
                                [self._next_rngs(t) for t in range(k)]))
        else:
            n_steps = itr.N // batch_size
            if cap:
                n_steps = min(n_steps, cap)
            if quick_run:
                n_steps = min(n_steps, 1)
            for _ in range(n_steps):
                X, Y = next(itr)  # this rank's rows (HostShardIterator)
                n_glob = X.shape[0] * (self._shard[1] if self._shard else 1)
                batch = (self._sample_z(n_glob), self._put(X),
                         self._put(Y))
                rngs = self._next_rngs()
                if train:
                    recs.append(self.train_step(self.opt_states, batch,
                                                 rngs, self.lr))
                else:
                    recs.append(self.eval_step(batch, rngs))
        # one fetch per epoch; every step has equal weight
        return {key: float(np.mean(torch.cat(
                    [r[key].detach().float().reshape(-1) for r in recs])
                    .cpu().numpy()))
                for key in TRAIN_KEYS}

    # ----------------------------------------------------------- train loop
    def train(self, it_train, it_val, batch_size, num_epochs, out_dir,
              model_dir=None, save_every=10, resume=False, quick_run=False,
              reduce_on_plateau=False):
        """Per-epoch train and valid passes, a CSV row, image dumps and
        periodic checkpoints.  `resume`: falsy -> fresh results.txt; a path
        -> append and restore that checkpoint exactly; "auto" -> the newest
        checkpoint under model_dir, if any."""
        header = (["epoch"]
                  + [f"train_{k}" for k in TRAIN_KEYS]
                  + [f"valid_{k}" for k in TRAIN_KEYS]
                  + ["lr", "time", "mode"])
        os.makedirs(out_dir, exist_ok=True)
        if model_dir is not None:
            os.makedirs(model_dir, exist_ok=True)
        start_epoch = 0
        if resume == "auto":
            resume, start_epoch = self._latest_checkpoint(model_dir)
        # built before the resume load so its state can be restored
        self._plateau = cb = (ReduceLROnPlateau(verbose=self.verbose)
                              if reduce_on_plateau else None)
        check_nans = os.environ.get("TERRAIN_CHECK_NANS") == "1"
        profile_dir = os.environ.get("TERRAIN_PROFILE")
        # per-epoch sample quality (SWD pyramid, terrain W1) -> swd.txt
        track_swd = os.environ.get("TERRAIN_SWD") == "1"
        # 1 = dumps every epoch; larger values thin the host-side PNG work
        art_every = int(os.environ.get("TERRAIN_ARTIFACT_EVERY", "1"))
        # per-epoch previews box-averaged by this factor; gen/interp modes
        # stay at full resolution
        art_scale = int(os.environ.get("TERRAIN_ARTIFACT_SCALE", "1"))
        f = open(os.path.join(out_dir, "results.txt"),
                 "w" if not resume else "a")
        own_prefetchers = []
        try:
            if os.environ.get("TERRAIN_PREFETCH", "1") != "0":
                # host batch work (h5 slices, normalization, the copy to the
                # device) overlaps the step; device-resident sets need none
                def wrap(itr):
                    if isinstance(itr, (DeviceDataset, Prefetcher)):
                        return itr
                    p = Prefetcher(itr, size=2, device=self.device)
                    own_prefetchers.append(p)
                    return p

                it_train, it_val = wrap(it_train), wrap(it_val)
            if not resume:
                f.write(",".join(header) + "\n")
                cap = os.environ.get("TERRAIN_EVAL_STEPS")
                if cap:
                    f.write(f"# TERRAIN_EVAL_STEPS={cap}: valid_* averaged "
                            f"over {cap} batches/epoch, not the full split\n")
                f.flush()
                if self.verbose:
                    print(",".join(header))
                self._dump_architectures(out_dir)
            else:
                if self.verbose:
                    print(f"loading weights from: {resume}")
                self.load_model(resume, exact=True)

            def save(epoch):
                if model_dir is not None and epoch % save_every == 0:
                    self.flush_artifacts()
                    self.save_model(os.path.join(model_dir,
                                                 f"{epoch}.model"))

            for e in range(start_epoch, num_epochs):
                t0 = time()
                out = [str(e + 1)]
                if profile_dir and e == start_epoch + 1:
                    with trace(profile_dir, self.device):  # the second epoch
                        train_losses = self._run_epoch(
                            it_train, batch_size, train=True,
                            quick_run=quick_run)
                else:
                    train_losses = self._run_epoch(
                        it_train, batch_size, train=True, quick_run=quick_run)
                if check_nans:
                    bad = [k for k, v in train_losses.items()
                           if not np.isfinite(v)]
                    if bad:
                        raise FloatingPointError(
                            f"non-finite training losses at epoch {e + 1}: "
                            f"{bad}")
                out += [repr(train_losses[k]) for k in TRAIN_KEYS]
                if cb is not None:
                    self.lr = cb.step(self.lr, train_losses["p2p_recon"],
                                      e + 1)
                valid_losses = self._run_epoch(
                    it_val, batch_size, train=False, quick_run=quick_run)
                out += [repr(valid_losses[k]) for k in TRAIN_KEYS]
                out += [repr(self.lr), repr(time() - t0), self.train_mode]
                row = ",".join(out)
                if self.verbose:
                    print(row)
                f.write(row + "\n")
                f.flush()
                if (e + 1) % art_every == 0:
                    self._dump_epoch(it_train, it_val, out_dir, e + 1,
                                     batch_size, art_scale)
                    if track_swd:
                        self._log_swd(it_val, out_dir, e + 1, batch_size)
                save(e + 1)
        finally:
            try:
                for p in own_prefetchers:
                    p.close()
                self.flush_artifacts()
            finally:
                f.close()

    def _dump_epoch(self, it_train, it_val, out_dir, epoch, batch_size,
                    scale):
        if self.train_mode in ("both", "p2p"):
            self._plot_grid_epoch(
                it_val, os.path.join(out_dir, f"out_{epoch}.png"),
                batch_size, scale=scale)
            for itr, name in ((it_train, "dump_train"),
                              (it_val, "dump_valid")):
                self.generate_atob(itr, 1, os.path.join(out_dir, name),
                                   deterministic=False,
                                   batch_size=batch_size, flush=False,
                                   preview_scale=scale)
        if self.train_mode in ("both", "dcgan"):
            self.generate_gz(num_examples=20, batch_size=batch_size,
                             out_dir=os.path.join(out_dir, "dump_a"),
                             deterministic=False, flush=False,
                             preview_scale=scale)

    def _log_swd(self, it_val, out_dir, epoch, batch_size, n=16):
        """Append sample-quality metrics to <out_dir>/swd.txt
        (terrain_tpu/train/trainer.py:612-664), by train_mode: stage 1
        (`swd_*`, then `elev_w1`/`slope_w1` unless TERRAIN_TERRAIN_METRICS=0)
        real heightmaps against G(z), stage 2 (`p2p_swd_*`) real textures
        against G_p2p(real A).  n images, on the device throughout; an
        existing file keeps its header's columns."""
        from terrain_tpu_torch.eval import swd_pyramid, terrain_stats

        if isinstance(it_val, DeviceDataset):
            # one gather of all n rows; more rows than exist would never
            # make a batch (ragged tails drop)
            pairs = list(self._batches_from(it_val, min(n, it_val.N), 1))
        else:
            pairs = list(self._batches_from(it_val, batch_size,
                                            max(n // batch_size, 1)))
        real_a = torch.cat([p[0] for p in pairs])[:n]
        real_b = torch.cat([p[1] for p in pairs])[:n]
        levels = max(1, min(3, int(np.log2(self.in_shp)) - 3))
        # seed 0 every epoch: the same patches and projections, so the
        # trend is comparable across epochs
        out = {}
        if self.train_mode in ("both", "dcgan"):
            z = _floatX(self.sampler(real_a.shape[0], self.latent_dim))
            fake_a = self._z_fn(z, deterministic=True)
            out.update(swd_pyramid(real_a, fake_a, seed=0, n_levels=levels))
            if os.environ.get("TERRAIN_TERRAIN_METRICS", "1") != "0":
                out.update(terrain_stats(real_a, fake_a, seed=0))
        if self.train_mode in ("both", "p2p"):
            fake_b = self._gen_fn(real_a, deterministic=True)
            out.update({f"p2p_{k}": v for k, v in swd_pyramid(
                real_b, fake_b, seed=0, n_levels=levels).items()})
        path = os.path.join(out_dir, "swd.txt")
        if os.path.exists(path):
            with open(path) as g:
                cols = g.readline().strip().split(",")[1:]
        else:
            cols = list(out)  # stage-1 swd_*, terrain W1, then p2p_swd_*
            with open(path, "w") as g:
                g.write("epoch," + ",".join(cols) + "\n")
        with open(path, "a") as g:
            g.write(f"{epoch}," + ",".join(
                repr(out.get(k, float("nan"))) for k in cols) + "\n")

    # -------------------------------------------------------------- batches
    def _batches_from(self, itr, batch_size, n):
        """Yield n (X, Y) device batches from a host iterator or a
        DeviceDataset."""
        if isinstance(itr, DeviceDataset):
            if itr.N < batch_size:
                raise ValueError(
                    f"dataset has {itr.N} rows < batch_size={batch_size}: "
                    "the slice schedule would be empty (ragged tails drop)")
            count = 0
            while count < n:  # cycle epochs like the infinite host iterator
                for idx in epoch_index_schedule(itr.N, batch_size,
                                                self._sched_rnd):
                    if count >= n:
                        break
                    yield itr.gather_normalize(idx)
                    count += 1
        else:
            for _ in range(n):
                X, Y = next(itr)
                yield self._put(X), self._put(Y)

    def _u8(self, x, is_grayscale, scale=1):
        return to_u8(x, is_grayscale, scale).cpu().numpy()

    def _plot_grid_epoch(self, itr, out_path, batch_size, N=4, scale=1):
        """NxN grid of [A, G_p2p(A)] pairs, one PNG.  scale > 1 fetches a
        box-averaged preview (TERRAIN_ARTIFACT_SCALE)."""
        imgs = []
        n_batches = (N * N + batch_size - 1) // batch_size
        for X, _ in self._batches_from(itr, batch_size, n_batches):
            bp = self._gen_fn(X, deterministic=False)
            a8 = _rgb(self._u8(X, self.is_a_grayscale, scale))
            b8 = _rgb(self._u8(bp, self.is_b_grayscale, scale))
            for i in range(a8.shape[0]):
                if len(imgs) < N * N:
                    imgs.append(np.concatenate([a8[i], b8[i]], axis=1)
                                .astype(np.float32) / 255.0)
        grid = np.stack(imgs).reshape((N, N) + imgs[0].shape)
        self._submit(write_image_grid, out_path, grid)

    def _latest_checkpoint(self, model_dir):
        """Newest <epoch>.model under model_dir, or (False, 0) if none."""
        if model_dir is None:
            return False, 0
        models = glob.glob(os.path.join(model_dir, "*.model"))
        if not models:
            return False, 0

        def epoch(p):
            return int(os.path.basename(p).split(".")[0])

        best = max(models, key=epoch)
        return best, epoch(best)

    def _dump_architectures(self, out_dir):
        """arch_<net>.txt (models/core.describe: terrain_tpu's text) and
        arch_<net>.png (utils/arch_diagram.py) for each network, at the
        start of a fresh verbose run (terrain_tpu/train/trainer.py:533).
        The picture keeps terrain_tpu's best-effort contract: without
        matplotlib it is skipped, with one printed line saying so; the
        text is always written."""
        if not self.verbose:
            return
        for name, net in self.nets.items():
            with open(os.path.join(out_dir, f"arch_{name}.txt"), "w") as g:
                g.write(describe(net))
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            print(f"arch_<net>.png skipped: matplotlib does not import "
                  f"({e}); arch_<net>.txt written")
            return
        for name, net in self.nets.items():
            draw_network(net, os.path.join(out_dir, f"arch_{name}.png"))

    # ---------------------------------------------------------- checkpoints
    def _opt_state_to_jax(self, net):
        """terrain_tpu's optimizer state tree: rmsprop's accu, or adam's m,
        v and its step count t, an int32 scalar."""
        return {k: (convert.params_to_jax(self.nets[net], v)
                    if isinstance(v, list)
                    else np.asarray(v.cpu().numpy(), np.int32))
                for k, v in self.opt_states[net].items()}

    def _opt_state_from_jax(self, net, saved):
        return {k: ([t.to(self.device).contiguous() for t in
                     convert.params_from_jax(self.nets[net], v)]
                    if isinstance(v, (dict, list)) else
                    torch.tensor(int(v), dtype=torch.int32,
                                 device=self.device))
                for k, v in saved.items()}

    def save_model(self, filename):
        """A terrain_tpu/v1 checkpoint with the `extra` payload of an exact
        resume: optimizer states, lr, the step counter, the epoch-schedule
        RandomState, the global numpy RNG (the default prior draws from it)
        and the plateau state when enabled."""
        extra = {
            "lr": self.lr,
            "step": self._step_counter,
            "train_mode": self.train_mode,
            "opt_states": {n: self._opt_state_to_jax(n)
                           for n in self.opt_states},
            "sched_rnd": self._sched_rnd.get_state(),
            "np_random": np.random.get_state(),
        }
        if self._plateau is not None:
            extra["plateau"] = {k: getattr(self._plateau, k)
                                for k in ("cooldown_counter", "wait", "best")}
        trees = {n: convert.to_jax(net) for n, net in self.nets.items()}
        ckpt.save_model(filename, {n: t[0] for n, t in trees.items()},
                        {n: t[1] for n, t in trees.items()}, extra=extra)

    def load_model(self, filename, mode="both", exact=False):
        """Restore weights (one stage only via `mode`).  exact=False
        re-initializes the optimizer state (the freeze/fine-tune workflow);
        exact=True (the trainer's resume path) also restores the optimizer
        states, lr, step counter, RNG streams and plateau state from the
        checkpoint's `extra`, so a resumed run continues the trajectory of
        an uninterrupted one."""
        trees, extra = ckpt.load_model(filename, mode)
        for n, (params, state) in trees.items():
            convert.load_jax(self.nets[n], params, state)
        self._init_opt_states()
        if exact and extra:
            self.lr = float(extra.get("lr", self.lr))
            self._step_counter = int(extra.get("step", self._step_counter))
            saved = extra.get("opt_states") or {}
            for n in self.opt_states:
                if n in saved:
                    self.opt_states[n] = self._opt_state_from_jax(n, saved[n])
            if extra.get("sched_rnd") is not None:
                self._sched_rnd.set_state(tuple(extra["sched_rnd"]))
            if extra.get("np_random") is not None:
                np.random.set_state(tuple(extra["np_random"]))
            if extra.get("plateau") and self._plateau is not None:
                for k, v in extra["plateau"].items():
                    setattr(self._plateau, k, v)
        self._place()

    # -------------------------------------------------------------- sampling
    def _z_fn(self, z, deterministic):
        z = self._put(_floatX(z))
        if deterministic:
            return self.pipeline.z_det(z)
        return self.pipeline.z_stoch(z, self._next_generator())

    def _gen_fn(self, x, deterministic):
        x = self._put(x)
        if deterministic:
            return self.pipeline.atob_det(x)
        return self.pipeline.atob_stoch(x, self._next_generator())

    def generate_atob(self, itr, num_batches, out_dir, dont_predict=False,
                      deterministic=True, batch_size=4, flush=True,
                      preview_scale=1):
        """Dump [A, predict(A)] pairs as <i>.a.png / <i>.b.png.
        preview_scale > 1 dumps box-averaged previews."""
        os.makedirs(out_dir, exist_ok=True)
        ctr = 0
        for X, Y in self._batches_from(itr, batch_size, num_batches):
            pred = Y if dont_predict else self._gen_fn(X, deterministic)
            a8 = self._u8(X, self.is_a_grayscale, preview_scale)
            b8 = self._u8(pred, self.is_b_grayscale, preview_scale)
            for i in range(b8.shape[0]):
                self._submit(save_png_u8,
                             os.path.join(out_dir, f"{ctr}.a.png"), a8[i])
                self._submit(save_png_u8,
                             os.path.join(out_dir, f"{ctr}.b.png"), b8[i])
                ctr += 1
        if flush:
            self.flush_artifacts()

    def generate_gz(self, num_examples, batch_size, out_dir,
                    deterministic=True, flush=True, preview_scale=1):
        """Dump DCGAN samples G(z) as <i>.png, in chunks of up to 32 padded
        to whole chunks, as terrain_tpu (the chunk is the batch whose
        statistics a stochastic call normalizes with)."""
        os.makedirs(out_dir, exist_ok=True)
        z = _floatX(self.sampler(num_examples, self.latent_dim))
        chunk = max(batch_size, min(32, num_examples))
        n_chunks = (num_examples + chunk - 1) // chunk
        pad = n_chunks * chunk - num_examples
        if pad:
            z = np.concatenate([z, z[:pad]], axis=0)
        ctr = 0
        for b in range(n_chunks):
            out = self._u8(self._z_fn(z[b * chunk:(b + 1) * chunk],
                                      deterministic),
                           self.is_a_grayscale, preview_scale)
            for i in range(out.shape[0]):
                if ctr >= num_examples:
                    break
                self._submit(save_png_u8,
                             os.path.join(out_dir, f"{ctr}.png"), out[i])
                ctr += 1
        if flush:
            self.flush_artifacts()

    def generate_interpolation(self, out_name, zsample1=None, zsample2=None,
                               deterministic=True, mode="row"):
        """Decoded interpolation between two prior samples, as a 1x6 row or
        a 5x5 matrix grid, one PNG."""
        if mode not in ("row", "matrix"):
            raise ValueError(f"mode must be row or matrix, got {mode!r}")
        if zsample1 is None or zsample2 is None:
            zs = _floatX(self.sampler(2, self.latent_dim))
            zsample1 = zs[0] if zsample1 is None else zsample1
            zsample2 = zs[1] if zsample2 is None else zsample2
        zsample1, zsample2 = _floatX(zsample1), _floatX(zsample2)
        shape = (1, 6) if mode == "row" else (5, 5)
        coefs = ([0.0, 0.1, 0.3, 0.6, 0.9, 1.0] if mode == "row"
                 else np.linspace(0, 1, 25).tolist())
        zbatch = np.stack([(1 - a) * zsample1 + a * zsample2 for a in coefs])
        imgs = self._z_fn(zbatch, deterministic).float().cpu().numpy()
        grid = np.zeros(shape + (self.in_shp, self.in_shp, 3), np.float32)
        for c in range(len(coefs)):
            grid[c // shape[1], c % shape[1]] = convert_to_rgb(
                imgs[c], is_grayscale=self.is_a_grayscale)
        write_image_grid(out_name, grid)

    def generate_interpolation_clip(self, num_samples, batch_size, out_dir,
                                    deterministic=True, min_max_norm=False,
                                    concat=False):
        """Frames of a chained z_1 .. z_n interpolation through the whole
        two-stage pipeline (z -> heightmap -> texture)."""
        os.makedirs(out_dir, exist_ok=True)
        zs = _floatX(self.sampler(num_samples, self.latent_dim))
        coefs = np.linspace(0, 1, 25, dtype=np.float32)
        all_tps = np.concatenate(
            [np.stack([(1 - a) * zs[i] + a * zs[i + 1] for a in coefs])
             for i in range(num_samples - 1)])
        ctr = 0
        for b in range(all_tps.shape[0] // batch_size):
            zb = self._put(all_tps[b * batch_size:(b + 1) * batch_size])
            if deterministic:
                a_out, b_out = self.pipeline.two_stage_det(zb)
            else:
                a_out, b_out = self.pipeline.two_stage_stoch(
                    zb, self._next_generator())
            if min_max_norm:
                # per-frame min-max of the heightmap, on the host
                a = a_out.float().cpu().numpy()
                lo = a.min(axis=(1, 2, 3), keepdims=True)
                hi = a.max(axis=(1, 2, 3), keepdims=True)
                a8 = np.clip(((a - lo) / (hi - lo + 1e-8)) * 255.0 + 0.5,
                             0, 255).astype(np.uint8)
            else:
                a8 = self._u8(a_out, self.is_a_grayscale)
            a8, b8 = _rgb(a8), _rgb(self._u8(b_out, self.is_b_grayscale))
            for i in range(a8.shape[0]):
                d = f"{ctr:04d}"
                if concat:
                    self._submit(save_png_u8,
                                 os.path.join(out_dir, f"concat_{d}.png"),
                                 np.concatenate([a8[i], b8[i]], axis=1))
                else:
                    self._submit(save_png_u8,
                                 os.path.join(out_dir, f"a_{d}.png"), a8[i])
                    self._submit(save_png_u8,
                                 os.path.join(out_dir, f"b_{d}.png"), b8[i])
                ctr += 1
        self.flush_artifacts()

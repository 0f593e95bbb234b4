"""terrain_tpu's experiment registry (terrain_tpu/experiments.py): every
registered name builds its two-stage sampling pipeline (`build_model`), its
trainer (`build_gan`) or the bare pieces of its train step (`build_train`)
on a device, and `run(name, mode)` is what `python -m terrain_tpu_torch
<name> <train|gen|interp>` calls.

Environment, as in terrain_tpu:
  TERRAIN_DATA       path to the paired h5 (xt/yt/xv/yv, uint8 NHWC; default
                     data/textures_v2_brown500.h5), read by data/h5.py without
                     h5py: h5py's files of either libver, contiguous (a
                     memmap of the file), compact or chunked (deflate,
                     shuffle, fletcher32); build one with `python -m
                     terrain_tpu_torch.tools.build_dataset`
  TERRAIN_SYNTHETIC  "1" -> synthetic terrain pairs made in memory
  TERRAIN_N          synthetic train-set size (default 240)
  TERRAIN_EPOCHS     number of epochs (default 1000)
  TERRAIN_BS         batch size (default 4)
  TERRAIN_QUICK      "1" -> one minibatch per loop
  TERRAIN_FAST       "1" -> the dataset lives on the device (DeviceDataset)
  TERRAIN_RASTER     "heightmap.png,texture.jpg" -> random crops cut on the
                     fly from one raster pair (data/crops.py); before the
                     synthetic and h5 sources, TERRAIN_FAST ignored.  PNG,
                     JPEG (MPO), TIFF, BMP, WebP, PNM (PFM, PAM), TGA,
                     JPEG 2000, Radiance HDR, Sun raster, DDS, SGI, PCX,
                     QOI, IM, ICO or ICNS, decoded by the port's own
                     codecs (data/raster.py); GIF and
                     the kinds a codec does not take (lossless or
                     arithmetic-coded JPEG, a JPEG 2000 POC, ...) raise
  TERRAIN_EPOCH_CROPS  crops per train epoch of TERRAIN_RASTER (default
                     240; the valid pass takes a tenth, at least a batch)
  TERRAIN_DTYPE=bf16 bf16 compute over fp32 parameters
  TERRAIN_OUT / TERRAIN_MODELS   artifact roots (default output/, models/)
  TERRAIN_SAVE_EVERY checkpoint cadence in epochs (default 10)
  TERRAIN_RESUME     a checkpoint path, or "auto" for the newest one
  TERRAIN_PICK       checkpoint choice of gen/interp: "swd" (default; the
                     best epoch of the run's swd.txt when there is one),
                     "name" (the experiment's fixed name, else the latest),
                     or an epoch number
  TERRAIN_DISC_OUT   activation of the DCGAN discriminator's final conv
                     (e.g. "linear"), replacing the reference's rectify
  TERRAIN_LR_MULTS   per-network lr multipliers, "net=f,net=f"
  TERRAIN_CHECK_NANS "1" -> stop on a non-finite epoch loss; "2" -> NaN checks
                     of every op's output inside the step (and its CUDA
                     graph), raising at the first (utils/nan_check.py)
  TERRAIN_SWD        "1" -> per-epoch SWD pyramid and terrain W1 -> swd.txt
                     (TERRAIN_TERRAIN_METRICS=0 leaves the W1 columns out)
  TERRAIN_PREFETCH   "0" -> read host iterators in the step loop
  TERRAIN_PROFILE    a directory: a Chrome trace of the second epoch
Under torchrun (more than one process; cli.main initializes the process
group) `run` trains data-parallel over every rank (parallel.make_mesh())
and each rank's host iterators yield its slice of every global batch
(parallel.HostShardIterator), as terrain_tpu's experiments do.
Kernel switches, read at call time, with terrain_tpu's defaults:
  TERRAIN_POOL_VJP=pallas    2x2 max pools run ops/kernels/pool2 (off)
  TERRAIN_PALLAS_CONVS2=1    small-cin 3x3 s2 convs run ops/kernels/conv_s2
                             (off)
  TERRAIN_PALLAS=1           bilinear x2 in regime runs ops/kernels/bilinear
                             (off)
  TERRAIN_RESIZE=dense       bilinear x2 in the separable form (default xla:
                             the library resize)
  TERRAIN_PALLAS_DECODER=0   the U-Net's bilinear stages unfused (on)
  TERRAIN_PALLAS_STEM=0, TERRAIN_PALLAS_THIN=0   one conv kernel off (on)
  TERRAIN_PALLAS_CONV=0      every conv kernel off, the decoder's included
"""

import dataclasses
import glob
import os
from typing import Any, Callable

import numpy as np
import torch

from terrain_tpu_torch.data import (
    DeviceDataset, Hdf5Iterator, RasterCropIterator, h5)
from terrain_tpu_torch.data.raster import (
    check_header, format_by_name, format_of, read_raster)
from terrain_tpu_torch.device import compute_dtype_from_env, resolve_device
from terrain_tpu_torch.models import dcgan, unet
from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.parallel import (
    HostShardIterator, make_mesh, place, shard_rows)
from terrain_tpu_torch.parallel.distributed import process_count
from terrain_tpu_torch.sample import TwoStagePipeline
from terrain_tpu_torch.train import optim
from terrain_tpu_torch.train.checkpoint import pick_best_epoch
from terrain_tpu_torch.train.step import (
    build_eval_step, build_train_step, step_state)
from terrain_tpu_torch.train.trainer import TwoStageGAN
from terrain_tpu_torch.utils import nan_check

_TEST1_DCGAN = {"num_repeats": 0, "div": [2, 2, 4, 4, 8, 8, 8]}
_TEST1_P2P = {"nf": 64, "act": "tanh", "num_repeats": 0}
_TEST1_P2P_DISC = {"nf": 64, "bn": False, "num_repeats": 0, "act": "linear",
                   "mul_factor": [1, 2, 4, 8]}
# every registered experiment: LSGAN, Lasagne rmsprop at lr 1e-4
_OPT = ("rmsprop", {"learning_rate": 1e-4})


def _test1(p2p_bilinear, train_mode="both", disc_out=None):
    p2p = dict(_TEST1_P2P, **({"bilinear_upsample": True}
                              if p2p_bilinear else {}))
    return dict(in_shp=512, latent_dim=1000, dcgan=_TEST1_DCGAN, p2p=p2p,
                dcgan_disc={"num_repeats": 0, "bn": False,
                            "nonlinearity": "linear",
                            "div": [8, 4, 4, 4, 2, 2, 2]},
                p2p_disc=_TEST1_P2P_DISC, train_mode=train_mode,
                disc_out=disc_out)


def _smoke():
    return dict(in_shp=64, latent_dim=32,
                dcgan={"nch": 64, "h": 3, "initial_size": 4,
                       "final_size": 64, "div": [2, 2, 4, 4]},
                p2p={"nf": 8, "act": "tanh", "bilinear_upsample": True},
                dcgan_disc={"nch": 64, "h": 3, "div": [4, 2, 2, 1],
                            "bn": False, "nonlinearity": "linear"},
                p2p_disc={"nf": 8, "bn": False, "act": "linear"},
                train_mode="both", disc_out=None)


def _earth():
    return dict(in_shp=128, latent_dim=256,
                dcgan={"nch": 128, "h": 5, "initial_size": 4,
                       "final_size": 128, "div": [2, 2, 4, 4, 8]},
                p2p={"nf": 32, "act": "tanh", "bilinear_upsample": True},
                dcgan_disc={"nch": 128, "h": 5, "div": [8, 4, 4, 2, 2],
                            "bn": False, "nonlinearity": "linear"},
                p2p_disc={"nf": 32, "bn": False, "act": "linear"},
                train_mode="both", disc_out=None)


def _earth256(train_mode="both", disc_out=None):
    return dict(in_shp=256, latent_dim=1000,
                dcgan={"num_repeats": 0, "final_size": 256,
                       "div": [2, 2, 4, 4, 8, 8]},
                p2p={"nf": 64, "act": "tanh", "num_repeats": 0,
                     "bilinear_upsample": True},
                dcgan_disc={"num_repeats": 0, "bn": False, "nch": 256,
                            "nonlinearity": "linear",
                            "div": [8, 4, 4, 4, 2, 2]},
                p2p_disc=_TEST1_P2P_DISC, train_mode=train_mode,
                disc_out=disc_out)


# experiment name -> (configuration, artifact dir name)
_CONFIGS = {
    "test1_nobn": (_test1(False), "test1_repeatnod_fixp2p_nobn"),
    "test1_nobn_finetunep2p_bilin": (
        _test1(True, train_mode="p2p"),
        "test1_repeatnod_fixp2p_nobn_finetunep2p_bilin"),
    "test1_nobn_bilin_both": (_test1(True), "test1_nobn_bilin_both"),
    "test1_nobn_bilin_both_stable": (
        _test1(True, disc_out="linear"), "test1_nobn_bilin_both_stable"),
    "smoke_synthetic": (_smoke(), "smoke_synthetic"),
    "earth_demo": (_earth(), "earth_demo"),
    "earth256": (_earth256(), "earth256"),
    "earth256_stable": (_earth256(disc_out="linear"), "earth256_stable"),
    "earth256_finetunep2p": (
        _earth256(train_mode="p2p", disc_out="linear"),
        "earth256_finetunep2p"),
}
EXPERIMENTS = tuple(_CONFIGS)


def _config(experiment):
    try:
        return _CONFIGS[experiment]
    except KeyError:
        raise KeyError(
            f"no model for experiment {experiment!r}; one of "
            f"{sorted(_CONFIGS)}") from None


def _generators(cfg, cd, seed):
    gens = [torch.Generator().manual_seed(1_000_003 * seed + i)
            for i in range(4)]
    gd = dcgan.default_generator(cfg["latent_dim"], True, compute_dtype=cd,
                                 generator=gens[0], **cfg["dcgan"])
    gp = unet.g_unet(cfg["in_shp"], True, False, compute_dtype=cd,
                     generator=gens[1], **cfg["p2p"])
    return gd, gp, gens


def build_model(experiment, device=None, *, seed=0, compute_dtype=None):
    """(TwoStagePipeline, artifact-dir name) for a registered experiment,
    with seeded weights, on `device` (default: the card; raises without
    one).  Raises KeyError for unknown names."""
    cfg, name = _config(experiment)
    dev = resolve_device(device)
    cd = compute_dtype or compute_dtype_from_env(os.environ)
    gd, gp, _ = _generators(cfg, cd, seed)
    pipe = TwoStagePipeline(gd, gp, latent_dim=cfg["latent_dim"],
                            in_shp=cfg["in_shp"], device=dev,
                            compute_dtype=cd)
    return pipe, name


def stability_overrides(environ):
    """(discriminator kwargs, lr_mults) from TERRAIN_DISC_OUT and
    TERRAIN_LR_MULTS; both off by default."""
    disc_kw, lr_mults = {}, None
    v = environ.get("TERRAIN_DISC_OUT")
    if v:
        disc_kw["conv_out_nonlinearity"] = v
    v = environ.get("TERRAIN_LR_MULTS")
    if v:
        lr_mults = {}
        for pair in v.split(","):
            name, eq, mult = pair.partition("=")
            if not eq or not name.strip():
                raise ValueError(
                    f"TERRAIN_LR_MULTS entry {pair!r}: expected name=float, "
                    'e.g. "dcgan_disc=0.5,p2p_disc=0.5"')
            lr_mults[name.strip()] = float(mult)
    return disc_kw, lr_mults


def build_gan(experiment, device=None, *, seed=0, compute_dtype=None,
              verbose=True, da=True, mesh=None, dcgan_bilinear=False):
    """(TwoStageGAN, artifact-dir name) for a registered experiment, with
    seeded weights on `device` (default: the card; raises without one).
    The generators get the weights `build_model` gives them for the same
    seed.  `mesh` (parallel.make_mesh) trains over its ranks: data-parallel
    on 'data', tensor-parallel on 'model' (TwoStageGAN's default
    tp_min_features).  `dcgan_bilinear`: the DCGAN generator with
    terrain_tpu's `bilinear_upsample` factory option (the same parameter
    tree; no registered experiment sets it)."""
    cfg, name = _config(experiment)
    if dcgan_bilinear:
        cfg = dict(cfg, dcgan=dict(cfg["dcgan"], bilinear_upsample=True))
    cd = compute_dtype or compute_dtype_from_env(os.environ)
    disc_kw, lr_mults = stability_overrides(os.environ)
    if cfg["disc_out"] is not None:
        disc_kw.setdefault("conv_out_nonlinearity", cfg["disc_out"])
    gan = TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan=cfg["dcgan"],
        disc_params_dcgan={**cfg["dcgan_disc"], **disc_kw},
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        gen_params_p2p=cfg["p2p"], disc_params_p2p=cfg["p2p_disc"],
        in_shp=cfg["in_shp"], latent_dim=cfg["latent_dim"],
        is_a_grayscale=True, is_b_grayscale=False, lsgan=True,
        opt=_OPT[0], opt_args=_OPT[1], train_mode=cfg["train_mode"],
        compute_dtype=cd, verbose=verbose, seed=seed, da=da,
        lr_mults=lr_mults, device=device, mesh=mesh)
    return gan, name


@dataclasses.dataclass
class TrainSetup:
    """What `build_train` hands back: the four networks on the device, the
    optimizer with one state per trained network, and the ready steps.
    `train_step(opt_states, (Z, X, Y), rngs, lr)` updates the networks and
    `opt_states` in place and returns the five losses."""
    name: str
    nets: dict
    optimizer: optim.Optimizer
    opt_states: dict
    train_step: Callable[..., Any]
    eval_step: Callable[..., Any]
    lr: float
    train_mode: str
    in_shp: int
    latent_dim: int
    device: torch.device


def build_train(experiment, device=None, *, seed=0, compute_dtype=None,
                mesh=None, dcgan_bilinear=False):
    """The bare training pieces of a registered experiment, without data,
    augmentation or the epoch loop: the trainer's networks, optimizer and
    host-batch steps.

    `mesh` (parallel.make_mesh over a process group; any registered
    experiment): spatial parallelism.  The four networks hold their
    images in slabs of rows over the model group (parallel.shard_rows),
    every BatchNorm takes the data group, the state is placed over the
    mesh, and the steps of the experiment's own train_mode take this
    rank's data block of each global batch, whole images, of which they
    keep this rank's rows: each returns one process's losses.
    `dcgan_bilinear`: as build_gan's."""
    gan, name = build_gan(experiment, device, seed=seed,
                          compute_dtype=compute_dtype, verbose=False,
                          da=False, dcgan_bilinear=dcgan_bilinear)
    train_step, eval_step = gan.train_step, gan.eval_step
    if mesh is not None:
        train_step, eval_step = _spatial_steps(gan, mesh)
    return TrainSetup(
        name=name, nets=gan.nets, optimizer=gan.optimizer,
        opt_states=gan.opt_states, train_step=train_step,
        eval_step=eval_step, lr=gan.lr, train_mode=gan.train_mode,
        in_shp=gan.in_shp, latent_dim=gan.latent_dim, device=gan.device)


def _spatial_steps(gan, mesh):
    """gan's four networks row-sharded over `mesh` and its state placed
    there; returns its (train step, eval step) over the mesh."""
    data = mesh.data_group if mesh.shape["data"] > 1 else None
    for net in gan.nets.values():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.process_group = data
        if hasattr(net, "data_shard") and data is not None:
            net.data_shard = (mesh.data_index, mesh.shape["data"])
    for net in gan.nets.values():
        shard_rows(net, mesh)
    place(step_state(gan.nets, gan.opt_states), mesh)
    step_kw = dict(alpha=gan._step_kw["alpha"], lsgan=gan._step_kw["lsgan"],
                   reconstruction=gan._step_kw["reconstruction"],
                   spatial_mesh=mesh, check_nans=nan_check.enabled())
    return (build_train_step(gan.nets, gan.optimizer,
                             train_mode=gan.train_mode,
                             lr_mults=gan._train_kw["lr_mults"], **step_kw),
            build_eval_step(gan.nets, **step_kw))


# ------------------------------------------------------------------- data
def get_iterators(dataset, batch_size, is_a_grayscale, is_b_grayscale):
    """Host-iterator pair over an h5 file (xt/yt/xv/yv, uint8 NHWC), read by
    data/h5.py: a contiguous dataset is a memmap of the file, so a batch
    reads its rows only.  Augmentation is the trainer's, on the device."""
    kw = dict(is_a_grayscale=is_a_grayscale, is_b_grayscale=is_b_grayscale)
    with h5.File(dataset) as f:
        return (Hdf5Iterator(f["xt"], f["yt"], batch_size, **kw),
                Hdf5Iterator(f["xv"], f["yv"], batch_size, **kw))


def get_device_datasets(dataset, is_a_grayscale, is_b_grayscale, device=None):
    """Device-resident dataset pair from an h5 file."""
    with h5.File(dataset) as f:
        return (DeviceDataset(np.array(f["xt"]), np.array(f["yt"]),
                              is_a_grayscale, is_b_grayscale, device=device),
                DeviceDataset(np.array(f["xv"]), np.array(f["yv"]),
                              is_a_grayscale, is_b_grayscale, device=device))


def read_raster_pair(value):
    """TERRAIN_RASTER="heightmap.png,texture.jpg" -> (heightmap, texture),
    each a PNG, JPEG (MPO), TIFF, BMP, WebP, PNM (PFM, PAM), TGA, JPEG
    2000, Radiance HDR, Sun raster, DDS, SGI, PCX, QOI, IM, ICO or ICNS
    decoded by the port's codecs
    (data/raster.py) to imageio's array, then taken as
    terrain_tpu/experiments.py:111-114 takes it: the heightmap's first
    channel where it has channels (a WebP always has three), the
    texture's first three; the crop iterator then casts both to uint8 as
    terrain_tpu's does (a uint16 or int32 wraps, a bool gives 0/1, a
    float truncates).  A file named or starting as another format (GIF)
    raises NotImplementedError, by name before any file is opened, by its
    first bytes before either is decoded; so does a file whose header
    names a variant its codec does not take (a JPEG-compressed TIFF, a PAM
    with alpha, a JPEG 2000 POC or palette), and a JPEG of another kind as
    it is decoded (data/jpeg.py)."""
    paths = value.split(",")
    if len(paths) != 2:
        raise ValueError(f"TERRAIN_RASTER={value!r}: expected "
                         f'"heightmap.png,texture.jpg"')
    for path in paths:
        format_by_name(path)
    fmts = [format_of(path) for path in paths]
    for path, fmt in zip(paths, fmts):
        check_header(path, fmt)
    hm, tex = (read_raster(path, fmt) for path, fmt in zip(paths, fmts))
    if hm.ndim == 3:
        hm = hm[..., 0]
    return hm, tex[..., :3]


def _shard_hosts(pair):
    """More than one process: each takes a disjoint slice of every global
    batch (host iterators only; a DeviceDataset is replicated, and the
    trainer gathers each rank's rows), terrain_tpu/experiments.py:87-97."""
    if process_count() <= 1:
        return pair
    return tuple(it if isinstance(it, DeviceDataset) else
                 HostShardIterator(it) for it in pair)


def _get_data(in_shp, is_a_grayscale=True, is_b_grayscale=False, device=None):
    """Train and valid inputs from the environment: random crops of a raster
    pair (host iterators), or synthetic or h5 pairs, as host iterators or
    (TERRAIN_FAST=1) on the device; under more than one process, each
    host iterator yields this process's rows (`_shard_hosts`)."""
    return _shard_hosts(_sources(in_shp, is_a_grayscale, is_b_grayscale,
                                 device))


def _sources(in_shp, is_a_grayscale, is_b_grayscale, device):
    env = os.environ.get
    fast = env("TERRAIN_FAST") == "1"
    bs = int(env("TERRAIN_BS", "4"))
    kw = dict(is_a_grayscale=is_a_grayscale, is_b_grayscale=is_b_grayscale)
    raster = env("TERRAIN_RASTER")
    if raster:  # terrain_tpu/experiments.py:104-124
        hm, tex = read_raster_pair(raster)
        n = int(env("TERRAIN_EPOCH_CROPS", "240"))
        return (RasterCropIterator(hm, tex, bs, crop=in_shp, epoch_size=n,
                                   seed=0, **kw),
                RasterCropIterator(hm, tex, bs, crop=in_shp,
                                   epoch_size=max(n // 10, bs), seed=1, **kw))
    if env("TERRAIN_SYNTHETIC") == "1":
        from terrain_tpu_torch.data.synthetic import make_pairs

        n = int(env("TERRAIN_N", "240"))
        pairs = (make_pairs(n, in_shp, seed=0),
                 make_pairs(max(n // 10, 4), in_shp, seed=1))
        if fast:
            return tuple(DeviceDataset(x, y, device=device, **kw)
                         for x, y in pairs)
        return tuple(Hdf5Iterator(x, y, bs, **kw) for x, y in pairs)
    path = env("TERRAIN_DATA", "data/textures_v2_brown500.h5")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset {path!r} not found -- set TERRAIN_DATA to a paired h5 "
            "(xt/yt/xv/yv, uint8 NHWC) or set TERRAIN_SYNTHETIC=1")
    if fast:
        return get_device_datasets(path, is_a_grayscale, is_b_grayscale,
                                   device)
    return get_iterators(path, bs, is_a_grayscale, is_b_grayscale)


def _epoch_of(path):
    return int(os.path.basename(path).split(".")[0])


def _resolve_model(model_dir, preferred=None, out_dir=None,
                   metric="swd_mean"):
    """The checkpoint for gen/interp modes and the server
    (terrain_tpu/experiments.py:152-193).  TERRAIN_PICK=swd (default): the
    quality-best epoch of the run's swd.txt under `out_dir`, when there is
    one; TERRAIN_PICK=name (and the fall-back of swd): `preferred` when it
    exists, else the latest epoch; TERRAIN_PICK=<epoch>: exactly that saved
    checkpoint."""
    pick = os.environ.get("TERRAIN_PICK", "swd")
    models = glob.glob(os.path.join(model_dir, "*.model"))
    if pick.isdigit():
        cand = os.path.join(model_dir, f"{int(pick)}.model")
        if not os.path.exists(cand):
            raise FileNotFoundError(
                f"TERRAIN_PICK={pick}: no {cand}; saved epochs: "
                + ", ".join(map(str, sorted(map(_epoch_of, models)))))
        return cand
    if out_dir is not None and pick == "swd":
        best = pick_best_epoch(out_dir, model_dir, metric=metric)
        if best is not None:
            path, _, best_epoch, value = best
            print(f"[pick] {metric} best @e{best_epoch} ({value:.4f}) -> "
                  f"checkpoint {os.path.basename(path)} "
                  f"(TERRAIN_PICK=name for the fixed name)")
            return path
    if preferred:
        cand = os.path.join(model_dir, preferred)
        if os.path.exists(cand):
            return cand
    if not models:
        raise FileNotFoundError(f"no checkpoints under {model_dir}")
    return max(models, key=_epoch_of)


# ------------------------------------------------------------------ modes
def _out_root():
    return os.environ.get("TERRAIN_OUT", "output")


def _models_root():
    return os.environ.get("TERRAIN_MODELS", "models")


def _run(model, name):
    env = os.environ.get
    it_train, it_val = _get_data(model.in_shp, model.is_a_grayscale,
                                 model.is_b_grayscale, model.device)
    model.train(it_train, it_val, batch_size=int(env("TERRAIN_BS", "4")),
                num_epochs=int(env("TERRAIN_EPOCHS", "1000")),
                out_dir=os.path.join(_out_root(), name),
                model_dir=os.path.join(_models_root(), name),
                save_every=int(env("TERRAIN_SAVE_EVERY", "10")),
                resume=env("TERRAIN_RESUME", False),
                quick_run=env("TERRAIN_QUICK") == "1")


def _load(model, name, preferred, *, mode="both", metric="swd_mean",
          use_swd=True):
    out_dir = os.path.join(_out_root(), name) if use_swd else None
    model.load_model(_resolve_model(os.path.join(_models_root(), name),
                                    preferred, out_dir=out_dir,
                                    metric=metric), mode=mode)


# What each experiment's modes do beyond `train`: the checkpoint name the
# reference hardcodes, whether gen/interp consult swd.txt, generate_gz's
# (examples, batch) and generate_interpolation_clip's (samples, batch).
_MODES = {
    "test1_nobn": dict(preferred="600.model", gz=(100, 10)),
    "test1_nobn_bilin_both": dict(preferred="600.model", gz=(100, 10),
                                  clip=(10, 4)),
    "test1_nobn_bilin_both_stable": dict(preferred="600.model", gz=(100, 10),
                                         clip=(10, 4)),
    "smoke_synthetic": dict(preferred="2.model", use_swd=False, gz=(8, 4),
                            clip=(3, 4)),
    "earth_demo": dict(preferred="100.model", use_swd=False, gz=(32, 8),
                       clip=(4, 4)),
    "earth256": dict(preferred="600.model", gz=(100, 10), clip=(10, 4)),
    "earth256_stable": dict(preferred="600.model", gz=(100, 10),
                            clip=(10, 4)),
}
# fine-tune experiments: the DCGAN is loaded from `base`'s run and frozen,
# only the p2p stage trains
_FINETUNE = {
    "test1_nobn_finetunep2p_bilin": dict(
        base="test1_nobn", preferred="1000.model",
        clip_dir="interp_clip_600_concat_bothdet", gen=False),
    "earth256_finetunep2p": dict(
        base="earth256_stable", preferred="600.model",
        clip_dir="interp_clip_concat_bothdet", gen=True),
}
# environment defaults an experiment sets for itself
_ENV_DEFAULTS = {
    # the default save cadence (10) would outlive the 2-epoch run and leave
    # no checkpoint for the experiment's own gen/interp modes
    "smoke_synthetic": {"TERRAIN_SYNTHETIC": "1", "TERRAIN_N": "16",
                        "TERRAIN_EPOCHS": "2", "TERRAIN_SAVE_EVERY": "2"},
    **{n: {"TERRAIN_DATA": "data/earth256.h5", "TERRAIN_FAST": "1",
           "TERRAIN_EPOCHS": "600"}
       for n in ("earth256", "earth256_stable", "earth256_finetunep2p")},
}


def _run_finetune(model, name, mode, spec):
    base_name = _config(spec["base"])[1]
    if mode == "gen" and not spec["gen"]:
        raise ValueError(f"terrain_tpu defines no gen mode for this "
                         f"experiment ({name})")
    _load(model, base_name, spec["preferred"], mode="dcgan")
    if mode == "train":
        _run(model, name)
        return
    _load(model, name, spec["preferred"], mode="p2p", metric="p2p_swd_mean")
    out = os.path.join(_out_root(), name)
    if mode == "gen":
        model.generate_gz(100, 10, os.path.join(out, "gen"))
    else:
        model.generate_interpolation_clip(
            100, 4, os.path.join(out, spec["clip_dir"]), concat=True,
            deterministic=True)


def run(experiment, mode, device=None):
    """`python -m terrain_tpu_torch <experiment> <mode>`: train, or load a
    checkpoint and write samples (gen) or a latent interpolation (interp)
    under TERRAIN_OUT/<name>/."""
    if mode not in ("train", "interp", "gen"):
        raise ValueError(f"mode must be train, interp or gen, got {mode!r}")
    _config(experiment)
    for k, v in _ENV_DEFAULTS.get(experiment, {}).items():
        os.environ.setdefault(k, v)
    mesh = make_mesh() if process_count() > 1 else None
    model, name = build_gan(experiment, device, mesh=mesh)
    if experiment in _FINETUNE:
        _run_finetune(model, name, mode, _FINETUNE[experiment])
        return
    if mode == "train":
        _run(model, name)
        return
    spec = _MODES[experiment]
    use_swd = spec.get("use_swd", True)
    out = os.path.join(_out_root(), name)
    if mode == "gen":
        _load(model, name, spec["preferred"], use_swd=use_swd)
        model.generate_gz(*spec["gz"], os.path.join(out, "gen"))
    elif "clip" in spec:
        _load(model, name, spec["preferred"], metric="both", use_swd=use_swd)
        model.generate_interpolation_clip(
            *spec["clip"], os.path.join(out, "interp_clip"), concat=True)
    else:  # test1_nobn: one 5x5 matrix between two prior samples
        _load(model, name, spec["preferred"], use_swd=use_swd)
        zs = model.sampler(2, model.latent_dim)
        model.generate_interpolation(os.path.join(out, "interp.png"),
                                     zs[0], zs[1], mode="matrix")

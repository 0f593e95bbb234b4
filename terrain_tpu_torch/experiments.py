"""terrain_tpu's experiment registry (terrain_tpu/experiments.py:226-411):
every registered name builds its two-stage sampling pipeline
(`build_model`) or its four networks with the optimizer and a ready train
step (`build_train`) on a device.  The trainer and the CLI are not ported
yet.

Environment, as in terrain_tpu:
  TERRAIN_DTYPE=bf16   bf16 compute over fp32 parameters;
  TERRAIN_DISC_OUT     activation of the DCGAN discriminator's final conv
                       (e.g. "linear"), replacing the reference's rectify;
  TERRAIN_LR_MULTS     per-network lr multipliers, "net=f,net=f".
"""

import dataclasses
import os
from typing import Any, Callable

import torch

from terrain_tpu_torch.device import compute_dtype_from_env, resolve_device
from terrain_tpu_torch.models import dcgan, unet
from terrain_tpu_torch.sample import TwoStagePipeline
from terrain_tpu_torch.train import optim, step

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


@dataclasses.dataclass
class TrainSetup:
    """What `build_train` hands back: the four networks on the device, the
    optimizer with one state per network, and the ready steps.
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


def build_train(experiment, device=None, *, seed=0, compute_dtype=None):
    """The training half of a registered experiment: its four networks with
    seeded weights on `device` (default: the card; raises without one), the
    optimizer, and the train and eval steps.  The generators get the same
    weights as `build_model` gives them for the same seed."""
    cfg, name = _config(experiment)
    dev = resolve_device(device)
    cd = compute_dtype or compute_dtype_from_env(os.environ)
    disc_kw, lr_mults = stability_overrides(os.environ)
    if cfg["disc_out"] is not None:
        disc_kw.setdefault("conv_out_nonlinearity", cfg["disc_out"])
    gd, gp, gens = _generators(cfg, cd, seed)
    nets = {
        "dcgan_gen": gd,
        "dcgan_disc": dcgan.default_discriminator(
            cfg["in_shp"], True, compute_dtype=cd, generator=gens[2],
            **cfg["dcgan_disc"], **disc_kw),
        "p2p_gen": gp,
        "p2p_disc": unet.discriminator(
            cfg["in_shp"], True, False, compute_dtype=cd, generator=gens[3],
            **cfg["p2p_disc"]),
    }
    for net in nets.values():
        net.to(dev)
    opt = optim.get_optimizer(*_OPT)
    kw = dict(alpha=100.0, lsgan=True, reconstruction="l1")
    return TrainSetup(
        name=name, nets=nets, optimizer=opt,
        opt_states=step.init_opt_states(nets, opt),
        train_step=step.build_train_step(
            nets, opt, train_mode=cfg["train_mode"], lr_mults=lr_mults, **kw),
        eval_step=step.build_eval_step(nets, **kw),
        lr=opt.default_lr, train_mode=cfg["train_mode"],
        in_shp=cfg["in_shp"], latent_dim=cfg["latent_dim"], device=dev)

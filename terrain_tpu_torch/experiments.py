"""Generator half of terrain_tpu's experiment registry
(terrain_tpu/experiments.py:243-411): every registered name builds its
two-stage sampling pipeline on a device.  Training entry points come with
the trainer slice.

TERRAIN_DTYPE=bf16 selects bf16 compute over fp32 params, as in terrain_tpu.
"""

import os

import torch

from terrain_tpu_torch.device import compute_dtype_from_env, resolve_device
from terrain_tpu_torch.models import dcgan, unet
from terrain_tpu_torch.sample import TwoStagePipeline

_TEST1_DCGAN = {"num_repeats": 0, "div": [2, 2, 4, 4, 8, 8, 8]}
_TEST1_P2P = {"nf": 64, "act": "tanh", "num_repeats": 0}


def _test1(p2p_bilinear):
    p2p = dict(_TEST1_P2P, **({"bilinear_upsample": True}
                              if p2p_bilinear else {}))
    return dict(in_shp=512, latent_dim=1000, dcgan=_TEST1_DCGAN, p2p=p2p)


def _smoke():
    return dict(in_shp=64, latent_dim=32,
                dcgan={"nch": 64, "h": 3, "initial_size": 4,
                       "final_size": 64, "div": [2, 2, 4, 4]},
                p2p={"nf": 8, "act": "tanh", "bilinear_upsample": True})


def _earth():
    return dict(in_shp=128, latent_dim=256,
                dcgan={"nch": 128, "h": 5, "initial_size": 4,
                       "final_size": 128, "div": [2, 2, 4, 4, 8]},
                p2p={"nf": 32, "act": "tanh", "bilinear_upsample": True})


def _earth256():
    return dict(in_shp=256, latent_dim=1000,
                dcgan={"num_repeats": 0, "final_size": 256,
                       "div": [2, 2, 4, 4, 8, 8]},
                p2p={"nf": 64, "act": "tanh", "num_repeats": 0,
                     "bilinear_upsample": True})


# experiment name -> (generator configuration, artifact dir name)
_GEN_CONFIGS = {
    "test1_nobn": (_test1(False), "test1_repeatnod_fixp2p_nobn"),
    "test1_nobn_finetunep2p_bilin": (
        _test1(True), "test1_repeatnod_fixp2p_nobn_finetunep2p_bilin"),
    "test1_nobn_bilin_both": (_test1(True), "test1_nobn_bilin_both"),
    "test1_nobn_bilin_both_stable": (
        _test1(True), "test1_nobn_bilin_both_stable"),
    "smoke_synthetic": (_smoke(), "smoke_synthetic"),
    "earth_demo": (_earth(), "earth_demo"),
    "earth256": (_earth256(), "earth256"),
    "earth256_stable": (_earth256(), "earth256_stable"),
    "earth256_finetunep2p": (_earth256(), "earth256_finetunep2p"),
}
EXPERIMENTS = tuple(_GEN_CONFIGS)


def build_model(experiment, device=None, *, seed=0, compute_dtype=None):
    """(TwoStagePipeline, artifact-dir name) for a registered experiment,
    with seeded weights, on `device` (default: the card; raises without
    one).  Raises KeyError for unknown names."""
    try:
        cfg, name = _GEN_CONFIGS[experiment]
    except KeyError:
        raise KeyError(
            f"no model for experiment {experiment!r}; one of "
            f"{sorted(_GEN_CONFIGS)}") from None
    dev = resolve_device(device)
    cd = compute_dtype or compute_dtype_from_env(os.environ)
    gens = [torch.Generator().manual_seed(1_000_003 * seed + i)
            for i in range(2)]
    gd = dcgan.default_generator(cfg["latent_dim"], True, compute_dtype=cd,
                                 generator=gens[0], **cfg["dcgan"])
    gp = unet.g_unet(cfg["in_shp"], True, False, compute_dtype=cd,
                     generator=gens[1], **cfg["p2p"])
    pipe = TwoStagePipeline(gd, gp, latent_dim=cfg["latent_dim"],
                            in_shp=cfg["in_shp"], device=dev,
                            compute_dtype=cd)
    return pipe, name

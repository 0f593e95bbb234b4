"""Samplers (terrain_tpu/sample/samplers.py) and the two-stage pipeline.

Each factory returns (det, stoch): `det` uses the running BN statistics and
no dropout (Lasagne deterministic=True); `stoch` uses batch statistics and
live dropout drawn from an explicit `torch.Generator`.  All run under
`torch.inference_mode()` and leave the running statistics unchanged.
"""

import torch

from terrain_tpu_torch.models import convert
from terrain_tpu_torch.train import checkpoint


def make_z_sampler(gd):
    @torch.inference_mode()
    def det(z):
        return gd(z, train=False)

    @torch.inference_mode()
    def stoch(z, generator):
        return gd(z, train=True, generator=generator)

    return det, stoch


def make_atob_sampler(gp):
    @torch.inference_mode()
    def det(x):
        return gp(x, train=False)

    @torch.inference_mode()
    def stoch(x, generator):
        return gp(x, train=True, generator=generator)

    return det, stoch


def split_generator(generator):
    """Two independent generators on `generator`'s device, seeded from it:
    the two stages draw independently, as the JAX sampler's key split
    (samplers.py:31-37)."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    return tuple(torch.Generator(device=generator.device).manual_seed(s)
                 for s in seeds)


def make_two_stage_sampler(gd, gp):
    @torch.inference_mode()
    def det(z):
        a = gd(z, train=False)
        return a, gp(a, train=False)

    @torch.inference_mode()
    def stoch(z, generator):
        g1, g2 = split_generator(generator)
        a = gd(z, train=True, generator=g1)
        return a, gp(a, train=True, generator=g2)

    return det, stoch


class TwoStagePipeline:
    """The two generators of a two-stage model on one device, with their
    samplers: z -> heightmap (dcgan_gen), heightmap -> texture (p2p_gen).
    Weights come from seeded init, a terrain_tpu/v1 checkpoint
    (`load_model`) or terrain_tpu trees (`load_jax`)."""

    NETS = ("dcgan_gen", "p2p_gen")

    def __init__(self, dcgan_gen, p2p_gen, *, latent_dim, in_shp, device,
                 compute_dtype=None):
        self.device = torch.device(device)
        self.dcgan_gen = dcgan_gen.to(self.device)
        self.p2p_gen = p2p_gen.to(self.device)
        self.latent_dim = int(latent_dim)
        self.in_shp = int(in_shp)
        self.compute_dtype = compute_dtype
        self.z_det, self.z_stoch = make_z_sampler(self.dcgan_gen)
        self.atob_det, self.atob_stoch = make_atob_sampler(self.p2p_gen)
        self.two_stage_det, self.two_stage_stoch = make_two_stage_sampler(
            self.dcgan_gen, self.p2p_gen)

    def module(self, net):
        return {"dcgan_gen": self.dcgan_gen, "p2p_gen": self.p2p_gen}[net]

    def load_jax(self, params, states):
        """Load the generators present in terrain_tpu `params`/`states`
        dicts keyed by net name."""
        for net in self.NETS:
            if net in params:
                convert.load_jax(self.module(net), params[net], states[net])
        return self

    def to_jax(self):
        trees = {net: convert.to_jax(self.module(net)) for net in self.NETS}
        return ({n: t[0] for n, t in trees.items()},
                {n: t[1] for n, t in trees.items()})

    def load_model(self, path, mode="both"):
        """Restore the generator(s) of the stage(s) `mode` selects from a
        terrain_tpu/v1 checkpoint; discriminators are not part of serving."""
        trees, _ = checkpoint.load_model(path, mode)
        gens = {n: t for n, t in trees.items() if n in self.NETS}
        return self.load_jax({n: t[0] for n, t in gens.items()},
                             {n: t[1] for n, t in gens.items()})

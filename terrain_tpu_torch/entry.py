"""Entry points (the repository root's __graft_entry__.py, for the port).

entry():             the flagship's two-stage forward (test1_nobn_bilin_both:
                     512px, latent 1000, z -> heightmap -> texture),
                     deterministic, bf16 compute, batch 1, with example
                     arguments, on the card.
dryrun_multichip(n): n gloo ranks on the CPU, spawned, each running the
                     full four-network train step on tiny shapes over a
                     ('data', 'model') mesh of n ranks (the counterpart of
                     terrain_tpu's virtual CPU mesh): n_model 2 when n is
                     even and >= 4, as terrain_tpu's, with conv weights of
                     16 or more outputs sharded over 'model'.

    python -m terrain_tpu_torch.entry [n]     # dryrun_multichip(n), n = 2
"""

import os
import sys
import tempfile

import numpy as np
import torch

IN_SHP, LATENT = 64, 32  # __graft_entry__.py's dryrun shapes


def entry(device=None):
    """Returns (fn, example_args): fn(dcgan_gen, p2p_gen, z) ->
    (heightmap, texture), the deterministic two-stage forward at batch 1
    with bf16 compute, its modules seeded, on `device` (default: the card;
    raises without one)."""
    from terrain_tpu_torch.device import resolve_device
    from terrain_tpu_torch.models import dcgan, unet

    dev = resolve_device(device)
    bf16 = torch.bfloat16
    g = dcgan.default_generator(
        1000, True, div=[2, 2, 4, 4, 8, 8, 8], num_repeats=0,
        compute_dtype=bf16, generator=torch.Generator().manual_seed(0))
    u = unet.g_unet(512, True, False, nf=64, act="tanh", num_repeats=0,
                    bilinear_upsample=True, compute_dtype=bf16,
                    generator=torch.Generator().manual_seed(1))

    @torch.inference_mode()
    def fn(dcgan_gen, p2p_gen, z):
        heightmap = dcgan_gen(z, train=False)
        return heightmap, p2p_gen(heightmap, train=False)

    z = torch.from_numpy(np.random.RandomState(0).rand(1, 1000)
                         .astype(np.float32)).to(dev)
    return fn, (g.to(dev), u.to(dev), z)


def _tiny_gan(mesh):
    from terrain_tpu_torch.models import dcgan, unet
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    return TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan={"nch": 64, "h": 3, "initial_size": 4,
                          "final_size": IN_SHP, "div": [2, 2, 4, 4]},
        disc_params_dcgan={"nch": IN_SHP, "h": 3, "div": [4, 2, 2, 1],
                           "bn": False, "nonlinearity": "linear"},
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        gen_params_p2p={"nf": 8, "act": "tanh", "bilinear_upsample": True},
        disc_params_p2p={"nf": 8, "bn": False, "act": "linear"},
        in_shp=IN_SHP, latent_dim=LATENT, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": 1e-4}, train_mode="both", verbose=False,
        mesh=mesh, device="cpu",
        # terrain_tpu's dryrun width: the convs of 16 or more outputs shard
        tp_min_features=16)


def _dryrun_step(rank, n_model):
    """One step of the global batch 2 * n_data over the device-resident
    data path (the dataset on every rank, each gathering its rows), with
    weights of 16 or more output features sharded over 'model'
    (terrain_tpu's dryrun width), of which at least one must be a
    conv's."""
    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from terrain_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_model=n_model)
    gan = _tiny_gan(mesh)
    convs = [m for net in gan.nets.values() for m in net.modules()
             if hasattr(m, "shard") and m.shard is not None
             and m.w.dim() == 4]
    if n_model > 1 and not convs:
        raise AssertionError("dryrun must shard at least one conv "
                             "weight on 'model'")
    bs = 2 * mesh.shape["data"]
    ds = DeviceDataset(*make_pairs(2 * bs, IN_SHP, seed=0), device="cpu")
    step, _ = gan._build_steps(ds.make_prepare(augment=gan.da,
                                               shard=gan._shard))
    z = gan._sample_z(bs)
    idx = torch.arange(bs)[gan._local(bs)]
    losses = step(gan.opt_states, ds.batch_args(z, idx),
                  gan._next_rngs(), gan.lr)
    for k, v in losses.items():
        if not torch.isfinite(v).all():
            raise FloatingPointError(f"rank {rank}: loss {k} = {v}")


def _dryrun_rank(rank, world, n_model, rendezvous):
    """One rank of dryrun_multichip: `_dryrun_step` in a process group
    (parallel.distributed.run_rank)."""
    from terrain_tpu_torch.parallel.distributed import run_rank

    torch.set_num_threads(1)
    run_rank(f"file://{rendezvous}", world, rank, _dryrun_step, rank,
             n_model)


def dryrun_multichip(n_devices, n_model=None):
    """One full four-network train step on tiny shapes over an (n_devices
    / n_model, n_model) mesh of n_devices gloo ranks on the CPU, each its
    own spawned process; n_model None is terrain_tpu's choice, 2 when
    n_devices is even and >= 4, else 1.  Raises if a rank fails, a loss
    is not finite, or a mesh on 'model' shards no conv."""
    if n_model is None:
        n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if n_devices % n_model:
        raise ValueError(f"{n_devices} ranks do not divide by n_model = "
                         f"{n_model}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _dryrun_rank, args=(n_devices, n_model,
                                os.path.join(tmp, "rendezvous")),
            nprocs=n_devices, join=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print("dryrun_multichip OK")

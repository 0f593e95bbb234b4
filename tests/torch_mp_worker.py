"""One gloo rank of tests/test_torch_multiprocess.py, spawned with
torch.multiprocessing: it imports torch and terrain_tpu_torch only.

`run_rank(rank, world, rendezvous, out_dir)` joins the process group
through a file:// rendezvous and writes out_dir/rank<r>.pkl with:
  * "step_da", "step_jax": one data-parallel train step of the tiny nets
    (tests/test_parallel.py's) on this rank's rows of GLOBAL_BATCH, with
    the paired augmentation (its draws made for the global batch) and
    without it: the losses and every network's parameters afterwards, as
    terrain_tpu trees;
  * "bn": the synced BatchNorm's output and input gradient on this rank's
    rows of BN_X under the cotangent's rows of BN_G;
and trains 2 epochs of tests/tiny_cfg.py's model and streams through
HostShardIterator into out_dir/w<r>/results.txt, and 2 epochs of it with
the paired augmentation over N_PAIRS pairs held on the device into
out_dir/d<r>/results.txt; then `python -m terrain_tpu_torch smoke_synthetic
train` (cli.main) into out_dir/m<r>.
"""

import os
import pickle

import numpy as np
import torch

IN, LAT = 16, 8
GLOBAL_BATCH = 4
LR = 1e-4
SEED = 3
BN_SHAPE = (4, 4, 4, 3)  # a global batch of 4 rows, 3 channels
N_PAIRS = 8


def nets_kw():
    """tests/test_parallel.py's tiny configuration, for the port."""
    from terrain_tpu_torch.models import dcgan, unet

    return dict(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan={"nch": 8, "h": 3, "initial_size": 4,
                          "final_size": IN, "div": [2, 2]},
        disc_params_dcgan={"nch": IN, "h": 3, "div": [4, 2], "bn": False,
                           "nonlinearity": "linear"},
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        gen_params_p2p={"nf": 4, "act": "tanh"},
        disc_params_p2p={"nf": 4, "bn": False, "act": "linear"},
        in_shp=IN, latent_dim=LAT, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": LR}, train_mode="both", verbose=False,
        seed=SEED, device="cpu")


def global_batch():
    r = np.random.RandomState(0)
    return (r.rand(GLOBAL_BATCH, LAT).astype(np.float32),
            r.rand(GLOBAL_BATCH, IN, IN, 1).astype(np.float32),
            (r.rand(GLOBAL_BATCH, IN, IN, 3) * 2 - 1).astype(np.float32))


def bn_inputs():
    r = np.random.RandomState(1)
    return (r.randn(*BN_SHAPE).astype(np.float32) * 2 + 0.5,
            r.randn(*BN_SHAPE).astype(np.float32),
            (0.5 + r.rand(BN_SHAPE[-1])).astype(np.float32),
            r.randn(BN_SHAPE[-1]).astype(np.float32))


def one_step(gan, batch, rows=slice(None)):
    """One train step of `gan` on `rows` of the global (Z, X, Y); returns
    (losses, {net: terrain_tpu params tree})."""
    from terrain_tpu_torch.models import convert

    losses = gan.train_step(
        gan.opt_states, tuple(torch.from_numpy(a[rows]) for a in batch),
        gan._next_rngs(), LR)
    return ({k: float(v) for k, v in losses.items()},
            {n: convert.to_jax(net)[0] for n, net in gan.nets.items()})


def _bn(rank, world, group):
    from terrain_tpu_torch.ops.norm import batch_norm
    from terrain_tpu_torch.parallel import host_batch_slice

    x, g, gamma, beta = bn_inputs()
    rows = host_batch_slice(BN_SHAPE[0], process_index=rank,
                            process_count=world)
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    c = BN_SHAPE[-1]
    y, _ = batch_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                      torch.zeros(c), torch.ones(c), train=True, group=group)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g[rows]))
    return y.detach().numpy(), dx.numpy()


def run_rank(rank, world, rendezvous, out_dir):
    import torch.distributed as dist

    from terrain_tpu_torch.parallel import (HostShardIterator, initialize,
                                            make_mesh)
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    torch.set_num_threads(1)
    os.environ["TERRAIN_ARTIFACT_EVERY"] = "999"  # no image dumps
    assert initialize(f"file://{rendezvous}", world, rank,
                      backend="gloo") == (rank, world)
    try:
        mesh = make_mesh()
        out = {}
        rows = slice(rank * GLOBAL_BATCH // world,
                     (rank + 1) * GLOBAL_BATCH // world)
        for key, da in (("step_da", True), ("step_jax", False)):
            gan = TwoStageGAN(**nets_kw(), da=da, mesh=mesh)
            out[key] = one_step(gan, global_batch(), rows)
        out["bn"] = _bn(rank, world, mesh.data_group)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)

        from tiny_cfg import GlobalStream, det_sampler

        gan = TwoStageGAN(**tiny_kw(det_sampler(rank)), mesh=mesh)
        gan.train(HostShardIterator(GlobalStream()),
                  HostShardIterator(GlobalStream()), batch_size=GLOBAL_BATCH,
                  num_epochs=2, out_dir=os.path.join(out_dir, f"w{rank}"),
                  save_every=999)
        gan = TwoStageGAN(**tiny_kw(det_sampler(rank), da=True), mesh=mesh)
        ds = device_pairs()
        gan.train(ds, ds, batch_size=GLOBAL_BATCH, num_epochs=2,
                  out_dir=os.path.join(out_dir, f"d{rank}"), save_every=999)

        # the CLI under a process group: experiments.run builds the mesh
        # and shards its host iterators
        from terrain_tpu_torch import cli

        os.environ.update(TERRAIN_OUT=os.path.join(out_dir, f"cli{rank}"),
                          TERRAIN_MODELS=os.path.join(out_dir, f"m{rank}"))
        assert cli.main(["smoke_synthetic", "train", "--device", "cpu"]) == 0
    finally:
        dist.destroy_process_group()


def tiny_kw(sampler, da=False):
    """tests/tiny_cfg.py's build_model, for the port."""
    kw = nets_kw()
    kw.update(seed=0, da=da, sampler=sampler)
    return kw


def device_pairs():
    """N_PAIRS synthetic pairs held on the device (every rank's whole
    dataset: each gathers its rows of the global batch)."""
    from terrain_tpu_torch.data import DeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs

    return DeviceDataset(*make_pairs(N_PAIRS, IN, seed=0), device="cpu")

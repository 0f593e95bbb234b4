"""One gloo rank of tests/test_torch_multiprocess.py, spawned with
torch.multiprocessing: it imports torch and terrain_tpu_torch only.

`run_rank(rank, world, rendezvous, out_dir)` joins the process group
through a file:// rendezvous (tests/torch_spawn.py) and saves, each as
it ends:
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
out_dir/d<r>/results.txt; the same at TERRAIN_SCAN=2 (each pass one chunk
of 2 steps) into out_dir/d2<r>, and without the augmentation at
TERRAIN_SCAN=1 and 2 into out_dir/j1<r> and out_dir/j2<r>, saving
"scan": the chunk sizes the chunked runs took, the backends of the
step's process groups, whether the step runs as a graph on CPU tensors
(train/step.py's rule) and train/step._on_any_rank over the step's
groups with the flag raised on the last rank only and on none; then
`python -m terrain_tpu_torch smoke_synthetic train` (cli.main) into
out_dir/m<r>.
"""

import os

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


def _work(rank, world, out_dir):
    import torch.distributed as dist

    from terrain_tpu_torch.parallel import HostShardIterator, make_mesh
    from terrain_tpu_torch.train.trainer import TwoStageGAN
    from torch_spawn import save

    assert (dist.get_rank(), dist.get_world_size()) == (rank, world)
    mesh = make_mesh()
    rows = slice(rank * GLOBAL_BATCH // world,
                 (rank + 1) * GLOBAL_BATCH // world)
    for key, da in (("step_da", True), ("step_jax", False)):
        gan = TwoStageGAN(**nets_kw(), da=da, mesh=mesh)
        save(out_dir, key, rank, one_step(gan, global_batch(), rows))
    save(out_dir, "bn", rank, _bn(rank, world, mesh.data_group))

    from tiny_cfg import GlobalStream, det_sampler

    gan = TwoStageGAN(**tiny_kw(det_sampler(rank)), mesh=mesh)
    gan.train(HostShardIterator(GlobalStream()),
              HostShardIterator(GlobalStream()), batch_size=GLOBAL_BATCH,
              num_epochs=2, out_dir=os.path.join(out_dir, f"w{rank}"),
              save_every=999)
    ds = device_pairs()
    ks = set()
    for name, da, scan in (("d", True, "1"), ("d2", True, "2"),
                           ("j1", False, "1"), ("j2", False, "2")):
        os.environ["TERRAIN_SCAN"] = scan
        gan = TwoStageGAN(**tiny_kw(det_sampler(rank), da=da), mesh=mesh)
        gan.train(ds, ds, batch_size=GLOBAL_BATCH, num_epochs=2,
                  out_dir=os.path.join(out_dir, f"{name}{rank}"),
                  save_every=999)
        if scan == "2":
            ks |= {key[1] for key in gan._chunks}
    del os.environ["TERRAIN_SCAN"]
    save(out_dir, "scan", rank, _scan_rule(gan, ds, ks, rank, world))

    # the CLI under a process group: experiments.run builds the mesh
    # and shards its host iterators
    from terrain_tpu_torch import cli

    os.environ.update(TERRAIN_OUT=os.path.join(out_dir, f"cli{rank}"),
                      TERRAIN_MODELS=os.path.join(out_dir, f"m{rank}"))
    assert cli.main(["smoke_synthetic", "train", "--device", "cpu"]) == 0


def _scan_rule(gan, ds, ks, rank, world):
    import torch.distributed as dist

    from terrain_tpu_torch.train import step

    groups = gan.train_step.groups
    cpu = torch.device("cpu")
    batch = ds.batch_args(torch.zeros(2, LAT), torch.zeros(2, dtype=torch.long))
    return {"ks": sorted(ks),
            "backends": [str(dist.get_backend(g)) for g in groups],
            "graph": step._captured([batch], groups),
            "any_last": step._on_any_rank(rank == world - 1, groups, cpu),
            "any_none": step._on_any_rank(False, groups, cpu)}


def run_rank(rank, world, rendezvous, out_dir):
    import torch_spawn

    os.environ["TERRAIN_ARTIFACT_EVERY"] = "999"  # no image dumps
    torch_spawn.run_rank(rank, world, rendezvous, _work, rank, world,
                         out_dir)


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

"""One gloo rank of tests/test_torch_tp.py, spawned with
torch.multiprocessing (4 ranks): it imports torch and terrain_tpu_torch
only.

`run_rank(rank, world, rendezvous, out_dir)` joins the process group
through a file:// rendezvous (tests/torch_spawn.py), lays out a 1x2 mesh
on ranks 0 and 1 and a 2x2 mesh on all four, and saves as each phase
ends:
  * "ops" (ranks 0, 1): each sharded layer call of OPS (the local op on
    this rank's half of the output features between enter_sharded and
    gather_features, then the bias) on seeded inputs: its output and the
    gradients of x, of this rank's weight slice and of the bias under a
    seeded cotangent; and `place` / `gather` of a seeded tensor;
  * "tp" (ranks 0, 1): the tiny nets (tests/test_parallel.py's) at
    tp_min_features 8 on the 1x2 mesh: the names of the sharded layers,
    one train step on GLOBAL_BATCH without augmentation (losses and the
    gathered parameters, as terrain_tpu trees), a checkpoint written
    after it (out_dir/tp<r>.model), a second step, the second step again
    from a trainer that resumed the checkpoint exactly, and the two
    samplers' deterministic outputs on seeded inputs; a one-process
    checkpoint (out_dir/one.model, written by rank 0) loaded on the mesh
    and saved again (out_dir/back<r>.model);
  * "grid_sharded" (every rank): the sharded layers of the tiny nets at
    tp_min_features 8 on the 2x2 mesh, which then train 2 epochs over
    N_PAIRS pairs held on the device, with the paired augmentation, into
    out_dir/grid<r>/results.txt, and again at TERRAIN_SCAN=2 (each pass
    one chunk of 2 steps) into out_dir/gridscan<r>; "grid_scan": the chunk
    sizes that run took, and train/step._on_any_rank over its step's
    groups (a data group, then a model group) with the flag raised on
    rank 3 alone.
"""

import os

import numpy as np
import torch

import torch_mp_worker as w
import torch_spawn
from torch_spawn import save

# sharded calls: (name, op name, x shape, full weight shape, op kwargs)
OPS = (
    ("conv2d", "conv2d", (2, 6, 6, 3), (8, 3, 3, 3),
     dict(stride=1, padding="same")),
    ("conv2d_leaky s2", "conv2d_leaky", (2, 6, 6, 3), (8, 3, 3, 3),
     dict(slope=0.2, stride=2, padding="same")),
    ("conv5x5 cin 64", "conv2d", (2, 6, 6, 64), (8, 64, 5, 5),
     dict(stride=1, padding="same")),
    ("upsample2x_nearest_conv", "upsample2x_nearest_conv", (2, 4, 4, 3),
     (8, 3, 5, 5), {}),
    ("deconv2x2", "conv2d_transpose", (2, 4, 4, 3), (3, 8, 2, 2),
     dict(stride=2)),
    ("deconv k2 s1", "conv2d_transpose", (2, 1, 1, 3), (3, 8, 2, 2),
     dict(stride=1)),
    ("bilinear2x_conv3x3", "bilinear2x_conv3x3", (2, 4, 4, 3),
     (8, 3, 3, 3), {}),
    ("dense", "dense", (3, 5), (8, 5), {}),
)


def op_inputs(name):
    """Seeded (x, full weight, bias, cotangent) of an OPS entry, and the
    weight's output-feature axis."""
    from terrain_tpu_torch.ops import conv, fused

    _, op, xs, ws, kw = next(o for o in OPS if o[0] == name)
    r = np.random.RandomState(len(name))
    x = torch.from_numpy(r.randn(*xs).astype(np.float32))
    wt = torch.from_numpy((r.randn(*ws) * 0.3).astype(np.float32))
    axis = 1 if op == "conv2d_transpose" else 0
    b = torch.from_numpy(r.randn(ws[axis]).astype(np.float32))
    fn = getattr(conv, op, None) or getattr(fused, op)
    y = fn(x, wt, b, **kw)
    cot = torch.from_numpy(r.randn(*y.shape).astype(np.float32))
    return fn, x, wt, b, cot, axis, kw


def _ops(mesh):
    from terrain_tpu_torch.parallel import tp
    from terrain_tpu_torch.parallel.mesh import Sharding, gather, place

    shard = tp.Shard(mesh.model_index, 2, mesh.model_group)
    out = {}
    for name, *_ in OPS:
        fn, x, wt, b, cot, axis, kw = op_inputs(name)
        x.requires_grad_()
        ws = tp.slice_axis(wt, axis, shard).contiguous().requires_grad_()
        b.requires_grad_()
        y = tp.call(fn, x, ws, b, shard, **kw)
        grads = torch.autograd.grad(y, (x, ws, b), cot)
        out[name] = [t.detach().numpy() for t in (y, *grads)]
    full = torch.arange(48, dtype=torch.float32).reshape(2, 3, 8)
    sh = {"a": Sharding(mesh, (None, None, "model")), "b": Sharding(mesh)}
    mine = place({"a": full.clone(), "b": full[0].clone()}, sh)
    back = gather(mine, sh)
    out["place"] = {k: v.numpy() for k, v in mine.items()}
    out["gather"] = {k: v.numpy() for k, v in back.items()}
    return out


def second_batch():
    r = np.random.RandomState(7)
    return (r.rand(w.GLOBAL_BATCH, w.LAT).astype(np.float32),
            r.rand(w.GLOBAL_BATCH, w.IN, w.IN, 1).astype(np.float32),
            (r.rand(w.GLOBAL_BATCH, w.IN, w.IN, 3) * 2 - 1).astype(
                np.float32))


def sampler_inputs():
    r = np.random.RandomState(11)
    return (torch.from_numpy(r.rand(2, w.LAT).astype(np.float32)),
            torch.from_numpy(r.rand(2, w.IN, w.IN, 1).astype(np.float32)))


def _samples(gan):
    z, a = sampler_inputs()
    return (gan.pipeline.z_det(z).numpy(), gan.pipeline.atob_det(a).numpy())


def _tp(mesh, rank, out_dir):
    import torch.distributed as dist

    from terrain_tpu_torch.models import convert
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    kw = dict(w.nets_kw(), da=False, tp_min_features=8)
    gan = TwoStageGAN(**kw, mesh=mesh)
    out = {"sharded": gan.sharded,
           "step1": w.one_step(gan, w.global_batch())}
    path = os.path.join(out_dir, f"tp{rank}.model")
    gan.save_model(path)
    out["step2"] = w.one_step(gan, second_batch())
    out["samples"] = _samples(gan)
    resumed = TwoStageGAN(**kw, mesh=mesh)
    resumed.load_model(path, exact=True)
    out["step2_resumed"] = w.one_step(resumed, second_batch())
    one = os.path.join(out_dir, "one.model")
    if rank == 0:
        TwoStageGAN(**dict(kw, seed=5)).save_model(one)
    dist.barrier(group=mesh.model_group)
    back = TwoStageGAN(**kw, mesh=mesh)
    back.load_model(one, exact=True)
    back.save_model(os.path.join(out_dir, f"back{rank}.model"))
    out["slices"] = {n: [tuple(p.shape) for p in net.parameters()]
                     for n, net in back.nets.items()}
    out["full"] = {n: convert.to_jax(net)[0] for n, net in back.nets.items()}
    return out


def _work(rank, out_dir):
    from terrain_tpu_torch.parallel import make_mesh
    from terrain_tpu_torch.train.trainer import TwoStageGAN
    from tiny_cfg import det_sampler

    pair = make_mesh(n_data=1, n_model=2, ranks=[0, 1])
    grid = make_mesh(n_data=2, n_model=2)
    if rank < 2:
        save(out_dir, "ops", rank, _ops(pair))
        save(out_dir, "tp", rank, _tp(pair, rank, out_dir))
    ds = w.device_pairs()
    for name, scan in (("grid", "1"), ("gridscan", "2")):
        os.environ["TERRAIN_SCAN"] = scan
        gan = TwoStageGAN(**w.tiny_kw(det_sampler(grid.data_index),
                                      da=True),
                          mesh=grid, tp_min_features=8)
        if scan == "1":
            save(out_dir, "grid_sharded", rank, gan.sharded)
        gan.train(ds, ds, batch_size=w.GLOBAL_BATCH, num_epochs=2,
                  out_dir=os.path.join(out_dir, f"{name}{rank}"),
                  save_every=999)
    del os.environ["TERRAIN_SCAN"]
    from terrain_tpu_torch.train.step import _on_any_rank

    save(out_dir, "grid_scan", rank, {
        "ks": sorted({key[1] for key in gan._chunks}),
        "groups": len(gan.train_step.groups),
        "any": _on_any_rank(rank == 3, gan.train_step.groups,
                            torch.device("cpu"))})


def run_rank(rank, world, rendezvous, out_dir):
    os.environ["TERRAIN_ARTIFACT_EVERY"] = "999"  # no image dumps
    torch_spawn.run_rank(rank, world, rendezvous, _work, rank, out_dir)

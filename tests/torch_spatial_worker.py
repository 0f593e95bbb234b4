"""One gloo rank of tests/test_torch_spatial.py, spawned with
torch.multiprocessing (4 ranks): it imports torch and terrain_tpu_torch
only.

`run_rank(rank, world, rendezvous, out_dir)` joins the process group
through a file:// rendezvous (tests/torch_spawn.py), lays out a 1x2 mesh
on ranks 0 and 1 ("pair"), a 1x4 mesh ("quad") and a 2x2 mesh ("grid") on
all four, and saves each phase's results as it ends:
  * "halo": halo_exchange of a seeded tensor's slabs at (top, bottom)
    halos on the pair and the quad, each output and the slab's gradient
    under a seeded cotangent; and torch.autograd.gradcheck (fp64) of
    whole -> scatter_rows -> halo_exchange -> the slab's rows mixed with
    its halos -> gather_rows on both;
  * "ops": every slab op of OPS on its rank's rows of seeded whole
    inputs, on the pair and the quad: output (this rank's rows, or the
    whole output where a pool leaves slabs), and the gradients of the
    slab, the weight and the bias under the cotangent's rows (the whole
    cotangent of a whole output), and the plain versions' call counts
    (the kernel routes), a BatchNorm on slabs and one on whole rows on
    the grid and the pair, and the gather_rows / scatter_rows round trip;
  * "place": place and gather of a seeded global batch under
    spatial_batch_sharding on the grid;
  * "unet": the U-Net of tests/test_parallel.py (32px, nf 4, train) and
    its bilinear form on the grid under the rule's MIN_ROWS 8 and under 2
    (`min_rows`): this rank's rows of its data block's output;
  * "dcgan": a tiny DCGAN generator (h 5, the fused path) and
    discriminator (5x5 convs of 64 features: `Conv5x5`) on the grid under
    MIN_ROWS 8 and 2, train mode: this rank's rows of its data block's
    output, and every gradient of a seeded cotangent's dot product with
    the output, summed over the mesh (the discriminator's input's, this
    rank's rows);
  * "bilinear": the tiny DCGAN generator with bilinear_upsample at h 3
    and 5 (BILINEAR) on the pair and the quad under MIN_ROWS 8 and 2,
    train mode: this rank's rows of the output and every gradient of a
    seeded cotangent's dot product with the output, summed over the mesh;
  * "step": a train step of step_kw's nets (a tiny test1_nobn_bilin
    family: the four networks) on the grid and the quad under MIN_ROWS 8
    and 2 (experiments._spatial_steps), in the pix2pix mode (STEP) and in
    the both and dcgan modes (MODE_STEP), and in the both mode with the
    bilinear DCGAN generator at h 5 (BILINEAR_STEP): the losses and the
    gradients its update was given;
  * "build": experiments.build_train("smoke_synthetic", mesh=) on the
    pair, one train step and one eval step: their losses; and two train
    and two eval steps of it, as chunks of 2 (train/step.py's
    build_scan_step and build_scan_eval: a loop over gloo) and one by
    one from the same state: their losses and the parameters after.
The ops' slabs are thinner than the rule's 8 rows (the ops take any
slab the rule gives them), so the ops phase runs under MIN_ROWS 2.
"""

import contextlib

import dataclasses
import os

import numpy as np
import torch

from terrain_tpu_torch.ops.norm import BatchNorm
import torch_spawn
from torch_spawn import save

# slab ops: (name, op, x shape, weight shape or None, op kwargs, switches)
OPS = (
    ("conv3x3 s1", "conv2d", (2, 16, 6, 3), (5, 3, 3, 3),
     dict(stride=1, padding="same"), {}),
    ("conv5x5 s1", "conv2d", (2, 16, 6, 3), (5, 3, 5, 5),
     dict(stride=1, padding="same"), {}),
    ("conv3x3 s2", "conv2d", (2, 16, 6, 3), (5, 3, 3, 3),
     dict(stride=2, padding="same"), {}),
    ("conv2d_leaky s2", "conv2d_leaky", (2, 16, 6, 3), (5, 3, 3, 3),
     dict(slope=0.25, stride=2, padding="same"), {}),
    ("conv_s2 kernel route", "conv2d_leaky", (1, 64, 256, 4), (8, 4, 3, 3),
     dict(slope=0.25, stride=2, padding="same"),
     {"TERRAIN_PALLAS_CONVS2": "1"}),
    ("upsample_bilinear_2x", "upsample_bilinear_2x", (2, 8, 6, 4), None, {},
     {}),
    ("upsample_bilinear_2x dense", "upsample_bilinear_2x", (2, 8, 6, 4),
     None, {}, {"TERRAIN_RESIZE": "dense"}),
    ("bilinear kernel route", "upsample_bilinear_2x", (1, 128, 128, 128),
     None, {}, {"TERRAIN_PALLAS": "1"}),
    ("bilinear2x_conv3x3 composite", "bilinear2x_conv3x3", (2, 8, 6, 8),
     (8, 8, 3, 3), {}, {}),
    ("bilinear_conv kernel route", "bilinear2x_conv3x3", (1, 32, 32, 8),
     (8, 8, 3, 3), {}, {}),
    ("deconv k2 s2", "conv2d_transpose", (2, 8, 6, 3), (3, 5, 2, 2),
     dict(stride=2), {}),
    # the DCGAN networks': the discriminator's hidden 5x5 convs (fp32,
    # cin >= 64: ops/conv.Conv5x5) and its stem, the generator's fused
    # nearest x2 + conv at h 5 and 3 and its output conv (conv_thin), the
    # pools between the discriminator's stages (max with planted ties;
    # the quad's 8-row inputs pool to 4 rows, whole under MIN_ROWS 2: the
    # pooled rows gathered), pool2's route, and the last pool over the
    # whole extent (a window across slabs: gathered first)
    ("conv5x5 Conv5x5", "conv2d", (2, 16, 6, 64), (8, 64, 5, 5),
     dict(stride=1, padding="same"), {}),
    ("conv_stem kernel route", "conv2d_leaky", (1, 256, 256, 1),
     (8, 1, 5, 5), dict(slope=0.25, stride=1, padding="same"), {}),
    ("upsample2x_nearest_conv k5", "upsample2x_nearest_conv", (2, 8, 6, 4),
     (3, 4, 5, 5), {}, {}),
    ("upsample2x_nearest_conv k3", "upsample2x_nearest_conv", (2, 8, 6, 4),
     (3, 4, 3, 3), {}, {}),
    ("conv_thin kernel route", "upsample2x_nearest_conv", (1, 64, 128, 8),
     (1, 8, 5, 5), {}, {}),
    ("max_pool2d ties", "max_pool2d", (2, 8, 6, 4), None, dict(size=2), {}),
    ("avg_pool2d", "avg_pool2d", (2, 8, 6, 4), None, dict(size=2), {}),
    ("pool2 kernel route", "max_pool2d", (1, 8, 16, 8), None, dict(size=2),
     {"TERRAIN_POOL_VJP": "pallas"}),
    ("avg_pool2d whole extent", "avg_pool2d", (2, 8, 8, 1), None,
     dict(size=8), {}),
)
POOLS = ("max_pool2d", "avg_pool2d")
BN_SHAPE = (4, 8, 4, 3)  # a global batch of 4 images of 8 rows, 3 channels
BATCH = (4, 8, 6, 2)     # place / gather
UNET = [(bil, mr) for bil in (False, True) for mr in (8, 2)]
STEP = [(mesh, mr) for mesh in ("grid", "quad") for mr in (8, 2)]
MODE_STEP = [("both", "grid", 8), ("both", "quad", 2), ("dcgan", "grid", 2),
             ("dcgan", "quad", 8)]
DCGAN = (8, 2)
BILINEAR = [(mesh, h, mr) for mesh in ("pair", "quad") for h in (3, 5)
            for mr in (8, 2)]
BILINEAR_STEP = [("grid", 8), ("quad", 2)]
IN, LAT, GLOBAL_BATCH, LR = 32, 8, 4, 1e-4


def op_fn(op):
    from terrain_tpu_torch.ops import conv, fused, pool, resize

    return (getattr(conv, op, None) or getattr(fused, op, None)
            or getattr(pool, op, None) or getattr(resize, op))


def dyadic(r, shape, step):
    """Seeded multiples of `step` (a power of two) in [-2, 2]: the ops'
    fp32 products and sums of them are exact, so a slab's partial sums
    add up to the whole op's bits in any order."""
    return torch.from_numpy((r.randint(-int(2 / step), int(2 / step) + 1,
                                       shape) * step).astype(np.float32))


def op_inputs(name):
    """Seeded whole (x, weight or None, bias or None, cotangent) of an OPS
    entry, the op, its kwargs and its switches."""
    _, op, xs, ws, kw, env = next(o for o in OPS if o[0] == name)
    r = np.random.RandomState(sum(map(ord, name)) % 1000)
    # a max pool's input in steps of 1: five levels, ties in most windows
    x = dyadic(r, xs, 1 if op == "max_pool2d" else 1 / 4)
    wt = b = None
    if ws is not None:
        wt = dyadic(r, ws, 1 / 8)
        b = dyadic(r, ws[1] if op == "conv2d_transpose" else ws[0], 1 / 4)
    fn = op_fn(op)
    y = call_op(fn, x, wt, b, kw, env)
    cot = dyadic(r, y.shape, 1 / 4)
    return fn, x, wt, b, cot, kw, env


def call_op(fn, x, wt, b, kw, env, **extra):
    """fn on x (with its weight and bias when it has them) under the
    switches `env`."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if wt is None:
            return fn(x, **kw, **extra)
        return fn(x, wt, b, **kw, **extra)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plain_counts():
    """Calls of the six on-path kernels' plain versions."""
    from terrain_tpu_torch.ops.kernels import (
        bilinear, bilinear_conv, conv_s2, conv_stem, conv_thin, pool2)

    return {"conv_s2": conv_s2.PLAIN.calls, "bilinear": bilinear.PLAIN.calls,
            "bilinear_conv": bilinear_conv.PLAIN.calls,
            "conv_stem": conv_stem.PLAIN.calls,
            "conv_thin": conv_thin.PLAIN.calls, "pool2": pool2.PLAIN.calls}


@contextlib.contextmanager
def min_rows(n):
    """The rule of parallel/spatial.py at slabs of n rows or more."""
    from terrain_tpu_torch.parallel import spatial

    real, spatial.MIN_ROWS = spatial.MIN_ROWS, n
    try:
        yield
    finally:
        spatial.MIN_ROWS = real


def _rows(mesh):
    from terrain_tpu_torch.parallel.spatial import RowShard

    return RowShard(mesh.model_index, mesh.shape["model"], mesh.model_group)


def slab_call(op, fn, xs, wt, b, kw, env, rows, h):
    """fn on this rank's slab xs of whole height h, as a layer on slabs
    runs it (parallel/spatial.on_slab; the bilinear x2 alone through
    RowShard.upsampled, a pool through spatial.pool), under the switches
    `env`."""
    from terrain_tpu_torch.parallel import spatial

    whole = rows.whole_shape(xs)
    if op in POOLS:
        return call_op(lambda x, size: spatial.pool(fn, x, rows, h, size),
                       xs, None, None, kw, env)
    if wt is None:
        return call_op(lambda x, **k: rows.upsampled(
            lambda e: fn(e, route_shape=whole, **k), x), xs, None, None,
            kw, env)
    up = op in ("conv2d_transpose", "bilinear2x_conv3x3",
                "upsample2x_nearest_conv")
    io = (h, 2 * h) if up else (h, h // kw.get("stride", 1))
    return call_op(lambda x, w, bb, **k: spatial.on_slab(
        fn, x, w, bb, rows, io, **k), xs, wt, b, kw, env)


def halo_inputs():
    r = np.random.RandomState(5)
    return (torch.from_numpy(r.randn(2, 8, 3, 2)),
            torch.from_numpy(r.randn(2, 12, 3, 2)))  # x, cotangent room


HALOS = ((1, 1), (1, 0), (0, 2), (2, 1))


def _halo(mesh):
    from terrain_tpu_torch.parallel import spatial

    rows = _rows(mesh)
    x, g = halo_inputs()
    out = {}
    for top, bottom in HALOS:
        xs = rows.take(x).clone().requires_grad_()
        ext = spatial.halo_exchange(xs, top, bottom, rows)
        cot = g[:, :ext.shape[1]]
        (dx,) = torch.autograd.grad(ext, xs, cot)
        out[(top, bottom)] = (ext.detach().numpy(), dx.numpy())

    def f(whole):
        s = spatial.scatter_rows(whole, rows)
        ext = spatial.halo_exchange(s, 1, 1, rows)
        t = 0 if rows.first else 1
        r = s.shape[1]
        # the slab's rows mixed with the halo rows above and below
        mixed = (ext.narrow(1, t, r) * 2.0 + ext.narrow(1, 0, r)
                 - ext.narrow(1, ext.shape[1] - r, r) * 0.5)
        return spatial.gather_rows(mixed, rows)

    whole = torch.from_numpy(np.random.RandomState(6).randn(1, 8, 2, 2)) \
        .requires_grad_()
    out["gradcheck"] = torch.autograd.gradcheck(f, (whole,), atol=1e-8,
                                                rtol=1e-7)
    return out


def _ops(mesh):
    rows = _rows(mesh)
    out = {}
    for name, op, *_ in OPS:
        fn, x, wt, b, cot, kw, env = op_inputs(name)
        xs = rows.take(x).clone().requires_grad_()
        ins = [xs] + [t.clone().requires_grad_() for t in (wt, b)
                      if t is not None]
        before = plain_counts()
        wb = ins[1:] if wt is not None else [None, None]
        y = slab_call(op, fn, xs, *wb, kw, env, rows, x.shape[1])
        # a whole output (a pool where the rule ends slabs) carries the
        # whole cotangent, a slab its rows
        grads = torch.autograd.grad(
            y, ins, cot if y.shape == cot.shape else rows.take(cot))
        calls = {k: v - before[k] for k, v in plain_counts().items()}
        out[name] = ([t.detach().numpy() for t in (y, *grads)], calls)
    return out


def bn_inputs():
    r = np.random.RandomState(9)
    return (dyadic(r, BN_SHAPE, 1 / 8), dyadic(r, BN_SHAPE, 1 / 8),
            1.0 + dyadic(r, 3, 1 / 8) / 4, dyadic(r, 3, 1 / 8))


class BNNet(torch.nn.Module):
    """A network of 16 rows whose one BatchNorm sits at 8 (BN_SHAPE)."""

    rows = None
    in_shp = 2 * BN_SHAPE[1]

    def __init__(self):
        super().__init__()
        self.bn = BatchNorm(BN_SHAPE[-1])
        self.bn.io_rows = (BN_SHAPE[1],) * 2


def _bn(mesh, slab):
    """A BatchNorm of a row-sharded network (shard_rows) on this rank's
    data block: on slabs (its whole height 8 held in slabs of 4 or 2,
    under MIN_ROWS 2) or on whole rows (under the rule's 8); output,
    gradients of x, gamma and beta, and the running statistics."""
    from terrain_tpu_torch.parallel import shard_rows

    x, g, gamma, beta = bn_inputs()
    per = BN_SHAPE[0] // mesh.shape["data"]
    block = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    x, g = x[block], g[block]
    net = BNNet()
    with min_rows(2 if slab else 8):
        assert shard_rows(net, mesh) == (["bn"] if slab else [])
    bn = net.bn
    if slab:
        x, g = net.rows.take(x), net.rows.take(g)
    with torch.no_grad():
        bn.gamma.copy_(gamma)
        bn.beta.copy_(beta)
    xs = x.clone().requires_grad_()
    y = bn(xs, train=True, update_stats=True)
    grads = torch.autograd.grad(y, (xs, bn.gamma, bn.beta), g)
    return ([t.detach().numpy() for t in (y, *grads)],
            (bn.mean.numpy().copy(), bn.inv_std.numpy().copy()))


def _round_trip(mesh):
    from terrain_tpu_torch.parallel import spatial

    rows = _rows(mesh)
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(2, 8, 3, 2).astype(np.float32))
    g = torch.from_numpy(r.randn(2, 8, 3, 2).astype(np.float32))
    xw = x.clone().requires_grad_()
    y = spatial.gather_rows(spatial.scatter_rows(xw, rows), rows)
    (dx,) = torch.autograd.grad(y, xw, g)
    return y.detach().numpy(), dx.numpy()


def batch_inputs():
    return torch.arange(np.prod(BATCH), dtype=torch.float32).reshape(BATCH)


def _place(mesh):
    from terrain_tpu_torch.parallel import place, spatial_batch_sharding
    from terrain_tpu_torch.parallel.mesh import gather

    sh = {"x": spatial_batch_sharding(mesh)}
    mine = place({"x": batch_inputs()}, sh)
    back = gather(mine, sh)
    return mine["x"].numpy(), back["x"].numpy()


def unet(bilinear):
    from terrain_tpu_torch.models import unet as unet_mod

    return unet_mod.g_unet(IN, True, False, nf=4, bilinear_upsample=bilinear,
                           generator=torch.Generator().manual_seed(0))


def unet_input():
    return np.random.RandomState(0).rand(4, IN, IN, 1).astype(np.float32)


def _unet(mesh):
    from terrain_tpu_torch.parallel import shard_rows

    out = {}
    for bilinear, rule in UNET:
        net = unet(bilinear)
        per = 4 // mesh.shape["data"]
        x = torch.from_numpy(unet_input()[mesh.data_index * per:
                                          (mesh.data_index + 1) * per])
        with min_rows(rule), torch.no_grad():
            slabs = shard_rows(net, mesh)
            y = net(net.rows.take(x), train=True)
        out[(bilinear, rule)] = (y.numpy(), slabs)
    return out


def dcgan_nets():
    """The tiny DCGAN pair of the "dcgan" phase, seeded, biases nonzero:
    a generator (32px from 4, h 5, 32/32/16/8 features) and a
    discriminator (64px, h 5, three 5x5 convs of 64 features, no BN,
    average pools).  Its pools average: with max pools, windows whose two
    largest values lie 3e-7 apart (relative) route the gradient to
    another pixel when the conv rounds otherwise, as XLA's and PyTorch's
    CPU convs do (the unsharded port against terrain_tpu alike), which
    moves its gradients by up to 2.7e-5; the max pools on slabs are held
    to the whole op with planted ties ("ops") and, in the steps'
    discriminators, to terrain_tpu's step."""
    from terrain_tpu_torch.models import dcgan

    g = dcgan.default_generator(
        LAT, True, nch=32, h=5, initial_size=4, final_size=IN,
        div=[1, 2, 4], generator=torch.Generator().manual_seed(3))
    d = dcgan.default_discriminator(
        2 * IN, True, nch=2 * IN, h=5, div=[1, 1, 1], bn=False,
        pool_mode="avg", nonlinearity="linear",
        generator=torch.Generator().manual_seed(4))
    r = np.random.RandomState(8)
    with torch.no_grad():
        for net in (g, d):
            for name, p in net.named_parameters():
                if name.endswith(".b"):
                    p.copy_(torch.from_numpy(
                        r.uniform(-0.1, 0.1, p.shape).astype(np.float32)))
    return g, d


def bilinear_generator(h):
    """The "dcgan" phase's generator with bilinear_upsample and `h`."""
    from terrain_tpu_torch.models import dcgan

    g = dcgan.default_generator(
        LAT, True, nch=32, h=h, initial_size=4, final_size=IN,
        div=[1, 2, 4], bilinear_upsample=True,
        generator=torch.Generator().manual_seed(3 + h))
    r = np.random.RandomState(8 + h)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".b"):
                p.copy_(torch.from_numpy(
                    r.uniform(-0.1, 0.1, p.shape).astype(np.float32)))
    return g


def _bilinear(meshes):
    from terrain_tpu_torch.parallel import shard_rows, spatial

    z, _, gy, _ = (torch.from_numpy(a) for a in dcgan_inputs())
    out = {}
    for key, h, rule in BILINEAR:
        mesh = meshes[key]
        if mesh is None:
            continue
        g = bilinear_generator(h)
        with min_rows(rule):
            shard_rows(g, mesh)
            y = g(z, train=True)
            grads = spatial.sum_slab_grads(g, list(torch.autograd.grad(
                y, list(g.parameters()), g.rows.take(gy))))
        out[(key, h, rule)] = (y.detach().numpy(),
                               [t.numpy() for t in grads])
    return out


def dcgan_inputs():
    """The global batch: z, the discriminator's images, and seeded
    cotangents of the generator's output and the discriminator's, scaled
    so that each network's largest gradients are of order 1 (the dense
    bias before the generator's bn_in has a zero gradient, whose rounding
    grows with the cotangent: 1.5e-5 at 64 times this one)."""
    r = np.random.RandomState(7)
    gy = r.randn(GLOBAL_BATCH, IN, IN, 1).astype(np.float32) / 64
    gs = r.randn(GLOBAL_BATCH, 1).astype(np.float32) * 64
    return (r.rand(GLOBAL_BATCH, LAT).astype(np.float32),
            r.rand(GLOBAL_BATCH, 2 * IN, 2 * IN, 1).astype(np.float32),
            gy, gs)


def _dcgan(mesh):
    from terrain_tpu_torch.parallel import shard_rows, spatial

    per = GLOBAL_BATCH // mesh.shape["data"]
    block = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    z, x, gy, gs = (torch.from_numpy(a[block]) for a in dcgan_inputs())

    def whole(net, grads):
        grads = spatial.sum_slab_grads(net, list(grads))
        for t in grads:
            torch.distributed.all_reduce(t, group=mesh.data_group)
        return [t.numpy() for t in grads]

    out = {}
    for rule in DCGAN:
        g, d = dcgan_nets()
        with min_rows(rule):
            for net in (g, d):
                for m in net.modules():
                    if isinstance(m, BatchNorm):
                        m.process_group = mesh.data_group
                shard_rows(net, mesh)
            y = g(z, train=True)
            gp = whole(g, torch.autograd.grad(y, list(g.parameters()),
                                              g.rows.take(gy)))
            xs = d.rows.take(x).requires_grad_()
            score = d(xs, train=True)
            dg = torch.autograd.grad(score, [xs, *d.parameters()], gs)
            out[rule] = (y.detach().numpy(), gp, score.detach().numpy(),
                         dg[0].numpy(), whole(d, dg[1:]))
    return out


def step_kw(train_mode="p2p", bilinear=False):
    """A tiny test1_nobn_finetunep2p_bilin: the bilinear U-Net and the
    PatchGAN without BN (nf 4 each), the pix2pix mode, LSGAN, rmsprop;
    with `train_mode` "both" or "dcgan" the tiny test1_nobn_bilin_both
    and its dcgan mode (the DCGAN pair: h 3, the fused path).  The DCGAN
    discriminator's last conv is linear, as the _stable experiments'
    (TERRAIN_DISC_OUT): the reference's rectify puts out zeros at this
    size, which would leave its losses and both DCGAN networks'
    gradients constant.  `bilinear`: the DCGAN generator with
    bilinear_upsample at h 5."""
    from terrain_tpu_torch.models import dcgan, unet as unet_mod

    gen = {"nch": 8, "h": 3, "initial_size": 4, "final_size": IN,
           "div": [2, 2, 2]}
    if bilinear:
        gen.update(h=5, bilinear_upsample=True)

    return dict(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan=gen,
        disc_params_dcgan={"nch": IN, "h": 3, "div": [4, 2], "bn": False,
                           "nonlinearity": "linear",
                           "conv_out_nonlinearity": "linear"},
        gen_fn_p2p=unet_mod.g_unet, disc_fn_p2p=unet_mod.discriminator,
        gen_params_p2p={"nf": 4, "act": "tanh", "num_repeats": 0,
                        "bilinear_upsample": True},
        disc_params_p2p={"nf": 4, "bn": False, "num_repeats": 0,
                         "act": "linear", "mul_factor": [1, 2, 4, 8]},
        in_shp=IN, latent_dim=LAT, is_a_grayscale=True, is_b_grayscale=False,
        lsgan=True, opt="rmsprop", opt_args={"learning_rate": LR},
        train_mode=train_mode, verbose=False, seed=1, device="cpu",
        da=False)


def step_batch():
    r = np.random.RandomState(2)
    return (r.rand(GLOBAL_BATCH, LAT).astype(np.float32),
            r.rand(GLOBAL_BATCH, IN, IN, 1).astype(np.float32),
            (r.rand(GLOBAL_BATCH, IN, IN, 3) * 2 - 1).astype(np.float32))


def recording(gan):
    """gan's optimizer wrapped to keep the gradients each update is given,
    by network (the order of gan.opt_states, the step's); returns the dict
    they go to.  Steps built after this call use it."""
    rec, opt = {}, gan.optimizer
    order = list(gan.opt_states)

    def update(params, grads, state, lr):
        rec[order[len(rec)]] = [g.detach().numpy().copy() for g in grads]
        opt.update(params, grads, state, lr)

    gan.optimizer = dataclasses.replace(opt, update=update)
    return rec


def run_step(gan, step, rec, batch):
    """One call of `step` on the host batch: (losses, {network: the
    gradients its update was given})."""
    losses = step(gan.opt_states, tuple(torch.from_numpy(a) for a in batch),
                  {}, LR)
    return {k: float(v) for k, v in losses.items()}, rec


def _step(meshes):
    from terrain_tpu_torch import experiments
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    out = {}
    for mode, key, rule in ([("p2p", *c) for c in STEP] + MODE_STEP
                            + [("bilinear", *c) for c in BILINEAR_STEP]):
        mesh = meshes[key]
        gan = TwoStageGAN(**(step_kw("both", bilinear=True)
                             if mode == "bilinear" else step_kw(mode)))
        rec = recording(gan)
        per = GLOBAL_BATCH // mesh.shape["data"]
        block = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
        with min_rows(rule):
            step, _ = experiments._spatial_steps(gan, mesh)
            out[(mode, key, rule)] = run_step(
                gan, step, rec, tuple(a[block] for a in step_batch()))
    return out


def smoke_batch(latent, seed=3):
    """A seeded global batch of smoke_synthetic (64px), batch 2."""
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy(a) for a in (
        r.rand(2, latent).astype(np.float32),
        r.rand(2, 64, 64, 1).astype(np.float32),
        (r.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)))


def build_steps(setup):
    """One train step and one eval step of a build_train setup on
    smoke_batch: their losses."""
    batch = smoke_batch(setup.latent_dim)
    train = setup.train_step(setup.opt_states, batch, {}, setup.lr)
    return ({k: float(v) for k, v in train.items()},
            {k: float(v) for k, v in setup.eval_step(batch, {}).items()})


def _build(pair):
    from terrain_tpu_torch import experiments

    return build_steps(experiments.build_train("smoke_synthetic", "cpu",
                                               mesh=pair))


def _build_chunk(pair):
    """{"steps" or "chunk": (train losses, eval losses, parameters)} of
    two train and two eval steps of build_train("smoke_synthetic",
    mesh=pair), one by one or as chunks of 2, each from a fresh setup."""
    from terrain_tpu_torch import experiments
    from terrain_tpu_torch.train.step import build_scan_eval, build_scan_step

    out = {}
    for how in ("steps", "chunk"):
        setup = experiments.build_train("smoke_synthetic", "cpu", mesh=pair)
        batches = [smoke_batch(setup.latent_dim, seed) for seed in (3, 4)]
        if how == "steps":
            tr = [setup.train_step(setup.opt_states, b, {}, setup.lr)
                  for b in batches]
            ev = [setup.eval_step(b, {}) for b in batches]
            tr, ev = ({k: torch.stack([o[k] for o in outs]) for k in outs[0]}
                      for outs in (tr, ev))
        else:
            tr = build_scan_step(setup.train_step)(
                setup.opt_states, batches, [{}, {}], setup.lr)
            ev = build_scan_eval(setup.eval_step)(batches, [{}, {}])
        out[how] = ({k: v.numpy() for k, v in tr.items()},
                    {k: v.numpy() for k, v in ev.items()},
                    [p.detach().numpy().copy() for net in setup.nets.values()
                     for p in net.parameters()])
    return out


def _work(rank, out_dir):
    from terrain_tpu_torch.parallel import make_mesh

    pair = make_mesh(n_data=1, n_model=2, ranks=[0, 1])
    quad = make_mesh(n_data=1, n_model=4)
    grid = make_mesh(n_data=2, n_model=2)
    on_pair = rank < 2
    save(out_dir, "halo", rank, {"pair": _halo(pair) if on_pair else None,
                                 "quad": _halo(quad)})
    with min_rows(2):
        ops = {"pair": _ops(pair) if on_pair else None, "quad": _ops(quad)}
    save(out_dir, "ops", rank, {
        **ops, "bn_grid": (_bn(grid, True), _bn(grid, False)),
        "bn_pair": _bn(pair, True) if on_pair else None,
        "round_trip": _round_trip(quad)})
    save(out_dir, "place", rank, _place(grid))
    save(out_dir, "unet", rank, _unet(grid))
    save(out_dir, "dcgan", rank, _dcgan(grid))
    save(out_dir, "bilinear", rank, _bilinear(
        {"pair": pair if on_pair else None, "quad": quad}))
    save(out_dir, "step", rank, _step({"grid": grid, "quad": quad}))
    save(out_dir, "build", rank, _build(pair) if on_pair else None)
    save(out_dir, "build_chunk", rank, _build_chunk(pair) if on_pair
         else None)


def run_rank(rank, world, rendezvous, out_dir):
    torch_spawn.run_rank(rank, world, rendezvous, _work, rank, out_dir)

"""terrain_tpu_torch's spatial parallelism (image rows over 'model',
parallel/spatial.py) across real processes on the CPU: four gloo ranks,
spawned once for the module (torch.multiprocessing), joined through a
file:// rendezvous in the test's temporary directory; each runs
tests/torch_spatial_worker.py's `run_rank` and writes its results phase by
phase, so a rank that fails fails the tests of the phases it did not
finish, and `test_every_rank_ran_to_its_end`.

  * halo_exchange on 2 and 4 ranks against slicing the whole tensor,
    forward and backward, and fp64 gradcheck of scatter -> halo -> gather;
  * each slab op on 2 and 4 ranks against the whole op, forward and every
    gradient (3x3 and 5x5 at stride 1, 3x3 at stride 2, upsample_bilinear_2x
    in its three forms, bilinear2x_conv3x3's composite and its kernel's
    route, the k2 s2 deconv; the DCGAN networks' Conv5x5, stem,
    upsample2x_nearest_conv at k 5 and 3 and its conv_thin route, the max
    pool with ties, the average pool, pool2's route, the pools where the
    rule ends slabs and over a window across slabs), the kernel routes
    taken on the whole image's regime; both BatchNorm kinds; the
    gather_rows / scatter_rows round trip;
  * place / gather under spatial_batch_sharding on a 2x2 mesh;
  * the U-Net of tests/test_parallel.py:172 (32px, nf 4, train) and its
    bilinear form on a 2x2 mesh against terrain_tpu's unsharded apply, at
    JAX's own rtol 1e-4 / atol 1e-5;
  * a tiny DCGAN generator (the fused path) and discriminator (Conv5x5)
    on a 2x2 mesh against terrain_tpu's unsharded apply, output and every
    gradient, at rtol 1e-4 / atol 1e-5; the generator with
    bilinear_upsample at h 3 and 5 on a 1x2 and a 1x4 mesh alike, the
    halo that `upsample_halo` counts against the taps by brute force, and
    an even h against terrain_tpu on one device (its shrunken output) and
    raising on slabs;
  * a tiny test1_nobn_finetunep2p_bilin pix2pix step, and the tiny
    four-network step in the both and dcgan modes, on a 2x2 and a 1x4
    mesh (experiments._spatial_steps) against terrain_tpu's step and the
    port's one-process step: every loss and every gradient at rtol 2e-4 /
    atol 2e-5, global batch 4; the both mode with the bilinear generator
    at h 5 against one process;
  * experiments.build_train("smoke_synthetic", mesh=) on a 1x2 mesh: its
    train and eval steps give one process's losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.train import step as jstep
from terrain_tpu_torch import experiments
from terrain_tpu_torch.models import convert, dcgan
from terrain_tpu_torch.ops.kernels import bilinear as _bl
from terrain_tpu_torch.ops.kernels import bilinear_conv as _bc
from terrain_tpu_torch.ops.kernels import conv_s2 as _c2
from terrain_tpu_torch.ops.kernels import conv_stem as _cs
from terrain_tpu_torch.ops.kernels import conv_thin as _ct
from terrain_tpu_torch.ops.kernels import pool2 as _p2
from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.parallel.spatial import RowShard
from terrain_tpu_torch.train.step import ACTIVE
from terrain_tpu_torch.train.trainer import TwoStageGAN
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_spatial_worker as sw
import torch_spawn

WORLD = 4
OP_TOL = dict(rtol=1e-6, atol=1e-6)
UNET_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
MESHES = {"pair": (1, 2), "quad": (1, 4), "grid": (2, 2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results directory and the spawn's failure (None when every
    rank ran to its end)."""
    out = str(tmp_path_factory.mktemp("spatial"))
    return out, torch_spawn.spawn(sw.run_rank, WORLD, out)


def _phase(ranks, phase):
    return torch_spawn.load(*ranks[:1], phase, range(WORLD), ranks[1])


def _members(mesh):
    """The ranks of a mesh by model index (its first data row)."""
    return list(range(MESHES[mesh][1]))


def test_every_rank_ran_to_its_end(ranks):
    assert ranks[1] is None


@pytest.mark.parametrize("mesh", ["pair", "quad"])
@pytest.mark.parametrize("halo", sw.HALOS)
def test_halo_exchange_is_a_slice_of_the_whole(ranks, mesh, halo):
    res = _phase(ranks, "halo")
    x, g = (t.numpy() for t in sw.halo_inputs())
    top, bottom = halo
    n = MESHES[mesh][1]
    r = x.shape[1] // n
    want_dx = np.zeros_like(x)
    spans = []
    for i in range(n):
        lo, hi = max(0, i * r - top), min(x.shape[1], (i + 1) * r + bottom)
        spans.append((lo, hi))
        want_dx[:, lo:hi] += g[:, :hi - lo]
    for i, (lo, hi) in enumerate(spans):
        ext, dx = res[i][mesh][halo]
        np.testing.assert_array_equal(ext, x[:, lo:hi])
        np.testing.assert_allclose(dx, want_dx[:, i * r:(i + 1) * r],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh", ["pair", "quad"])
def test_halo_exchange_passes_gradcheck(ranks, mesh):
    res = _phase(ranks, "halo")
    assert all(res[i][mesh]["gradcheck"] for i in _members(mesh))


def _whole_op(name):
    fn, x, wt, b, cot, kw, env = sw.op_inputs(name)
    ins = [t.clone().requires_grad_() for t in (x, wt, b) if t is not None]
    wb = ins[1:] if wt is not None else [None, None]
    y = sw.call_op(fn, ins[0], *wb, kw, env)
    return [t.detach().numpy()
            for t in (y, *torch.autograd.grad(y, ins, cot))]


@pytest.mark.parametrize("mesh", ["pair", "quad"])
@pytest.mark.parametrize("name", [o[0] for o in sw.OPS])
def test_slab_op_matches_the_whole_op(ranks, mesh, name):
    """Output and input gradient: each rank's rows of the whole op's (an
    output the rule holds whole: the whole op's on every rank); weight
    and bias gradients: the ranks' parts summed."""
    res = _phase(ranks, "ops")
    want = _whole_op(name)
    got = [res[i][mesh][name][0] for i in _members(mesh)]
    _, op, xs, _, kw, _ = next(o for o in sw.OPS if o[0] == name)
    if op in sw.POOLS:  # the output's layout is the rule's (MIN_ROWS 2)
        with sw.min_rows(2):
            whole = not RowShard(0, MESHES[mesh][1], None).slab(
                xs[1] // kw["size"])
        assert (got[0][0].shape == want[0].shape) == whole, name
    for k in (0, 1):  # y, dx: the ranks' rows in order
        if k == 0 and got[0][0].shape == want[0].shape:
            for g in got:
                np.testing.assert_allclose(g[0], want[0], err_msg=name,
                                           **OP_TOL)
            continue
        np.testing.assert_allclose(np.concatenate([g[k] for g in got], 1),
                                   want[k], err_msg=f"{name} {k}", **OP_TOL)
    for k in range(2, len(want)):  # dW, db: partial over the ranks
        np.testing.assert_allclose(sum(g[k] for g in got), want[k],
                                   err_msg=f"{name} {k}", **OP_TOL)


@pytest.mark.parametrize("mesh", ["pair", "quad"])
def test_slab_ops_take_the_whole_images_kernel_route(ranks, mesh):
    """In each kernel's regime by the whole image's shape (none of them by
    the slab's), every rank ran the kernel's version (its plain version on
    CPU tensors), and no rank outside the regime did."""
    res = _phase(ranks, "ops")
    routes = {"conv_s2 kernel route": ("conv_s2", _c2.supported(
                  (1, 64, 256, 4), (3, 3, 4, 8), 2, "same")),
              "bilinear kernel route": ("bilinear", _bl.supported(
                  (1, 128, 128, 128))),
              "bilinear_conv kernel route": ("bilinear_conv", _bc.supported(
                  (1, 32, 32, 8), (3, 3, 8, 8))),
              "conv_stem kernel route": ("conv_stem", _cs.supported(
                  (1, 256, 256, 1), (5, 5, 1, 8), 1, "same")),
              "conv_thin kernel route": ("conv_thin", _ct.supported(
                  (1, 64, 128, 8), (3, 3, 8, 4), 1, "same")),
              "pool2 kernel route": ("pool2", _p2.supported((1, 8, 16, 8)))}
    for name, (kernel, whole) in routes.items():
        assert whole, name
        for i in _members(mesh):
            assert res[i][mesh][name][1][kernel] >= 1, (name, i)
    assert not _bc.supported((1, 32 // 4 + 2, 32, 8), (3, 3, 8, 8))
    assert not _cs.supported((1, 256 // 2 + 2, 256, 1), (5, 5, 1, 8), 1,
                             "same")
    assert not _ct.supported((1, 64 // 2 + 1, 128, 8), (3, 3, 8, 4), 1,
                             "same")
    assert not _p2.supported((1, 8 // 2, 16, 8))
    for name in ("conv3x3 s2", "upsample_bilinear_2x",
                 "bilinear2x_conv3x3 composite", "conv5x5 Conv5x5",
                 "upsample2x_nearest_conv k5", "max_pool2d ties"):
        for i in _members(mesh):
            assert not any(res[i][mesh][name][1].values()), name


def _whole_bn():
    x, g, gamma, beta = sw.bn_inputs()
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.gamma.copy_(gamma)
        bn.beta.copy_(beta)
    xs = x.clone().requires_grad_()
    y = bn(xs, train=True, update_stats=True)
    grads = torch.autograd.grad(y, (xs, bn.gamma, bn.beta), g)
    return ([t.detach().numpy() for t in (y, *grads)],
            (bn.mean.numpy(), bn.inv_std.numpy()))


@pytest.mark.parametrize("kind", ["slab grid", "whole grid", "slab pair"])
def test_batch_norm_takes_the_global_batchs_statistics(ranks, kind):
    """On slabs over data x model (each row once), on whole rows over
    'data': the global batch's output, input gradient and running
    statistics on every rank; gamma's and beta's gradients the parts of
    the ranks' rows (summed over the mesh; on whole rows summed over the
    data group, alike over 'model')."""
    res = _phase(ranks, "ops")
    (y, dx, dg, db), stats = _whole_bn()
    h = y.shape[1]
    if kind == "slab pair":
        got = [res[i]["bn_pair"] for i in (0, 1)]
        place = [(slice(None), slice(i * h // 2, (i + 1) * h // 2))
                 for i in (0, 1)]
    else:
        slab = kind == "slab grid"
        got = [res[i]["bn_grid"][0 if slab else 1] for i in range(WORLD)]
        place = [(slice(2 * (i // 2), 2 * (i // 2) + 2),
                  slice((i % 2) * h // 2, (i % 2 + 1) * h // 2) if slab
                  else slice(None)) for i in range(WORLD)]
    for (outs, st), (bi, ri) in zip(got, place):
        np.testing.assert_allclose(outs[0], y[bi, ri], **OP_TOL)
        np.testing.assert_allclose(outs[1], dx[bi, ri], **OP_TOL)
        for a, b in zip(st, stats):
            np.testing.assert_allclose(a, b, **OP_TOL)
    if kind == "whole grid":
        for k in (2, 3):
            np.testing.assert_array_equal(got[0][0][k], got[1][0][k])
            np.testing.assert_allclose(got[0][0][k] + got[2][0][k],
                                       (dg, db)[k - 2], **OP_TOL)
    else:
        for k in (2, 3):
            np.testing.assert_allclose(sum(o[k] for o, _ in got),
                                       (dg, db)[k - 2], **OP_TOL)


def test_gather_rows_inverts_scatter_rows(ranks):
    res = _phase(ranks, "ops")
    r = np.random.RandomState(4)
    x = r.randn(2, 8, 3, 2).astype(np.float32)
    g = r.randn(2, 8, 3, 2).astype(np.float32)
    for i in range(WORLD):
        y, dx = res[i]["round_trip"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(dx, g)


def test_place_keeps_the_rows_and_gather_puts_whole_images_back(ranks):
    res = _phase(ranks, "place")
    full = sw.batch_inputs().numpy()
    for i in range(WORLD):
        d, m = divmod(i, 2)
        mine, back = res[i]
        np.testing.assert_array_equal(mine, full[2 * d:2 * d + 2,
                                                 4 * m:4 * m + 4])
        np.testing.assert_array_equal(back, full)


# the layers on slabs of the 32px U-Net over 2 model ranks, by min_rows
# (in_shp / 2 = 16 rows on slabs of 8 and deeper at min_rows 2: 8 and 4
# rows on slabs of 4 and 2); "up" is dec's conv or deconv
UNET_SLABS = {
    8: {"enc.0.conv", "enc.0.bn", "dec.3.bn", "deconv_out"},
    2: {"enc.0.conv", "enc.0.bn", "enc.1.conv", "enc.1.bn", "enc.2.conv",
        "enc.2.bn", "dec.1.bn", "dec.2.up", "dec.2.bn", "dec.3.up",
        "dec.3.bn", "deconv_out"},
}


@pytest.mark.parametrize("bilinear,min_rows", sw.UNET)
def test_unet_on_a_2x2_mesh_matches_terrain_tpus_unsharded_apply(
        ranks, bilinear, min_rows):
    """tests/test_parallel.py's test_spatial_parallel_matches_unsharded
    for the port: the same weights (models/convert) in terrain_tpu's
    apply on the whole batch."""
    res = _phase(ranks, "unet")
    params, state = convert.to_jax(sw.unet(bilinear))
    net = jp2p.g_unet(sw.IN, True, False, nf=4, bilinear_upsample=bilinear)
    want = np.asarray(jax.jit(lambda p, s, x: net.apply(
        p, s, x, train=True)[0])(params, state, sw.unet_input()))
    for i in range(WORLD):
        d, m = divmod(i, 2)
        got, slabs = res[i][(bilinear, min_rows)]
        up = "conv" if bilinear else "deconv"
        assert set(slabs) == {n.replace("up", up)
                              for n in UNET_SLABS[min_rows]}
        np.testing.assert_allclose(got, want[2 * d:2 * d + 2,
                                             16 * m:16 * m + 16], **UNET_TOL)


def _jax_dcgan(net):
    """terrain_tpu's DCGAN network of the worker's tiny pair."""
    if isinstance(net, dcgan.DCGANGenerator):
        return jdcgan.default_generator(sw.LAT, True, nch=32, h=5,
                                        initial_size=4, final_size=sw.IN,
                                        div=[1, 2, 4])
    return jdcgan.default_discriminator(2 * sw.IN, True, nch=2 * sw.IN, h=5,
                                        div=[1, 1, 1], bn=False,
                                        pool_mode="avg",
                                        nonlinearity="linear")


@pytest.fixture(scope="module")
def dcgan_references():
    """terrain_tpu's output of the worker's tiny DCGAN pair on the whole
    batch, train mode, and its gradients (each network's parameters' in
    the port's order, and its input's) of a seeded cotangent's dot
    product with the output, by network."""
    out = {}
    z, x, gy, gs = sw.dcgan_inputs()
    for net, port, inp, cot in zip(("generator", "discriminator"),
                                   sw.dcgan_nets(), (z, x), (gy, gs)):
        params, state = convert.to_jax(port)
        jnet = _jax_dcgan(port)

        def f(p, v):
            y = jnet.apply(p, state, v, train=True)[0]
            return jnp.sum(y * cot), y

        (gp, gx), y = jax.jit(jax.grad(f, argnums=(0, 1), has_aux=True))(
            params, inp)
        out[net] = (np.asarray(y), [t.numpy() for t in
                                    convert.params_from_jax(
                                        port, jax.tree.map(np.asarray, gp))],
                    np.asarray(gx))
    return out


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("min_rows", sw.DCGAN)
def test_dcgan_on_a_2x2_mesh_matches_terrain_tpus_unsharded_apply(
        ranks, dcgan_references, net, min_rows):
    """The worker's tiny DCGAN pair held in slabs on a 2x2 mesh against
    the same weights (models/convert) in terrain_tpu's apply on the
    whole batch, train mode: each rank's rows of its data block's
    output, and the gradients of a seeded cotangent's dot product with
    the whole output (the discriminator's input's: its rows)."""
    res = _phase(ranks, "dcgan")
    want_y, want_g, gx = dcgan_references[net]
    for i in range(WORLD):
        dd, m = divmod(i, 2)
        got = res[i][min_rows]
        if net == "generator":
            y_i, grads = got[0], got[1]
            np.testing.assert_allclose(
                y_i, want_y[2 * dd:2 * dd + 2, 16 * m:16 * m + 16],
                **UNET_TOL)
        else:
            y_i, dx, grads = got[2], got[3], got[4]
            np.testing.assert_allclose(y_i, want_y[2 * dd:2 * dd + 2],
                                       **UNET_TOL)
            np.testing.assert_allclose(
                dx, gx[2 * dd:2 * dd + 2, 32 * m:32 * m + 32], **UNET_TOL)
        assert len(grads) == len(want_g)
        for j, (a, b) in enumerate(zip(grads, want_g)):
            np.testing.assert_allclose(a, b, err_msg=f"{net} {j}",
                                       **UNET_TOL)


def _jax_generator(port):
    """terrain_tpu's DCGAN generator of a port generator's config."""
    c = port.config
    return jdcgan.default_generator(
        c["latent_dim"], c["out_ch"] == 1, nch=c["nch"], h=c["h"],
        initial_size=c["initial_size"], final_size=c["final_size"],
        div=list(c["div"]), bilinear_upsample=c["bilinear_upsample"])


@pytest.fixture(scope="module")
def bilinear_references():
    """terrain_tpu's output of the worker's bilinear generators on the
    whole batch, train mode, and the gradients of the seeded cotangent's
    dot product with it, by h."""
    out = {}
    z, _, gy, _ = sw.dcgan_inputs()
    for h in (3, 5):
        port = sw.bilinear_generator(h)
        params, state = convert.to_jax(port)
        jnet = _jax_generator(port)

        def f(p):
            y = jnet.apply(p, state, z, train=True)[0]
            return jnp.sum(y * gy), y

        gp, y = jax.jit(jax.grad(f, has_aux=True))(params)
        out[h] = (np.asarray(y), [t.numpy() for t in convert.params_from_jax(
            port, jax.tree.map(np.asarray, gp))])
    return out


@pytest.mark.parametrize("mesh,h,min_rows", sw.BILINEAR)
def test_bilinear_dcgan_generator_on_slabs_matches_terrain_tpus_apply(
        ranks, bilinear_references, mesh, h, min_rows):
    """The DCGAN generator with bilinear_upsample (each stage's bilinear
    x2 and h x h conv on the slab with `upsample_halo`'s rows: one a side
    at h 3, two at h 5) held in slabs on a 1x2 and a 1x4 mesh against
    the same weights in terrain_tpu's apply on the whole batch, train
    mode: each rank's rows of the output and every gradient of a seeded
    cotangent's dot product with the whole output."""
    res = _phase(ranks, "bilinear")
    want_y, want_g = bilinear_references[h]
    n = MESHES[mesh][1]
    r = sw.IN // n
    for i in _members(mesh):
        y_i, grads = res[i][(mesh, h, min_rows)]
        np.testing.assert_allclose(y_i, want_y[:, r * i:r * (i + 1)],
                                   **UNET_TOL)
        assert len(grads) == len(want_g)
        for j, (a, b) in enumerate(zip(grads, want_g)):
            np.testing.assert_allclose(a, b, err_msg=f"{h} {j}", **UNET_TOL)


@pytest.mark.parametrize("k,taps,want", [(3, 2, 1), (5, 2, 2), (7, 2, 2),
                                         (3, 1, 1), (5, 1, 1), (1, 2, 1)])
def test_upsample_halo_counts_the_rows_the_taps_read(k, taps, want):
    """The low-resolution halo of a 2x upsample (2 taps bilinear, 1
    nearest) then a k x k 'same' conv: the farthest low-resolution row
    that the slab's first output row reads, by brute force on the taps."""
    from terrain_tpu_torch.parallel.spatial import upsample_halo

    p = (k - 1) // 2
    a, r = 10, 4  # the slab's low-resolution rows a .. a+r-1
    reads = {1: lambda y: [y // 2],
             2: lambda y: [(y - 1) // 2, (y + 1) // 2]}[taps]
    first = min(j for y in range(2 * a - p, 2 * a + p + 1) for j in reads(y))
    last = max(j for y in range(2 * (a + r) - 1 - p, 2 * (a + r) + p)
               for j in reads(y))
    assert a - first == last - (a + r - 1) == want == upsample_halo(k, taps)


def _jax_step_nets():
    return {
        "dcgan_gen": jdcgan.default_generator(
            sw.LAT, True, nch=8, h=3, initial_size=4, final_size=sw.IN,
            div=[2, 2, 2]),
        "dcgan_disc": jdcgan.default_discriminator(
            sw.IN, True, nch=sw.IN, h=3, div=[4, 2], bn=False,
            nonlinearity="linear", conv_out_nonlinearity="linear"),
        "p2p_gen": jp2p.g_unet(sw.IN, True, False, nf=4, act="tanh",
                               bilinear_upsample=True),
        "p2p_disc": jp2p.discriminator(sw.IN, True, False, nf=4, bn=False,
                                       act="linear",
                                       mul_factor=[1, 2, 4, 8]),
    }


@pytest.fixture(scope="module")
def references():
    """terrain_tpu's losses and four networks' gradients of one step of
    the tiny configuration on the global batch, and the port's
    one-process step's in the both mode, each gradient list in the port's
    parameter order.  The losses partition the gradients, so each mode's
    networks take the both mode's."""
    gan = TwoStageGAN(**sw.step_kw("both"))
    trees = {n: convert.to_jax(net) for n, net in gan.nets.items()}
    params = {n: t[0] for n, t in trees.items()}
    states = {n: t[1] for n, t in trees.items()}
    jnets = _jax_step_nets()
    active = ACTIVE["both"]
    batch = tuple(map(jnp.asarray, sw.step_batch()))

    def total(diff):
        losses, _ = jstep.forward_losses(
            jnets, {**params, **diff}, states, *batch, jax.random.PRNGKey(0),
            alpha=100.0, lsgan=True, reconstruction="l1", train=True)
        return jstep._total(losses, active, 100.0), losses

    grads, losses = jax.jit(jax.grad(total, has_aux=True))(
        {n: params[n] for n in active})
    jax_ref = ({k: float(v) for k, v in losses.items()},
               {n: [t.numpy() for t in convert.params_from_jax(
                   gan.nets[n], jax.tree.map(np.asarray, grads[n]))]
                for n in active})
    rec = sw.recording(gan)
    gan.train_step, _ = gan._build_steps(None)
    one = sw.run_step(gan, gan.train_step, rec, sw.step_batch())
    return {"terrain_tpu": jax_ref, "one process": one}


def _check_step(got, want, mode):
    """Every rank's losses and its active networks' gradients."""
    want_losses, want_grads = want
    for losses, grads in got:
        assert set(grads) == set(ACTIVE[mode])
        for k, v in want_losses.items():
            np.testing.assert_allclose(losses[k], v, err_msg=k, **STEP_TOL)
        for n in ACTIVE[mode]:
            assert len(grads[n]) == len(want_grads[n])
            for j, (a, b) in enumerate(zip(grads[n], want_grads[n])):
                np.testing.assert_allclose(a, b, err_msg=f"{n} {j}",
                                           **STEP_TOL)


@pytest.mark.parametrize("ref", ["terrain_tpu", "one process"])
@pytest.mark.parametrize("mesh,min_rows", sw.STEP)
def test_spatial_p2p_step_matches(ranks, references, ref, mesh, min_rows):
    """Every rank returns the global batch's five losses and updates with
    the whole gradients of the pix2pix networks."""
    res = _phase(ranks, "step")
    _check_step([res[i][("p2p", mesh, min_rows)] for i in range(WORLD)],
                references[ref], "p2p")


@pytest.mark.parametrize("ref", ["terrain_tpu", "one process"])
@pytest.mark.parametrize("mode,mesh,min_rows", sw.MODE_STEP)
def test_spatial_both_and_dcgan_steps_match(ranks, references, ref, mode,
                                            mesh, min_rows):
    """The four networks held in slabs, in the both and dcgan modes: every
    rank returns the global batch's five losses and updates with the
    whole gradients of the mode's networks."""
    res = _phase(ranks, "step")
    _check_step([res[i][(mode, mesh, min_rows)] for i in range(WORLD)],
                references[ref], mode)


def test_build_train_takes_a_mesh_for_every_mode(ranks):
    """smoke_synthetic (the both mode) on a 1x2 mesh: both ranks' train
    and eval steps give one process's losses."""
    res = _phase(ranks, "build")
    want = sw.build_steps(experiments.build_train("smoke_synthetic", "cpu"))
    for i in (0, 1):
        for got, ref in zip(res[i], want):
            for k, v in ref.items():
                np.testing.assert_allclose(got[k], v, err_msg=k, **STEP_TOL)


def test_build_train_steps_run_as_a_chunk(ranks):
    """TERRAIN_SCAN's chunk takes the spatial step: two train and two eval
    steps of build_train("smoke_synthetic", mesh=) on a 1x2 mesh as chunks
    of 2 (a loop over gloo) give each rank the losses and the parameters
    of the two steps one by one, to the bit."""
    res = _phase(ranks, "build_chunk")
    for i in (0, 1):
        (tr, ev, params), (tr2, ev2, params2) = (res[i]["steps"],
                                                 res[i]["chunk"])
        for got, want in ((tr2, tr), (ev2, ev)):
            assert got.keys() == want.keys()
            for k in want:
                assert want[k].shape == (2,)
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(params2) == len(params)
        for a, b in zip(params2, params):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bilinear", [False, True],
                         ids=["nearest", "bilinear"])
def test_an_even_h_generator_matches_terrain_tpu_on_one_device(bilinear):
    """An even h shrinks each 'same' conv's output by one row in both
    packages ((h-1)//2 rows of padding a side): h 4 from 4 over three
    stages gives 17 rows, not final_size's 32, and the same values."""
    g = dcgan.default_generator(sw.LAT, True, nch=32, h=4, initial_size=4,
                                final_size=sw.IN, div=[1, 2, 4],
                                bilinear_upsample=bilinear,
                                generator=torch.Generator().manual_seed(5))
    params, state = convert.to_jax(g)
    z = sw.dcgan_inputs()[0]
    want = np.asarray(_jax_generator(g).apply(params, state, z,
                                              train=True)[0])
    got = g(torch.from_numpy(z), train=True).detach().numpy()
    assert got.shape == want.shape == (sw.GLOBAL_BATCH, 17, 17, 1)
    np.testing.assert_allclose(got, want, **UNET_TOL)


@pytest.mark.parametrize("bilinear", [False, True],
                         ids=["nearest", "bilinear"])
def test_an_even_h_generator_on_slabs_raises_naming_why(bilinear):
    """On slabs an even h raises before any layer runs: its heights are
    no equal slabs."""
    g = dcgan.default_generator(sw.LAT, True, nch=8, h=4, initial_size=4,
                                final_size=sw.IN, div=[2, 2, 2],
                                bilinear_upsample=bilinear)
    g.rows = RowShard(0, 2, None)
    with pytest.raises(ValueError, match="even h .*equal slabs"):
        g(torch.zeros(2, sw.LAT), train=True)


@pytest.fixture(scope="module")
def bilinear_one_process():
    gan = TwoStageGAN(**sw.step_kw("both", bilinear=True))
    rec = sw.recording(gan)
    gan.train_step, _ = gan._build_steps(None)
    return sw.run_step(gan, gan.train_step, rec, sw.step_batch())


@pytest.mark.parametrize("mesh,min_rows", sw.BILINEAR_STEP)
def test_spatial_both_step_with_the_bilinear_generator_matches(
        ranks, bilinear_one_process, mesh, min_rows):
    """The both mode with the DCGAN generator's bilinear upsample at h 5
    on slabs: every rank's losses and gradients are one process's."""
    res = _phase(ranks, "step")
    _check_step([res[i][("bilinear", mesh, min_rows)]
                 for i in range(WORLD)], bilinear_one_process, "both")

"""terrain_tpu_torch's generators, samplers, weight conversion and
checkpoints against terrain_tpu's on the CPU, at the smoke_synthetic sizes
(terrain_tpu/experiments.py:282-307), fp32.

Weights are Glorot draws in terrain_tpu's tree layout (whose key paths and
shapes are held against terrain_tpu's init), with BN statistics and affine
parameters perturbed so the deterministic mode is not an identity, fed to
terrain_tpu as they are and carried into the port by models/convert.py.  Tolerance: 2e-4 absolute on outputs in
[0,1] / [-1,1] (fp32 sums in another order through ~10 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import param_count as jparam_count
from terrain_tpu.models import unet as junet
from terrain_tpu.sample import make_two_stage_sampler
from terrain_tpu.train import checkpoint as jckpt
from terrain_tpu_torch.experiments import build_model
from terrain_tpu_torch.models import convert, dcgan, param_count, unet
from terrain_tpu_torch.sample import TwoStagePipeline
from terrain_tpu_torch.train import checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=0, atol=2e-4)
LATENT, SIZE = 32, 64
DCGAN_KW = dict(nch=64, h=3, initial_size=4, final_size=SIZE,
                div=[2, 2, 4, 4])
UNET_KW = dict(nf=8, act="tanh", bilinear_upsample=True)


def _perturb(tree, rng):
    """BN gamma/beta/mean/inv_std -> random values in sane ranges."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("gamma", "inv_std"):
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k in ("beta", "mean"):
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = _perturb(v, rng)
        return out
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return np.asarray(tree)


def _trees(module, rng):
    """terrain_tpu-layout trees with Glorot weights and perturbed BN (the
    shapes and key paths are checked against terrain_tpu's init below)."""
    p, s = convert.to_jax(module)
    return _perturb(p, rng), _perturb(s, rng)


def _jit_apply(net, train):
    return jax.jit(lambda p, s, x: net.apply(p, s, x, train=train)[0])


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(7)
    jd = jdcgan.default_generator(LATENT, True, **DCGAN_KW)
    ju = junet.g_unet(SIZE, True, False, **UNET_KW)
    g = torch.Generator().manual_seed(0)
    pd, sd = _trees(dcgan.default_generator(LATENT, True, generator=g,
                                            **DCGAN_KW), rng)
    pu, su = _trees(unet.g_unet(SIZE, True, False, generator=g, **UNET_KW),
                    rng)
    td = convert.load_jax(dcgan.default_generator(LATENT, True, **DCGAN_KW),
                          pd, sd)
    tu = convert.load_jax(unet.g_unet(SIZE, True, False, **UNET_KW), pu, su)
    return jd, ju, (pd, sd), (pu, su), td, tu


@pytest.mark.parametrize("train", [False, True])
def test_dcgan_generator_matches_jax(nets, train, rng):
    jd, _, (pd, sd), _, td, _ = nets
    z = rng.rand(3, LATENT).astype(np.float32)
    want = _jit_apply(jd, train)(pd, sd, jnp.asarray(z))
    with torch.inference_mode():
        got = td(torch.from_numpy(z), train=train)
    assert tuple(got.shape) == (3, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_unet_generator_matches_jax(nets, train, rng):
    _, ju, _, (pu, su), _, tu = nets
    x = rng.rand(2, SIZE, SIZE, 1).astype(np.float32)
    want = _jit_apply(ju, train)(pu, su, jnp.asarray(x))
    with torch.inference_mode():
        got = tu(torch.from_numpy(x), train=train)
    assert tuple(got.shape) == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def two_stage(nets):
    """terrain_tpu's two-stage samplers and their det output on Z."""
    jd, ju, (pd, sd), (pu, su), _, _ = nets
    det, stoch = make_two_stage_sampler(jd, ju)
    return det, stoch, det(pd, sd, pu, su, jnp.asarray(Z))


Z = np.random.RandomState(3).rand(2, LATENT).astype(np.float32)


def test_two_stage_sampler_matches_jax(nets, two_stage):
    jd, ju, (pd, sd), (pu, su), td, tu = nets
    det, stoch, want_det = two_stage
    pipe = TwoStagePipeline(td, tu, latent_dim=LATENT, in_shp=SIZE,
                            device="cpu")
    z = Z
    for (wa, wb), (ga, gb) in (
            (want_det, pipe.two_stage_det(torch.from_numpy(z))),
            # no dropout in this config: stoch = batch statistics
            (stoch(pd, sd, pu, su, jnp.asarray(z), jax.random.PRNGKey(3)),
             pipe.two_stage_stoch(torch.from_numpy(z),
                                  torch.Generator().manual_seed(3)))):
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)
    # the samplers read the running statistics and never write them
    np.testing.assert_array_equal(td.bn_in.mean.numpy(), sd["bn_in"]["mean"])


def test_unet_dropout_blocks(nets, rng):
    pu, su = nets[3]
    tu = convert.load_jax(
        unet.g_unet(SIZE, True, False, dropout=0.5, **UNET_KW), pu, su)
    nodrop = nets[5]  # held against terrain_tpu's apply above
    xt = torch.from_numpy(rng.rand(2, SIZE, SIZE, 1).astype(np.float32))
    with torch.inference_mode():
        # det: dropout off, the same map as without dropout
        np.testing.assert_array_equal(tu(xt).numpy(), nodrop(xt).numpy())
        s1 = tu(xt, train=True, generator=torch.Generator().manual_seed(1))
        s1b = tu(xt, train=True, generator=torch.Generator().manual_seed(1))
        s2 = tu(xt, train=True, generator=torch.Generator().manual_seed(2))
        s0 = nodrop(xt, train=True)
    np.testing.assert_array_equal(s1.numpy(), s1b.numpy())
    assert not torch.equal(s1, s2) and not torch.equal(s1, s0)


def test_convert_roundtrip_and_flagship_shapes(nets):
    jd0, ju0, (pd, sd), (pu, su), td, tu = nets
    for mod, (p, s) in ((td, (pd, sd)), (tu, (pu, su))):
        q, t = convert.to_jax(mod)
        jax.tree.map(np.testing.assert_array_equal, q, p)
        jax.tree.map(np.testing.assert_array_equal, t, s)
    # smoke and full-width flagship: the same trees, leaf for leaf, as
    # terrain_tpu's init
    pipe, _ = build_model("test1_nobn_bilin_both", "cpu")
    jd = jdcgan.default_generator(1000, True, num_repeats=0,
                                  div=[2, 2, 4, 4, 8, 8, 8])
    ju = junet.g_unet(512, True, False, nf=64, act="tanh", num_repeats=0,
                      bilinear_upsample=True)
    for jnet, mod in ((jd0, td), (ju0, tu), (jd, pipe.dcgan_gen),
                      (ju, pipe.p2p_gen)):
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
        q, t = convert.to_jax(mod)
        assert jax.tree.structure((q, t)) == jax.tree.structure(shapes)
        jax.tree.map(lambda a, b: a.shape == b.shape or pytest.fail(
            f"{a.shape} != {b.shape}"), (q, t), shapes)
        assert param_count(mod) == jparam_count(shapes[0])
    assert param_count(pipe.dcgan_gen) == 14_774_657


def test_convert_rejects_mismatched_trees(nets):
    _, _, (pd, sd), _, td, _ = nets
    bad = dict(pd, dense={"w": pd["dense"]["w"][:, :4], "b": pd["dense"]["b"]})
    with pytest.raises(ValueError, match="dense"):
        convert.load_jax(td, bad, sd)
    with pytest.raises(ValueError):
        convert.load_jax(td, {k: v for k, v in pd.items() if k != "conv_out"},
                         sd)


def test_checkpoints_cross_packages(nets, two_stage, tmp_path):
    jd, ju, (pd, sd), (pu, su), _, _ = nets
    path = str(tmp_path / "5.model")
    jckpt.save_model(path, {"dcgan_gen": pd, "dcgan_disc": {},
                            "p2p_gen": pu, "p2p_disc": {}},
                     {"dcgan_gen": sd, "dcgan_disc": {},
                      "p2p_gen": su, "p2p_disc": {}})
    pipe, _ = build_model("smoke_synthetic", "cpu", seed=9)
    z = Z
    before = pipe.two_stage_det(torch.from_numpy(z))[1]
    pipe.load_model(path, mode="p2p")  # stage-partial: the U-Net only
    mid_a, mid_b = pipe.two_stage_det(torch.from_numpy(z))
    assert not torch.equal(before, mid_b)
    pipe.load_model(path)
    a, b = pipe.two_stage_det(torch.from_numpy(z))
    wa, wb = two_stage[2]
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(wb), **TOL)
    # and the port writes what terrain_tpu reads
    p, s = pipe.to_jax()
    out = str(tmp_path / "6.model")
    checkpoint.save_model(out, dict(p, dcgan_disc={}, p2p_disc={}),
                          dict(s, dcgan_disc={}, p2p_disc={}))
    jp, js, _ = jckpt.load_model(out, {}, {})
    jax.tree.map(np.testing.assert_array_equal, jp["p2p_gen"], pu)
    jax.tree.map(np.testing.assert_array_equal, js["dcgan_gen"], sd)
    with pytest.raises(ValueError, match="mode"):
        pipe.load_model(out, mode="gen")


def test_a_checkpoint_in_many_gzip_members_reads_in_both_packages(
        nets, tmp_path, monkeypatch):
    """save_model writes its pickle as gzip members compressed on host
    threads; with members far smaller than the payload, terrain_tpu's
    loader and the port's read back the same arrays."""
    import zlib

    _, _, (pd, sd), (pu, su), _, _ = nets
    monkeypatch.setattr(checkpoint, "CHUNK", 4096)
    out = str(tmp_path / "7.model")
    checkpoint.save_model(out, {"dcgan_gen": pd, "dcgan_disc": {},
                                "p2p_gen": pu, "p2p_disc": {}},
                          {"dcgan_gen": sd, "dcgan_disc": {},
                           "p2p_gen": su, "p2p_disc": {}},
                          extra={"lr": 1e-4})
    with open(out, "rb") as f:
        raw = f.read()
    first = zlib.decompressobj(31)
    first.decompress(raw)
    assert len(first.unused_data) > 0  # more members follow the first
    jp, js, _ = jckpt.load_model(out, {}, {})
    jax.tree.map(np.testing.assert_array_equal, jp["p2p_gen"], pu)
    jax.tree.map(np.testing.assert_array_equal, js["dcgan_gen"], sd)
    got, extra = checkpoint.load_model(out)
    jax.tree.map(np.testing.assert_array_equal, got["dcgan_gen"][0], pd)
    assert extra == {"lr": 1e-4}

"""The port's reference-weights importer
(terrain_tpu_torch/tools/import_reference_weights.py) against the JAX
package's (tools/import_reference_weights.py): the same payload, written as
the reference writes it (a gzip-pickle at protocol 2, read with
encoding="latin1"), imports into the port's networks as `load_jax` carries
the JAX model's trees; the forward agrees; the port's export equals the JAX
tool's array for array; the checkpoint the port's CLI writes loads in
terrain_tpu.train.checkpoint.  The models are tiny."""

import gzip
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from terrain_tpu_torch.models import convert
from terrain_tpu_torch.tools import import_reference_weights as port_tool
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, LAT = 16, 8
DCGAN = {"nch": 8, "h": 3, "initial_size": 4, "final_size": IN,
         "div": [2, 2]}
DCGAN_DISC = {"nch": IN, "h": 3, "div": [4, 2], "bn": True,
              "nonlinearity": "linear"}


def _p2p(bilinear):
    return {"nf": 4, "act": "tanh", "num_repeats": 1,
            "bilinear_upsample": bilinear}


P2P_DISC = {"nf": 4, "bn": True, "act": "linear"}


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import import_reference_weights as jax_tool
    finally:
        sys.path.pop(0)
    return jax_tool


def _jax_model(bilinear, seed):
    from terrain_tpu.models import dcgan, p2p
    from terrain_tpu.train.trainer import TwoStageGAN

    return TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan=DCGAN, disc_params_dcgan=DCGAN_DISC,
        gen_fn_p2p=p2p.g_unet, disc_fn_p2p=p2p.discriminator,
        gen_params_p2p=_p2p(bilinear), disc_params_p2p=P2P_DISC,
        in_shp=IN, latent_dim=LAT, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": 1e-4}, verbose=False, seed=seed)


def _port_model(bilinear, seed):
    from terrain_tpu_torch.models import dcgan, unet
    from terrain_tpu_torch.train.trainer import TwoStageGAN

    return TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan=DCGAN, disc_params_dcgan=DCGAN_DISC,
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        gen_params_p2p=_p2p(bilinear), disc_params_p2p=P2P_DISC,
        in_shp=IN, latent_dim=LAT, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": 1e-4}, verbose=False, seed=seed,
        device="cpu")


def _reference_pickle(payload, path):
    """The payload as the reference writes it: a gzip-pickle at protocol
    2 (Python 2's highest), read back as the importers read it."""
    with gzip.open(path, "wb") as f:
        pickle.dump(payload, f, protocol=2)
    with gzip.open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _same_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_trees(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


def _seed_bn_state(jm):
    """Non-trivial BN running statistics, so the state walks are held."""
    import jax

    rnd = np.random.RandomState(5)
    jm.states = jax.tree.map(
        lambda a: np.asarray(rnd.rand(*np.shape(a)) + 0.5, np.float32),
        jm.states)


@pytest.fixture(scope="module", params=[False, True],
                ids=["deconv", "bilinear"])
def payload_case(request, tmp_path_factory):
    """(bilinear, JAX model, its reference payload read from a pickle)."""
    jax_tool = _jax_tool()
    jm = _jax_model(request.param, seed=0)
    _seed_bn_state(jm)
    path = tmp_path_factory.mktemp("ref") / "ref.model"
    return request.param, jm, _reference_pickle(
        jax_tool.export_from_model(jm), path)


def test_import_equals_load_jax_of_the_jax_model(payload_case):
    bilinear, jm, payload = payload_case
    mine = port_tool.import_into_model(payload, _port_model(bilinear, 9))
    want = _port_model(bilinear, 3)
    for n in want.nets:
        convert.load_jax(want.nets[n], jm.params[n], jm.states[n])
        sd_a, sd_b = mine.nets[n].state_dict(), want.nets[n].state_dict()
        assert sorted(sd_a) == sorted(sd_b)
        for k in sd_a:
            assert torch.equal(sd_a[k], sd_b[k]), (n, k)


def test_the_imported_forward_agrees(payload_case):
    import jax.numpy as jnp

    bilinear, jm, payload = payload_case
    mine = port_tool.import_into_model(payload, _port_model(bilinear, 9))
    z = np.random.RandomState(1).rand(2, LAT).astype(np.float32)
    want, _ = jm.nets["dcgan_gen"].apply(
        jm.params["dcgan_gen"], jm.states["dcgan_gen"], jnp.asarray(z),
        train=False)
    g = mine.nets["dcgan_gen"].eval()
    with torch.no_grad():
        got = g(torch.from_numpy(z), train=False)
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    x = np.random.RandomState(2).rand(2, IN, IN, 1).astype(np.float32)
    want, _ = jm.nets["p2p_gen"].apply(
        jm.params["p2p_gen"], jm.states["p2p_gen"], jnp.asarray(x),
        train=False)
    with torch.no_grad():
        got = mine.nets["p2p_gen"].eval()(torch.from_numpy(x), train=False)
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_the_export_is_the_jax_tools(payload_case):
    bilinear, jm, payload = payload_case
    jax_tool = _jax_tool()
    mine = port_tool.import_into_model(payload, _port_model(bilinear, 9))
    _same_trees(port_tool.export_from_model(mine),
                jax_tool.export_from_model(jm))
    # and a round trip from a fresh port model is exact
    src = _port_model(bilinear, 4)
    dst = port_tool.import_into_model(port_tool.export_from_model(src),
                                      _port_model(bilinear, 5))
    for n in src.nets:
        for (k, a), b in zip(src.nets[n].state_dict().items(),
                             dst.nets[n].state_dict().values()):
            assert torch.equal(a, b), (n, k)


@pytest.mark.parametrize("fn", ["conv_w_from_ref", "conv_w_to_ref",
                                "deconv_w_from_ref", "deconv_w_to_ref"])
def test_the_weight_conversions_are_the_jax_tools(fn, rng):
    W = rng.randn(4, 3, 5, 5).astype(np.float32)
    np.testing.assert_array_equal(getattr(port_tool, fn)(W),
                                  getattr(_jax_tool(), fn)(W))


def test_the_dense_permutation_is_the_jax_tools(rng):
    jax_tool = _jax_tool()
    for v in (rng.randn(3 * 2 * 2), rng.randn(5, 3 * 2 * 2)):
        for fn in ("dense_feats_from_ref", "dense_feats_to_ref"):
            np.testing.assert_array_equal(getattr(port_tool, fn)(v, 3, 2),
                                          getattr(jax_tool, fn)(v, 3, 2))


def test_a_short_or_long_payload_raises(payload_case):
    bilinear, _, payload = payload_case
    short = {s: dict(r) for s, r in payload.items()}
    short["p2p"]["gen"] = payload["p2p"]["gen"][:-1]
    with pytest.raises(ValueError, match="exhausted"):
        port_tool.import_into_model(short, _port_model(bilinear, 1))
    long = {s: dict(r) for s, r in payload.items()}
    long["dcgan"]["disc"] = payload["dcgan"]["disc"] + [np.zeros(1)]
    with pytest.raises(ValueError, match="unconsumed"):
        port_tool.import_into_model(long, _port_model(bilinear, 1))


def test_the_cli_writes_a_checkpoint_terrain_tpu_loads(tmp_path):
    """The CLI on the CPU: a reference pickle of the flagship's shapes (the
    port's own export of a seeded model) -> a terrain_tpu/v1 checkpoint
    whose trees terrain_tpu.train.checkpoint reads back equal."""
    from terrain_tpu.train import checkpoint as jckpt
    from terrain_tpu_torch.experiments import build_gan

    src, _ = build_gan("smoke_synthetic", "cpu", verbose=False)
    ref = tmp_path / "ref.model"
    _reference_pickle(port_tool.export_from_model(src), ref)
    out = tmp_path / "out.model"
    assert port_tool.main([str(ref), str(out), "--experiment",
                           "smoke_synthetic", "--device", "cpu"]) == 0
    want = {n: convert.to_jax(src.nets[n]) for n in src.nets}
    zeros = {n: [_zeros(t) for t in want[n]] for n in want}
    params, states, _ = jckpt.load_model(
        str(out), {n: z[0] for n, z in zeros.items()},
        {n: z[1] for n, z in zeros.items()})
    for n, (want_p, want_s) in want.items():
        _same_trees(params[n], want_p)
        _same_trees(states[n], want_s)


def _zeros(tree):
    """`tree`'s structure with every array zero (what the file must fill)."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros(v) for v in tree]
    return np.zeros_like(np.asarray(tree))

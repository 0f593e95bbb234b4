"""terrain_tpu_torch's trainer against terrain_tpu's on the CPU, fp32, at the
smoke_synthetic configuration (64px, small networks, no dropout): the slice
as a whole, through `TwoStageGAN.train` and the CLI.

Both trainers start from the same weights (terrain_tpu's init, carried
across by models/convert), see the same device-resident synthetic pairs, the
same prior Z (the global numpy stream, seeded before each run) and the same
epoch order (`RandomState(seed)`), with augmentation off (its draws come
from different generators in the two packages).  The port runs with both
kernel switches on: on CPU tensors `pool2` then runs its plain version in
three of the discriminator's four pool stages; `conv_s2`'s regime starts at
256px, beyond a CPU test (tests/test_torch_kernels_s2pool.py holds its plain
version and its dispatch).  terrain_tpu runs its default path, whose values
are the same.

Tolerance: 2e-4 relative on every loss column of results.txt (fp32 sums in
another order through two epochs of four steps).

The trainer's tests that need no JAX trainer are in
tests/test_torch_trainer_cli.py, so that pytest-xdist runs the two files on
different workers.
"""

import os

import jax
import numpy as np
import pytest
import torch

from terrain_tpu.data import DeviceDataset as JDeviceDataset
from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.train.trainer import TwoStageGAN as JTwoStageGAN
from terrain_tpu_torch import experiments
from terrain_tpu_torch.data import DeviceDataset
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.models import convert
from terrain_tpu_torch.ops.kernels import pool2
from tiny_cfg import csv_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS, N, SIZE = 4, 16, 64
LOSS_TOL = 2e-4
SWITCHES = {"TERRAIN_POOL_VJP": "pallas", "TERRAIN_PALLAS_CONVS2": "1"}
LOSS_COLS = [f"{s}_{k}" for s in ("train", "valid")
             for k in JTwoStageGAN.train_keys]


@pytest.fixture(autouse=True)
def _restore_environ():
    """`experiments.run` sets an experiment's environment defaults with
    `os.environ.setdefault`, as terrain_tpu does; keep them out of the tests
    that follow in this process."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _jax_gan():
    """terrain_tpu's smoke_synthetic model (experiments._build_smoke) with
    augmentation off."""
    return JTwoStageGAN(
        gen_fn_dcgan=jdcgan.default_generator,
        disc_fn_dcgan=jdcgan.default_discriminator,
        gen_params_dcgan={"nch": 64, "h": 3, "initial_size": 4,
                          "final_size": 64, "div": [2, 2, 4, 4]},
        disc_params_dcgan={"nch": 64, "h": 3, "div": [4, 2, 2, 1],
                           "bn": False, "nonlinearity": "linear"},
        gen_fn_p2p=jp2p.g_unet, disc_fn_p2p=jp2p.discriminator,
        gen_params_p2p={"nf": 8, "act": "tanh", "bilinear_upsample": True},
        disc_params_p2p={"nf": 8, "bn": False, "act": "linear"},
        in_shp=SIZE, latent_dim=32, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": 1e-4}, train_mode="both", verbose=False,
        da=False)


def _torch_gan(weights):
    gan, _ = experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                   da=False)
    for n, (p, s) in weights.items():
        convert.load_jax(gan.nets[n], p, s)
    return gan


def _data(cls, **kw):
    return (cls(*make_pairs(N, SIZE, seed=0), **kw),
            cls(*make_pairs(4, SIZE, seed=1), **kw))


def _train(gan, data, root, epochs, **kw):
    np.random.seed(0)
    gan.train(*data, BS, epochs, str(root / "out"), str(root / "models"),
              save_every=1, **kw)
    return csv_rows(str(root / "out" / "results.txt"))


def _assert_rows_close(got, want):
    for col in LOSS_COLS:
        assert float(got[col]) == pytest.approx(float(want[col]),
                                                rel=LOSS_TOL), col


def _resumed_row(runs, out_dir):
    """The one row of a results.txt that a resume into a fresh directory
    appended to (no header: a resume appends), under the run's header."""
    with open(runs["root"] / "jax" / "out" / "results.txt") as f:
        header = f.readline().strip().split(",")
    (line,) = (out_dir / "results.txt").read_text().splitlines()
    return dict(zip(header, line.split(","), strict=True))


def _weights(gan):
    return {n: [p.detach().clone() for p in net.parameters()]
            + [b.detach().clone() for b in net.buffers()]
            for n, net in gan.nets.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs in both trainers from the same seeds; the port with both
    kernel switches on."""
    root = tmp_path_factory.mktemp("trainer")
    jgan = _jax_gan()
    weights = {n: (jax.tree.map(np.asarray, jgan.params[n]),
                   jax.tree.map(np.asarray, jgan.states[n]))
               for n in jgan.nets}
    jrows = _train(jgan, _data(JDeviceDataset), root / "jax", 2)
    mp = pytest.MonkeyPatch()
    for k, v in SWITCHES.items():
        mp.setenv(k, v)
    try:
        pool2.PLAIN.calls = 0
        tgan = _torch_gan(weights)
        trows = _train(tgan, _data(DeviceDataset, device="cpu"),
                       root / "torch", 2)
        plain_calls = pool2.PLAIN.calls
    finally:
        mp.undo()
    return dict(root=root, jgan=jgan, tgan=tgan, weights=weights,
                jrows=jrows, trows=trows, plain_calls=plain_calls)


def test_results_match_jax_with_switches_on(runs):
    assert len(runs["jrows"]) == len(runs["trows"]) == 2
    for got, want in zip(runs["trows"], runs["jrows"]):
        assert got["epoch"] == want["epoch"] and got["mode"] == "both"
        _assert_rows_close(got, want)
    # 4 train steps x (3 fwd x 2 passes + 3 bwd x 2) + 1 eval step x 6, per
    # epoch: the switch sent the pools through ops/kernels/pool2
    assert runs["plain_calls"] == 2 * (4 * 12 + 6)


def test_results_match_jax_with_switches_off(runs, tmp_path, monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    pool2.PLAIN.calls = 0
    rows = _train(_torch_gan(runs["weights"]),
                  _data(DeviceDataset, device="cpu"), tmp_path, 2)
    assert pool2.PLAIN.calls == 0
    for got, want in zip(rows, runs["jrows"], strict=True):
        _assert_rows_close(got, want)


def test_results_header_dumps_and_checkpoints(runs):
    out = runs["root"] / "torch" / "out"
    jout = runs["root"] / "jax" / "out"
    with open(out / "results.txt") as f, open(jout / "results.txt") as g:
        assert f.readline() == g.readline()
    for name in ("out_1.png", "out_2.png", "dump_train/3.b.png",
                 "dump_valid/0.a.png", "dump_a/19.png",
                 "arch_dcgan_gen.txt"):
        # verbose=False writes no architecture dump, as in terrain_tpu
        assert (out / name).exists() == (name != "arch_dcgan_gen.txt"), name
    models = runs["root"] / "torch" / "models"
    assert sorted(os.listdir(models)) == ["1.model", "2.model"]


def test_port_resumes_a_jax_checkpoint(runs, tmp_path):
    """terrain_tpu's 1.model (weights, rmsprop state, RNG streams) resumed
    by the port: its second epoch is terrain_tpu's second epoch."""
    gan, _ = experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                   da=False, seed=3)
    np.random.seed(999)
    gan.train(*_data(DeviceDataset, device="cpu"), BS, 1,
              str(tmp_path / "out"), None,
              resume=str(runs["root"] / "jax" / "models" / "1.model"))
    _assert_rows_close(_resumed_row(runs, tmp_path / "out"),
                       runs["jrows"][1])
    assert gan.lr == pytest.approx(1e-4)


def test_jax_resumes_a_port_checkpoint(runs, tmp_path):
    jgan = runs["jgan"]  # its compiled steps are reused
    np.random.seed(999)
    jgan.train(*_data(JDeviceDataset), BS, 1, str(tmp_path / "out"), None,
               resume=str(runs["root"] / "torch" / "models" / "1.model"))
    _assert_rows_close(_resumed_row(runs, tmp_path / "out"),
                       runs["trows"][1])
    # the optimizer state arrived in terrain_tpu's tree layout
    want = jax.tree.structure(jgan.optimizer.init(jgan.params["p2p_gen"]))
    assert jax.tree.structure(jgan.opt_states["p2p_gen"]) == want


def test_load_model_stage_and_optimizer_reinit(runs):
    gan, _ = experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                   seed=5)
    before = _weights(gan)
    path = str(runs["root"] / "torch" / "models" / "2.model")
    gan.load_model(path, mode="p2p")
    after, trained = _weights(gan), _weights(runs["tgan"])
    for n in ("dcgan_gen", "dcgan_disc"):
        assert all(torch.equal(x, y) for x, y in zip(after[n], before[n]))
    for n in ("p2p_gen", "p2p_disc"):
        assert all(torch.equal(x, y) for x, y in zip(after[n], trained[n]))
    assert all(float(a.abs().max()) == 0.0
               for a in gan.opt_states["p2p_gen"]["accu"])
    assert gan._step_counter == 0

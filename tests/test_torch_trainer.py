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
"""

import os

import jax
import numpy as np
import pytest
import torch

from terrain_tpu import experiments as jexp
from terrain_tpu.data import DeviceDataset as JDeviceDataset
from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.train.trainer import TwoStageGAN as JTwoStageGAN
from terrain_tpu_torch import cli, experiments
from terrain_tpu_torch.data import DeviceDataset
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.models import convert
from terrain_tpu_torch.ops.kernels import pool2
from tiny_cfg import csv_rows

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


def test_exact_resume_is_bit_equal(runs, tmp_path):
    """1 epoch + a resumed 2nd epoch == 2 epochs: every weight and BN
    statistic bit-equal, and the same results row."""
    data = _data(DeviceDataset, device="cpu")
    full = _torch_gan(runs["weights"])
    rows_full = _train(full, data, tmp_path / "full", 2)
    first = _torch_gan(runs["weights"])
    _train(first, _data(DeviceDataset, device="cpu"), tmp_path / "split", 1)
    np.random.seed(12345)  # the resume must restore the stream itself
    second = _torch_gan(runs["weights"])
    second.train(*_data(DeviceDataset, device="cpu"), BS, 2,
                 str(tmp_path / "split" / "out"),
                 str(tmp_path / "split" / "models"), save_every=1,
                 resume="auto")
    rows_split = csv_rows(str(tmp_path / "split" / "out" / "results.txt"))
    assert [r["epoch"] for r in rows_split] == ["1", "2"]
    for col in LOSS_COLS:
        assert rows_split[1][col] == rows_full[1][col], col
    a, b = _weights(full), _weights(second)
    for n in a:
        for x, y in zip(a[n], b[n], strict=True):
            assert torch.equal(x, y), n
    for n in full.opt_states:
        for x, y in zip(full.opt_states[n]["accu"],
                        second.opt_states[n]["accu"], strict=True):
            assert torch.equal(x, y), n
    assert second._step_counter == full._step_counter


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


@pytest.mark.parametrize("pick", [None, "name", "5", "swd"])
def test_resolve_model_picks_what_terrain_tpu_picks(pick, tmp_path,
                                                    monkeypatch, capsys):
    models, out = tmp_path / "models", tmp_path / "out"
    models.mkdir()
    out.mkdir()
    for e in (1, 5, 10, 600):
        (models / f"{e}.model").write_bytes(b"")
    (out / "swd.txt").write_text(
        "epoch,swd_mean,p2p_swd_mean\n1,0.9,0.5\n4,0.2,0.1\n9,0.3,0.05\n"
        "9,0.25\n600,0.8,0.9\n")
    if pick is None:
        monkeypatch.delenv("TERRAIN_PICK", raising=False)
    else:
        monkeypatch.setenv("TERRAIN_PICK", pick)
    for kw in (dict(), dict(preferred="10.model"),
               dict(preferred="600.model", out_dir=str(out)),
               dict(preferred="7.model", out_dir=str(out), metric="both"),
               dict(out_dir=str(out), metric="p2p_swd_mean")):
        got = experiments._resolve_model(str(models), **kw)
        assert got == jexp._resolve_model(str(models), **kw), kw
    capsys.readouterr()


def test_resolve_model_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("TERRAIN_PICK", "3")
    (tmp_path / "2.model").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="saved epochs: 2"):
        experiments._resolve_model(str(tmp_path))
    monkeypatch.setenv("TERRAIN_PICK", "name")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        experiments._resolve_model(str(tmp_path / "nothing"))


def test_cli_train_gen_interp_and_serve_pick(tmp_path, monkeypatch, capsys):
    """`python -m terrain_tpu_torch smoke_synthetic <mode> --device cpu`
    end to end, then the serve CLI resolving its checkpoint the same way."""
    monkeypatch.setenv("TERRAIN_OUT", str(tmp_path / "out"))
    monkeypatch.setenv("TERRAIN_MODELS", str(tmp_path / "models"))
    monkeypatch.setenv("TERRAIN_SAVE_EVERY", "1")
    for k in ("TERRAIN_SYNTHETIC", "TERRAIN_N", "TERRAIN_EPOCHS",
              "TERRAIN_PICK", "TERRAIN_RESUME", "TERRAIN_FAST"):
        monkeypatch.delenv(k, raising=False)
    assert cli.main(["smoke_synthetic", "train", "--device", "cpu"]) == 0
    out = tmp_path / "out" / "smoke_synthetic"
    rows = csv_rows(str(out / "results.txt"))
    assert len(rows) == 2
    assert all(np.isfinite(float(r[c])) for r in rows for c in LOSS_COLS)
    assert (out / "arch_p2p_disc.txt").read_text().count("\n") > 10
    assert sorted(os.listdir(tmp_path / "models" / "smoke_synthetic")) == [
        "1.model", "2.model"]
    assert cli.main(["smoke_synthetic", "gen", "--device", "cpu"]) == 0
    assert len(os.listdir(out / "gen")) == 8
    assert cli.main(["smoke_synthetic", "interp", "--device", "cpu"]) == 0
    assert len(os.listdir(out / "interp_clip")) == 48
    with pytest.raises(SystemExit):
        cli.main(["no_such_experiment", "train"])
    capsys.readouterr()

    from terrain_tpu_torch import serve
    from terrain_tpu_torch.serve import __main__ as serve_main

    class FakeServer:
        host, port = "127.0.0.1", 0

        def __init__(self, model, *a, **kw):
            self.model = model

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    monkeypatch.setattr(serve, "TerrainServer", FakeServer)
    for pick, want in (("1", "1.model"), ("swd", "2.model")):
        monkeypatch.setenv("TERRAIN_PICK", pick)
        assert serve_main.main(["smoke_synthetic", "--device", "cpu"]) == 0
        assert f"{os.sep}{want}" in capsys.readouterr().out


def test_python_dash_m_entry_point():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "terrain_tpu_torch", "nope",
                        "train"], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2
    assert "usage: python -m terrain_tpu_torch" in r.stderr
    assert "test1_nobn_bilin_both" in r.stderr


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("TERRAIN_OUT", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["smoke_synthetic", "train"])


@pytest.mark.parametrize("env,match", [
    ({"TERRAIN_SWD": "1"}, "eval"),
    ({"TERRAIN_PROFILE": "/x"}, "TERRAIN_PROFILE"),
    ({"TERRAIN_AOT": "/x"}, "TERRAIN_AOT"),
    ({"TERRAIN_CHECK_NANS": "2"}, "TERRAIN_CHECK_NANS"),
    ({"TERRAIN_RASTER": "a.png,b.jpg"}, "TERRAIN_RASTER"),
])
def test_unported_switches_raise(env, match, monkeypatch, tmp_path):
    monkeypatch.setenv("TERRAIN_OUT", str(tmp_path / "out"))
    monkeypatch.setenv("TERRAIN_MODELS", str(tmp_path / "models"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        experiments.run("smoke_synthetic", "train", "cpu")
    assert not (tmp_path / "out" / "smoke_synthetic" / "results.txt").exists()


def test_mesh_raises_and_nans_stop_the_run(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="parallel"):
        experiments.TwoStageGAN(
            None, None, None, None, None, None, None, None, 64, 32, True,
            False, mesh=object(), device="cpu")
    gan, _ = experiments.build_gan("smoke_synthetic", "cpu", verbose=False)
    with torch.no_grad():
        next(gan.nets["p2p_gen"].parameters()).fill_(float("nan"))
    monkeypatch.setenv("TERRAIN_CHECK_NANS", "1")
    with pytest.raises(FloatingPointError, match="p2p_recon"):
        gan.train(*_data(DeviceDataset, device="cpu"), BS, 1, str(tmp_path),
                  quick_run=True)


def test_host_iterators_scan_and_eval_cap(monkeypatch, tmp_path):
    """The host-iterator path, TERRAIN_SCAN chunks and TERRAIN_EVAL_STEPS:
    the scan chunking changes no number; the cap marks results.txt."""
    from terrain_tpu_torch.data import Hdf5Iterator

    def run(sub, scan):
        monkeypatch.setenv("TERRAIN_SCAN", scan)
        gan, _ = experiments.build_gan("smoke_synthetic", "cpu",
                                       verbose=False, da=True, seed=1)
        np.random.seed(4)
        gan.train(*_data(DeviceDataset, device="cpu"), BS, 1,
                  str(tmp_path / sub))
        return csv_rows(str(tmp_path / sub / "results.txt"))[0]

    a, b = run("scan1", "1"), run("scan4", "3")
    assert [a[c] for c in LOSS_COLS] == [b[c] for c in LOSS_COLS]
    assert experiments.TwoStageGAN._scan_k(4) == 2  # 3 does not divide 4
    monkeypatch.setenv("TERRAIN_EVAL_STEPS", "1")
    gan, _ = experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                   seed=1)
    its = tuple(Hdf5Iterator(*make_pairs(n, SIZE, seed=s), BS)
                for n, s in ((8, 0), (8, 1)))
    gan.train(*its, BS, 1, str(tmp_path / "host"))
    text = (tmp_path / "host" / "results.txt").read_text()
    assert "# TERRAIN_EVAL_STEPS=1" in text
    assert len(csv_rows(str(tmp_path / "host" / "results.txt"))) == 1

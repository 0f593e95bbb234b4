"""terrain_tpu_torch's trainer and CLI on the CPU, the tests that need no
JAX trainer (tests/test_torch_trainer.py holds those against terrain_tpu's
trainer, in a file of their own, so that the two heavy files run on
different pytest-xdist workers): exact resume, checkpoint choice against
terrain_tpu's `_resolve_model`, the CLI's train/gen/interp and the serve
CLI, the switches that still raise, the NaN stop, and the host-iterator
path with TERRAIN_SCAN and TERRAIN_EVAL_STEPS; smoke_synthetic (64px),
fp32.
"""

import os

import numpy as np
import pytest
import torch

from terrain_tpu import experiments as jexp
from terrain_tpu_torch import cli, experiments
from terrain_tpu_torch.data import DeviceDataset
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.train.losses import TRAIN_KEYS
from tiny_cfg import csv_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS, N, SIZE = 4, 16, 64
LOSS_COLS = [f"{s}_{k}" for s in ("train", "valid") for k in TRAIN_KEYS]


@pytest.fixture(autouse=True)
def _restore_environ():
    """`experiments.run` sets an experiment's environment defaults with
    `os.environ.setdefault`, as terrain_tpu does; keep them out of the tests
    that follow in this process."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _torch_gan():
    return experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                 da=False)[0]


def _data(cls, **kw):
    return (cls(*make_pairs(N, SIZE, seed=0), **kw),
            cls(*make_pairs(4, SIZE, seed=1), **kw))


def _train(gan, data, root, epochs, **kw):
    np.random.seed(0)
    gan.train(*data, BS, epochs, str(root / "out"), str(root / "models"),
              save_every=1, **kw)
    return csv_rows(str(root / "out" / "results.txt"))


def _weights(gan):
    return {n: [p.detach().clone() for p in net.parameters()]
            + [b.detach().clone() for b in net.buffers()]
            for n, net in gan.nets.items()}


def test_exact_resume_is_bit_equal(tmp_path):
    """1 epoch + a resumed 2nd epoch == 2 epochs: every weight and BN
    statistic bit-equal, and the same results row.  The three trainers start
    from the same weights (the same seed)."""
    data = _data(DeviceDataset, device="cpu")
    full = _torch_gan()
    rows_full = _train(full, data, tmp_path / "full", 2)
    first = _torch_gan()
    _train(first, _data(DeviceDataset, device="cpu"), tmp_path / "split", 1)
    np.random.seed(12345)  # the resume must restore the stream itself
    second = _torch_gan()
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
    ({"TERRAIN_AOT": "/x"}, "TERRAIN_AOT"),
    ({"TERRAIN_CHECK_NANS": "2"}, "TERRAIN_CHECK_NANS"),
    ({"TERRAIN_RASTER": "a.png,b.jpg"}, "TERRAIN_RASTER: b.jpg is JPEG"),
    ({"TERRAIN_AOT_KEY": "jaxpr"}, "TERRAIN_AOT_KEY"),
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
    # a data-parallel mesh trains (tests/test_torch_parallel.py); one with
    # a 'model' axis is the next slice and raises
    from terrain_tpu_torch.parallel import make_mesh

    with pytest.raises(NotImplementedError, match="A.5b"):
        experiments.TwoStageGAN(
            None, None, None, None, None, None, None, None, 64, 32, True,
            False, mesh=make_mesh(n_data=1, n_model=2, ranks=range(2)),
            device="cpu")
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

"""terrain_tpu_torch's quality path against terrain_tpu's on the CPU, fp32:
the Gaussian blur, the SWD pyramid and the terrain W1 metrics piece by
piece, the trainer's per-epoch swd.txt (TERRAIN_SWD=1) and the checkpoint
that `gen` picks from it, the host-iterator prefetcher, and the trace of
TERRAIN_PROFILE.

The port cannot draw threefry's numbers, so where values are compared its
one draw function per metric (`swd_draws`, `terrain_draws`) is replaced
with terrain_tpu's draws for the same seed.  Tolerances: 1e-5 absolute on
images and descriptors of unit scale (fp32 resampling sums in another
order), 1e-4 relative on the metrics (means of sorted differences, fp32);
the trainer's swd.txt 1e-3 relative (two epochs of training in each
package first, whose losses agree to 2e-4, tests/test_torch_trainer.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu import experiments as jexp
from terrain_tpu.data import DeviceDataset as JDeviceDataset
from terrain_tpu.eval import swd as jswd
from terrain_tpu.eval import terrain as jterrain
from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import unet as junet
from terrain_tpu.ops.blur import gaussian_blur as jblur
from terrain_tpu.train.trainer import TwoStageGAN as JTwoStageGAN
from terrain_tpu_torch import experiments
from terrain_tpu_torch.data import DeviceDataset, Hdf5Iterator
from terrain_tpu_torch.data.prefetch import Prefetcher
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.eval import swd, terrain
from terrain_tpu_torch.models import convert, dcgan, unet
from terrain_tpu_torch.ops.blur import gaussian_blur
from terrain_tpu_torch.train.trainer import TwoStageGAN
from terrain_tpu_torch.utils.profiling import StepTimer
from tiny_cfg import csv_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=0, atol=1e-5)
IN, LAT, BS = 16, 8, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_swd_draws(seed, level_shapes, patch, n_per_img, n_proj):
    """terrain_tpu's draws (eval/swd.py `_swd_all_levels`,
    `extract_patches`, `sliced_wasserstein`) in swd_draws' form."""
    key = jax.random.PRNGKey(seed)
    out = []
    for n, h, w, c in level_shapes:
        k1, k2, key = jax.random.split(key, 3)
        ky, kx = jax.random.split(k1)
        ys = jax.random.randint(ky, (n, n_per_img), 0, h - patch + 1)
        xs = jax.random.randint(kx, (n, n_per_img), 0, w - patch + 1)
        proj = jax.random.normal(k2, (patch * patch * c, n_proj))
        out.append((_t(ys).long(), _t(xs).long(), _t(proj)))
    return out


def jax_terrain_draws(seed, n_elev, n_slope, n_sample):
    """terrain_tpu's draws (eval/terrain.py `_terrain_w1`)."""
    ke, ks = jax.random.split(jax.random.PRNGKey(seed))
    return (_t(jax.random.randint(ke, (n_sample,), 0, n_elev)).long(),
            _t(jax.random.randint(ks, (n_sample,), 0, n_slope)).long())


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(swd, "swd_draws", jax_swd_draws)
    monkeypatch.setattr(terrain, "terrain_draws", jax_terrain_draws)


def _pair(rng, shape):
    """A smooth real set and a noisier fake one."""
    real = rng.rand(*shape).astype(np.float32)
    real = np.asarray(jblur(jnp.asarray(real), sigma=1.5))
    fake = (real + 0.1 * rng.randn(*shape)).astype(np.float32)
    return real, fake


# ------------------------------------------------------------- pieces
@pytest.mark.parametrize("shape,sigma,ksize", [
    ((2, 16, 20, 1), 1.0, 5), ((1, 13, 9, 3), 2.0, None),
    ((1, 8, 8, 2), 0.5, 3)])
def test_gaussian_blur_matches_jax(shape, sigma, ksize, rng):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jblur(jnp.asarray(x), sigma=sigma, ksize=ksize))
    got = gaussian_blur(torch.from_numpy(x), sigma=sigma, ksize=ksize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (1, 32, 48, 3)])
def test_laplacian_pyramid_matches_jax(shape, rng):
    x = rng.rand(*shape).astype(np.float32)
    want = jswd.laplacian_pyramid(jnp.asarray(x), 3)
    got = swd.laplacian_pyramid(torch.from_numpy(x), 3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_extract_patches_and_sliced_wasserstein_match_jax(rng):
    real, fake = _pair(rng, (3, 24, 20, 2))
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    # the draws of extract_patches(key=k1) and sliced_wasserstein(key=k2)
    ky, kx = jax.random.split(k1)
    ys = _t(jax.random.randint(ky, (3, 16), 0, 24 - 7 + 1)).long()
    xs = _t(jax.random.randint(kx, (3, 16), 0, 20 - 7 + 1)).long()
    proj = _t(jax.random.normal(k2, (7 * 7 * 2, 32)))
    pr = swd.extract_patches(torch.from_numpy(real), ys, xs, 7)
    pf = swd.extract_patches(torch.from_numpy(fake), ys, xs, 7)
    jr = jswd.extract_patches(jnp.asarray(real), k1, 7, 16)
    jf = jswd.extract_patches(jnp.asarray(fake), k1, 7, 16)
    assert tuple(pr.shape) == (48, 98)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)
    want = float(jswd.sliced_wasserstein(jr, jf, k2, 32))
    got = float(swd.sliced_wasserstein(pr, pf, proj))
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("shape,levels", [((4, 64, 64, 1), 3),
                                          ((2, 32, 32, 3), 2)])
def test_swd_pyramid_matches_jax(shape, levels, rng, jax_draws):
    real, fake = _pair(rng, shape)
    want = jswd.swd_pyramid(real, fake, seed=3, n_levels=levels)
    got = swd.swd_pyramid(torch.from_numpy(real), torch.from_numpy(fake),
                          seed=3, n_levels=levels)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_terrain_stats_match_jax(rng, jax_draws):
    real, fake = _pair(rng, (3, 32, 40, 1))
    want = jterrain.terrain_stats(real, fake, seed=2, n_sample=4096)
    got = terrain.terrain_stats(torch.from_numpy(real),
                                torch.from_numpy(fake), seed=2,
                                n_sample=4096)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_identical_sets_score_zero_and_shapes_must_agree(rng):
    x = torch.from_numpy(rng.rand(4, 32, 32, 1).astype(np.float32))
    assert swd.swd_pyramid(x, x, n_levels=2)["swd_mean"] < 1e-5
    assert max(terrain.terrain_stats(x, x, n_sample=2048).values()) < 1e-5
    with pytest.raises(ValueError, match="differ"):
        swd.swd_pyramid(x, x[:2])
    # the port's draws are its own, the same on every call
    assert swd.swd_pyramid(x, x.flip(1), seed=1, n_levels=2) == \
        swd.swd_pyramid(x, x.flip(1), seed=1, n_levels=2)


# ------------------------------------------------------------ trainer
def _jax_gan(train_mode="both"):
    """The smallest two-stage config (tests/test_trainer.py tiny_model),
    augmentation off."""
    return JTwoStageGAN(
        gen_fn_dcgan=jdcgan.default_generator,
        disc_fn_dcgan=jdcgan.default_discriminator,
        gen_params_dcgan=dict(GEN), disc_params_dcgan=dict(DISC),
        gen_fn_p2p=junet.g_unet, disc_fn_p2p=junet.discriminator,
        gen_params_p2p=dict(P2P), disc_params_p2p=dict(P2P_DISC),
        in_shp=IN, latent_dim=LAT, is_a_grayscale=True, is_b_grayscale=False,
        lsgan=True, opt="rmsprop", opt_args={"learning_rate": 1e-4},
        train_mode=train_mode, verbose=False, da=False)


GEN = {"nch": 8, "h": 3, "initial_size": 4, "final_size": IN, "div": [2, 2]}
DISC = {"nch": IN, "h": 3, "div": [4, 2], "bn": False,
        "nonlinearity": "linear"}
P2P = {"nf": 4, "act": "tanh"}
P2P_DISC = {"nf": 4, "bn": False, "act": "linear"}


def _torch_gan(weights):
    gan = TwoStageGAN(
        dcgan.default_generator, dcgan.default_discriminator, dict(GEN),
        dict(DISC), unet.g_unet, unet.discriminator, dict(P2P),
        dict(P2P_DISC), in_shp=IN, latent_dim=LAT, is_a_grayscale=True,
        is_b_grayscale=False, lsgan=True, opt="rmsprop",
        opt_args={"learning_rate": 1e-4}, verbose=False, da=False,
        device="cpu")
    for n, (p, s) in weights.items():
        convert.load_jax(gan.nets[n], p, s)
    return gan


def _sets(cls, **kw):
    return (cls(*make_pairs(8, IN, seed=0), **kw),
            cls(*make_pairs(4, IN, seed=1), **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs with TERRAIN_SWD=1 in both trainers from the same weights
    and seeds (device-resident sets, checkpoints every epoch); the port with
    terrain_tpu's draws."""
    root = tmp_path_factory.mktemp("swd")
    mp = pytest.MonkeyPatch()
    mp.setenv("TERRAIN_SWD", "1")
    for k in ("TERRAIN_TERRAIN_METRICS", "TERRAIN_PICK", "TERRAIN_PROFILE"):
        mp.delenv(k, raising=False)
    try:
        jgan = _jax_gan()
        weights = {n: (jax.tree.map(np.asarray, jgan.params[n]),
                       jax.tree.map(np.asarray, jgan.states[n]))
                   for n in jgan.nets}
        np.random.seed(0)
        jgan.train(*_sets(JDeviceDataset), BS, 2, str(root / "jax" / "out"),
                   str(root / "jax" / "models"), save_every=1)
        mp.setattr(swd, "swd_draws", jax_swd_draws)
        mp.setattr(terrain, "terrain_draws", jax_terrain_draws)
        tgan = _torch_gan(weights)
        np.random.seed(0)
        tgan.train(*_sets(DeviceDataset, device="cpu"), BS, 2,
                   str(root / "torch" / "out"),
                   str(root / "torch" / "models"), save_every=1)
    finally:
        mp.undo()
    return dict(root=root, jgan=jgan, tgan=tgan, weights=weights)


def _swd_file(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
    return header, csv_rows(str(path))


def test_swd_txt_matches_the_jax_trainer(runs):
    jh, jrows = _swd_file(runs["root"] / "jax" / "out" / "swd.txt")
    th, trows = _swd_file(runs["root"] / "torch" / "out" / "swd.txt")
    assert th == jh
    assert "elev_w1" in th and "p2p_swd_mean" in th and "swd_level1" in th
    assert [r["epoch"] for r in trows] == [r["epoch"] for r in jrows] == [
        "1", "2"]
    for got, want in zip(trows, jrows, strict=True):
        for k in jh[1:]:
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                   rel=1e-3), k


def test_resume_appends_under_the_files_columns(runs, tmp_path,
                                                monkeypatch):
    """A resumed run keeps swd.txt's header, even when the metrics it asks
    for are fewer (TERRAIN_TERRAIN_METRICS=0: those columns read nan)."""
    out = tmp_path / "out"
    out.mkdir()
    src = runs["root"] / "torch" / "out" / "swd.txt"
    (out / "swd.txt").write_text(src.read_text())
    monkeypatch.setenv("TERRAIN_SWD", "1")
    monkeypatch.setenv("TERRAIN_TERRAIN_METRICS", "0")
    gan = _torch_gan(runs["weights"])
    gan.train(*_sets(DeviceDataset, device="cpu"), BS, 3, str(out),
              str(runs["root"] / "torch" / "models"), save_every=10,
              resume="auto")
    header, rows = _swd_file(out / "swd.txt")
    assert header == _swd_file(src)[0]
    assert [r["epoch"] for r in rows] == ["1", "2", "3"]
    assert np.isnan(float(rows[2]["elev_w1"]))
    assert np.isfinite(float(rows[2]["swd_mean"]))


@pytest.mark.parametrize("train_mode,metrics", [
    ("both", "0"), ("p2p", "1"), ("dcgan", "1")])
def test_columns_follow_train_mode_as_in_jax(runs, train_mode, metrics,
                                             tmp_path, monkeypatch):
    monkeypatch.setenv("TERRAIN_TERRAIN_METRICS", metrics)
    headers = []
    for gan, sets, sub in (
            (runs["jgan"], _sets(JDeviceDataset), "jax"),
            (runs["tgan"], _sets(DeviceDataset, device="cpu"), "torch")):
        out = tmp_path / sub
        out.mkdir()
        mode, gan.train_mode = gan.train_mode, train_mode
        try:
            gan._log_swd(sets[1], str(out), 1, BS)
        finally:
            gan.train_mode = mode
        headers.append(_swd_file(out / "swd.txt")[0])
    assert headers[0] == headers[1]
    assert ("elev_w1" in headers[1]) == (metrics == "1"
                                         and train_mode != "p2p")


@pytest.mark.parametrize("metric", ["swd_mean", "p2p_swd_mean", "both"])
def test_gen_picks_the_same_epoch_as_jax(runs, metric, monkeypatch, capsys):
    monkeypatch.setenv("TERRAIN_PICK", "swd")
    models = str(runs["root"] / "torch" / "models")
    out = str(runs["root"] / "torch" / "out")
    got = experiments._resolve_model(models, "600.model", out_dir=out,
                                     metric=metric)
    assert got == jexp._resolve_model(models, "600.model", out_dir=out,
                                      metric=metric)
    assert "[pick]" in capsys.readouterr().out


# ---------------------------------------------------------- prefetch
class _Finite:
    N = 3

    def __init__(self, fail_at=None):
        self.i, self.fail_at = 0, fail_at

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == self.fail_at:
            raise KeyError("bad batch")
        if self.i == self.N:
            raise StopIteration
        self.i += 1
        return (np.full((2, 3), self.i, np.float32),)


def test_prefetcher_ends_cleanly_and_keeps_n():
    p = Prefetcher(_Finite(), size=2, device="cpu")
    try:
        assert p.N == 3
        got = [int(t[0][0, 0]) for t in p]
        assert got == [1, 2, 3]
        assert all(isinstance(t, torch.Tensor) for t in next(iter(
            Prefetcher(_Finite(), device="cpu"))))
        with pytest.raises(StopIteration):
            next(p)
    finally:
        p.close()


def test_prefetcher_raises_the_workers_error():
    p = Prefetcher(_Finite(fail_at=2), device="cpu")
    try:
        assert int(next(p)[0][0, 0]) == 1
        assert int(next(p)[0][0, 0]) == 2
        with pytest.raises(KeyError, match="bad batch"):
            next(p)
    finally:
        p.close()


def test_prefetcher_close_ends_a_blocked_worker():
    def forever():
        while True:
            yield (np.zeros(4, np.float32),)

    p = Prefetcher(forever(), size=1, device="cpu")
    next(p)
    p.close()  # the worker was blocked on a full queue
    assert not p._thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)


def test_results_equal_with_and_without_prefetch(runs, tmp_path,
                                                 monkeypatch):
    """Host iterators behind the prefetcher or read in the step loop: the
    same batches in the same order, so the same results.txt losses."""
    monkeypatch.delenv("TERRAIN_SWD", raising=False)
    rows = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("TERRAIN_PREFETCH", flag)
        gan = _torch_gan(runs["weights"])
        np.random.seed(1)
        gan.train(*_sets(Hdf5Iterator, bs=BS), BS, 2,
                  str(tmp_path / flag), None)
        rows[flag] = [{k: v for k, v in r.items() if k != "time"}
                      for r in csv_rows(str(tmp_path / flag / "results.txt"))]
    assert rows["1"] == rows["0"] and len(rows["1"]) == 2


def test_profile_writes_a_trace_of_the_second_epoch(runs, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("TERRAIN_PROFILE", str(tmp_path / "trace"))
    monkeypatch.delenv("TERRAIN_SWD", raising=False)
    gan = _torch_gan(runs["weights"])
    gan.train(*_sets(DeviceDataset, device="cpu"), BS, 1, str(tmp_path / "a"))
    assert not (tmp_path / "trace").exists()  # one epoch: nothing traced
    gan.train(*_sets(DeviceDataset, device="cpu"), BS, 2, str(tmp_path / "b"))
    (trace,) = os.listdir(tmp_path / "trace")
    text = (tmp_path / "trace" / trace).read_text()
    assert trace.endswith(".json") and '"traceEvents"' in text
    assert "aten::" in text


def test_step_timer_counts_steps_per_second():
    t = StepTimer()
    t.start()
    t.tick(3)
    t.tick()
    rate = t.stop(fence=torch.zeros(1))  # a CPU tensor: nothing to fence
    assert t.steps == 4 and rate > 0

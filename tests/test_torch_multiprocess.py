"""terrain_tpu_torch's data parallelism across two real processes on the
CPU: two gloo ranks, spawned (torch.multiprocessing), joined through a
file:// rendezvous in the test's temporary directory; each runs
tests/torch_mp_worker.py's `run_rank`.

  * one data-parallel train step at global batch 4 (2 rows a rank) against
    the port's single-process step at batch 4, with the paired
    augmentation (whose draws each rank makes for the global batch) and
    without it, and against terrain_tpu's single-device step on the same
    weights (carried across by models/convert) and inputs: losses and
    parameters at tests/test_parallel.py's tolerances (rtol 2e-4, atol
    2e-5); the two ranks' parameters must be equal;
  * the synced BatchNorm's forward and input gradient against terrain_tpu's
    batch_norm over the global batch (rtol 1e-5, atol 1e-6: fp32 sums in
    another order);
  * 2 epochs of TwoStageGAN.train over HostShardIterator shards whose
    results.txt loss columns equal the single-process run's, at
    tests/test_multiprocess.py's rtol 1e-5, atol 1e-6, and 2 epochs over a
    dataset held on each rank's device with the paired augmentation, at
    the same tolerance;
  * those epochs over the dataset on the device at TERRAIN_SCAN=2, with
    the augmentation and without it: equal to the same ranks' per-step
    epochs bit for bit, a loop over gloo (train/step.py's rule), and
    without it against terrain_tpu's scanned single-device epochs on the
    global batch from the same weights, at tests/test_torch_scan.py's
    2e-4 relative on every loss column (fp32 sums in another order);
    train/step._on_any_rank raised on one rank reaches both;
  * `python -m terrain_tpu_torch smoke_synthetic train` (cli.main) in each
    rank: equal loss rows and checkpoints on both ranks;
  * entry.dryrun_multichip(2).
tests/test_torch_tp.py runs tensor parallelism on 'model'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.ops.norm import batch_norm as jbatch_norm
from terrain_tpu.train import optim as joptim
from terrain_tpu.train import step as jstep
from terrain_tpu_torch import entry
from terrain_tpu_torch.train.trainer import TwoStageGAN
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tiny_cfg import GlobalStream, csv_rows, det_sampler
import torch_mp_worker as w
import torch_spawn

WORLD = 2
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
ROW_TOL = dict(rtol=1e-5, atol=1e-6)
SCAN_TOL = 2e-4  # tests/test_torch_scan.py's LOSS_TOL against terrain_tpu


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' saved results (tests/torch_spawn.py: a phase a rank
    did not finish fails the tests that read it) and their directory."""
    out = tmp_path_factory.mktemp("dp")
    failure = torch_spawn.spawn(w.run_rank, WORLD, str(out))
    return torch_spawn.Results(str(out), WORLD, failure), out


def test_every_rank_ran_to_its_end(ranks):
    assert ranks[0].failure is None


def _close(got, want, tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **tol), got, want)


def _held(dp, single, tol):
    (l0, p0), (l1, p1) = dp
    assert l0 == l1  # every rank records the global batch's losses
    jax.tree.map(np.testing.assert_array_equal, p0, p1)
    for k in single[0]:
        np.testing.assert_allclose(l0[k], single[0][k], err_msg=k, **tol)
    _close(p0, single[1], tol)


@pytest.mark.parametrize("key", ["step_da", "step_jax"])
def test_dp_step_matches_the_single_process_step(ranks, key):
    res, _ = ranks
    gan = TwoStageGAN(**w.nets_kw(), da=key == "step_da")
    single = w.one_step(gan, w.global_batch())
    _held([r[key] for r in res], single, STEP_TOL)


def _jax_nets():
    return {
        "dcgan_gen": jdcgan.default_generator(
            w.LAT, True, nch=8, h=3, initial_size=4, final_size=w.IN,
            div=[2, 2]),
        "dcgan_disc": jdcgan.default_discriminator(
            w.IN, True, nch=w.IN, h=3, div=[4, 2], bn=False,
            nonlinearity="linear"),
        "p2p_gen": jp2p.g_unet(w.IN, True, False, nf=4, act="tanh"),
        "p2p_disc": jp2p.discriminator(w.IN, True, False, nf=4, bn=False,
                                       act="linear"),
    }


def test_dp_step_matches_terrain_tpus_single_device_step(ranks):
    """The same weights carried into terrain_tpu's step (models/convert),
    the same global batch, no augmentation."""
    from terrain_tpu_torch.models import convert

    res, _ = ranks
    gan = TwoStageGAN(**w.nets_kw(), da=False)
    trees = {n: convert.to_jax(net) for n, net in gan.nets.items()}
    params = {n: t[0] for n, t in trees.items()}
    states = {n: t[1] for n, t in trees.items()}
    jnets = _jax_nets()
    opt = joptim.rmsprop()
    step = jax.jit(jstep.build_train_step(
        jnets, opt, alpha=100.0, lsgan=True, reconstruction="l1",
        train_mode="both"))
    p, _, _, losses = step(params, states,
                           {n: opt.init(params[n]) for n in jnets},
                           tuple(map(jnp.asarray, w.global_batch())),
                           jax.random.PRNGKey(0), jnp.float32(w.LR))
    single = ({k: float(v) for k, v in losses.items()},
              jax.tree.map(np.asarray, p))
    _held([r["step_jax"] for r in res], single, STEP_TOL)


def test_synced_batch_norm_is_terrain_tpus_over_the_global_batch(ranks):
    res, _ = ranks
    x, g, gamma, beta = w.bn_inputs()
    c = x.shape[-1]
    state = {"mean": jnp.zeros(c), "inv_std": jnp.ones(c)}

    def f(xx):
        return jbatch_norm(xx, {"gamma": gamma, "beta": beta}, state,
                           train=True)[0]

    y, vjp = jax.vjp(f, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np.concatenate([r["bn"][0] for r in res]),
                               np.asarray(y), **ROW_TOL)
    np.testing.assert_allclose(np.concatenate([r["bn"][1] for r in res]),
                               np.asarray(dx), **ROW_TOL)


def test_two_process_training_matches_single_process(ranks, tmp_path,
                                                     monkeypatch):
    """tests/test_multiprocess.py's trajectory test for the port: 2 epochs
    over HostShardIterator shards, the prior shards tiling one global
    draw (tiny_cfg.det_sampler)."""
    _, out = ranks
    monkeypatch.setenv("TERRAIN_ARTIFACT_EVERY", "999")
    gan = TwoStageGAN(**w.tiny_kw(det_sampler(0)))
    gan.train(GlobalStream(), GlobalStream(), batch_size=w.GLOBAL_BATCH,
              num_epochs=2, out_dir=str(tmp_path), save_every=999)
    _rows_match(csv_rows(os.path.join(tmp_path, "results.txt")), out, "w")


def _rows_match(ref, out, prefix):
    keys = [k for k in ref[0] if k.startswith(("train_", "valid_"))
            or k == "lr"]
    assert len(ref) == 2 and len(keys) == 11
    for r in range(WORLD):
        got = csv_rows(os.path.join(out, f"{prefix}{r}", "results.txt"))
        assert len(got) == 2
        for row_ref, row_got in zip(ref, got):
            for k in keys:
                np.testing.assert_allclose(
                    float(row_got[k]), float(row_ref[k]), **ROW_TOL,
                    err_msg=f"epoch {row_ref['epoch']} col {k} rank {r}")


def test_two_process_device_epochs_match_single_process(ranks, tmp_path,
                                                       monkeypatch):
    """The same over a dataset held on every rank's device, each gathering
    its rows of the global index batch, with the paired augmentation,
    whose draws each rank makes for the global batch."""
    _, out = ranks
    monkeypatch.setenv("TERRAIN_ARTIFACT_EVERY", "999")
    gan = TwoStageGAN(**w.tiny_kw(det_sampler(0), da=True))
    ds = w.device_pairs()
    gan.train(ds, ds, batch_size=w.GLOBAL_BATCH, num_epochs=2,
              out_dir=str(tmp_path), save_every=999)
    _rows_match(csv_rows(os.path.join(tmp_path, "results.txt")), out, "d")


def _loss_rows(out, name, r):
    return [{k: v for k, v in row.items()
             if k.startswith(("train_", "valid_"))}
            for row in csv_rows(os.path.join(out, f"{name}{r}",
                                             "results.txt"))]


@pytest.mark.parametrize("chunked,steps", [("d2", "d"), ("j2", "j1")])
def test_chunked_device_epochs_equal_the_ranks_per_step_epochs(
        ranks, chunked, steps):
    """TERRAIN_SCAN=2 under a data group: each pass one chunk of 2 steps
    on every rank (a loop over gloo), whose loss rows are the per-step
    epochs' to the bit, with the augmentation (d) and without (j)."""
    res, out = ranks
    for r in range(WORLD):
        scan = res[r]["scan"]
        assert scan["ks"] == [2]
        assert scan["backends"] == ["gloo"] and scan["graph"] is False
        got, want = _loss_rows(out, chunked, r), _loss_rows(out, steps, r)
        assert len(got) == 2 and got == want


def test_recapture_is_agreed_over_the_steps_groups(ranks):
    """A flag raised on the last rank alone reaches every rank, so no rank
    replays while another captures; none raised, none sees one."""
    res, _ = ranks
    assert [r["scan"]["any_last"] for r in res] == [True] * WORLD
    assert [r["scan"]["any_none"] for r in res] == [False] * WORLD


def test_chunked_device_epochs_match_terrain_tpus_scanned_epochs(
        ranks, tmp_path, monkeypatch):
    """The two ranks' TERRAIN_SCAN=2 epochs without augmentation against
    terrain_tpu's scanned epochs in one process on the global batch, from
    the port's weights (a terrain_tpu/v1 checkpoint), the same pairs and
    the same tiled prior (tiny_cfg.det_sampler)."""
    from terrain_tpu.data import DeviceDataset as JDeviceDataset
    from terrain_tpu_torch.data.synthetic import make_pairs
    from tiny_cfg import build_model

    _, out = ranks
    monkeypatch.setenv("TERRAIN_ARTIFACT_EVERY", "999")
    monkeypatch.setenv("TERRAIN_SCAN", "2")
    path = str(tmp_path / "w.model")
    TwoStageGAN(**w.tiny_kw(det_sampler(0))).save_model(path)
    jgan = build_model(None, det_sampler(0))
    jgan.load_model(path)
    ds = JDeviceDataset(*make_pairs(w.N_PAIRS, w.IN, seed=0))
    jgan.train(ds, ds, batch_size=w.GLOBAL_BATCH, num_epochs=2,
               out_dir=str(tmp_path / "jax"), save_every=999)
    want = [{k: v for k, v in row.items()
             if k.startswith(("train_", "valid_"))}
            for row in csv_rows(str(tmp_path / "jax" / "results.txt"))]
    assert len(want) == 2 and len(want[0]) == 10
    for r in range(WORLD):
        for got_row, want_row in zip(_loss_rows(out, "j2", r), want):
            for k, v in want_row.items():
                assert float(got_row[k]) == pytest.approx(
                    float(v), rel=SCAN_TOL), (r, k)


def test_the_cli_trains_data_parallel_under_a_process_group(ranks):
    """`python -m terrain_tpu_torch smoke_synthetic train` in each rank:
    the run is one data-parallel run, every rank recording the global
    batch's losses, and its checkpoints are the same on every rank."""
    _, out = ranks
    rows = [csv_rows(os.path.join(out, f"cli{r}", "smoke_synthetic",
                                  "results.txt")) for r in range(WORLD)]
    assert len(rows[0]) == 2
    for a, b in zip(*rows):
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    from terrain_tpu.train import checkpoint as jckpt

    saved = [jckpt.load_model(os.path.join(out, f"m{r}", "smoke_synthetic",
                                           "2.model"), {}, {})[0]
             for r in range(WORLD)]
    jax.tree.map(np.testing.assert_array_equal, *saved)


def test_dryrun_multichip_entrypoint():
    """Two ranks: terrain_tpu's rule takes n_model = 1 (2 at an even count
    of 4 or more, tests/test_torch_tp.py); a count that n_model does not
    divide raises."""
    entry.dryrun_multichip(WORLD)
    with pytest.raises(ValueError, match="divide"):
        entry.dryrun_multichip(3, n_model=2)

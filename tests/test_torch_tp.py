"""terrain_tpu_torch's tensor parallelism on 'model' across real processes
on the CPU: four gloo ranks, spawned once for the module
(torch.multiprocessing), joined through a file:// rendezvous in the test's
temporary directory; each runs tests/torch_tp_worker.py's `run_rank`.

  * each sharded layer call (parallel/tp.py: enter_sharded, the local op on
    half the output features, gather_features, the bias) against autograd
    of the unsharded op: output and the gradients of x, the weight (each
    rank's half of it) and the bias; `place` and `gather` on 'model';
  * on a 1x2 mesh, tests/test_parallel.py's tiny nets at tp_min_features
    8: one TP train step against terrain_tpu's replicated step on the same
    weights (models/convert) and batch, at tests/test_parallel.py's rtol
    2e-4, atol 2e-5, the two ranks' gathered parameters equal; the
    checkpoint it writes read by terrain_tpu and by a one-process port; an
    exact resume; a one-process checkpoint loaded onto the mesh; the
    samplers against one process's;
  * on a 2x2 mesh, 2 epochs over a dataset held on the device, with the
    paired augmentation: finite, and equal to one process's loss rows;
    at TERRAIN_SCAN=2 (chunks of 2, a loop over gloo) equal to the
    per-step epochs bit for bit, and a recapture flag raised on one rank
    reaches all four through the step's data then model group;
  * entry.dryrun_multichip(4) takes n_model = 2, as terrain_tpu's does.
The single-process conv layout rules (slice offsets on a mesh laid out
without a process group) are in tests/test_torch_parallel.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.train import checkpoint as jckpt
from terrain_tpu.train import optim as joptim
from terrain_tpu.train import step as jstep
from terrain_tpu_torch import entry
from terrain_tpu_torch.models import convert
from terrain_tpu_torch.train.trainer import TwoStageGAN
from test_torch_multiprocess import _jax_nets
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tiny_cfg import csv_rows, det_sampler
import torch_mp_worker as w
import torch_spawn
import torch_tp_worker as tw

WORLD = 4
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
ROW_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' saved results (tests/torch_spawn.py: a phase a rank
    did not finish fails the tests that read it) and their directory."""
    out = tmp_path_factory.mktemp("tp")
    failure = torch_spawn.spawn(tw.run_rank, WORLD, str(out))
    return torch_spawn.Results(str(out), WORLD, failure), out


def test_every_rank_ran_to_its_end(ranks):
    assert ranks[0].failure is None


def _equal_trees(a, b):
    jax.tree.map(np.testing.assert_array_equal, a, b)


def _close_trees(a, b, tol):
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        np.asarray(x), np.asarray(y), **tol), a, b)


@pytest.mark.parametrize("name", [o[0] for o in tw.OPS])
def test_sharded_call_matches_autograd_of_the_unsharded_op(ranks, name):
    res, _ = ranks
    fn, x, wt, b, cot, axis, kw = tw.op_inputs(name)
    x.requires_grad_()
    wt.requires_grad_()
    b.requires_grad_()
    y = fn(x, wt, b, **kw)
    want = [t.detach().numpy()
            for t in (y, *torch.autograd.grad(y, (x, wt, b), cot))]
    half = want[2].shape[axis] // 2
    for r in (0, 1):
        y_r, dx_r, dw_r, db_r = res[r]["ops"][name]
        np.testing.assert_allclose(y_r, want[0], **OP_TOL)
        np.testing.assert_allclose(dx_r, want[1], **OP_TOL)
        np.testing.assert_allclose(
            dw_r, np.take(want[2], range(r * half, (r + 1) * half), axis),
            **OP_TOL)
        np.testing.assert_allclose(db_r, want[3], **OP_TOL)


def test_place_keeps_the_slice_and_gather_inverts_it(ranks):
    res, _ = ranks
    full = np.arange(48, dtype=np.float32).reshape(2, 3, 8)
    for r in (0, 1):
        got = res[r]["ops"]
        np.testing.assert_array_equal(got["place"]["a"],
                                      full[..., 4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["place"]["b"], full[0])
        np.testing.assert_array_equal(got["gather"]["a"], full)
        np.testing.assert_array_equal(got["gather"]["b"], full[0])


def test_tp_shards_the_wide_layers_of_every_network(ranks):
    res, _ = ranks
    for r in range(WORLD):
        sharded = res[r]["grid_sharded"]
        assert sharded == res[0]["grid_sharded"]
        assert all(sharded[n] for n in sharded), sharded
    assert res[0]["tp"]["sharded"] == res[0]["grid_sharded"]
    assert "stages.1.0.conv" in res[0]["tp"]["sharded"]["dcgan_disc"]
    # the slices' shapes: half the output features of a sharded weight
    slices = res[0]["tp"]["slices"]
    gan = TwoStageGAN(**w.nets_kw())
    for n, net in gan.nets.items():
        halved = {f"{k}.w" for k in res[0]["tp"]["sharded"][n]}
        for (pname, p), got in zip(net.named_parameters(), slices[n]):
            want = list(p.shape)
            if pname in halved:
                want[1 if "deconv" in pname else 0] //= 2
            assert tuple(want) == got, pname


def test_tp_step_matches_terrain_tpus_replicated_step(ranks):
    """tests/test_parallel.py's test_tp_conv_shard_matches_replicated for
    the port: the same weights carried into terrain_tpu's step."""
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
    (l0, p0), (l1, p1) = (res[r]["tp"]["step1"] for r in (0, 1))
    assert l0 == l1
    _equal_trees(p0, p1)
    for k, v in losses.items():
        np.testing.assert_allclose(l0[k], float(v), err_msg=k, **STEP_TOL)
    _close_trees(p0, jax.tree.map(np.asarray, p), STEP_TOL)


def test_tp_checkpoint_loads_in_terrain_tpu_and_in_one_process(ranks):
    res, out = ranks
    want = res[0]["tp"]["step1"][1]
    for r in (0, 1):
        path = str(out / f"tp{r}.model")
        jparams = jckpt.load_model(path, {}, {})[0]
        _equal_trees({n: jparams[n] for n in want}, want)
        one = TwoStageGAN(**w.nets_kw())
        one.load_model(path, exact=True)
        _equal_trees({n: convert.to_jax(net)[0]
                      for n, net in one.nets.items()}, want)


def test_tp_resume_is_exact(ranks):
    res, _ = ranks
    for r in (0, 1):
        tp = res[r]["tp"]
        assert tp["step2_resumed"][0] == tp["step2"][0]
        _equal_trees(tp["step2_resumed"][1], tp["step2"][1])


def test_a_one_process_checkpoint_loads_onto_the_mesh(ranks):
    res, out = ranks
    saved = jckpt.load_model(str(out / "one.model"), {}, {})[0]
    for r in (0, 1):
        _equal_trees(res[r]["tp"]["full"], {n: saved[n] for n in saved})
        back = jckpt.load_model(str(out / f"back{r}.model"), {}, {})
        _equal_trees(back[0], saved)


def test_tp_samplers_match_one_process(ranks):
    res, out = ranks
    one = TwoStageGAN(**w.nets_kw(), da=False)
    one.load_model(str(out / "tp0.model"), exact=True)
    w.one_step(one, tw.second_batch())
    z, a = tw.sampler_inputs()
    want = (one.pipeline.z_det(z).numpy(), one.pipeline.atob_det(a).numpy())
    for r in (0, 1):
        for got, ref in zip(res[r]["tp"]["samples"], want):
            np.testing.assert_allclose(got, ref, **STEP_TOL)


def test_2x2_mesh_trains_from_the_device_dataset(ranks, tmp_path,
                                                 monkeypatch):
    """tests/test_parallel.py's test_dp_tp_mesh_trains_device_cache, and
    the loss rows of one process's 2 epochs."""
    _, out = ranks
    monkeypatch.setenv("TERRAIN_ARTIFACT_EVERY", "999")
    gan = TwoStageGAN(**w.tiny_kw(det_sampler(0), da=True))
    ds = w.device_pairs()
    gan.train(ds, ds, batch_size=w.GLOBAL_BATCH, num_epochs=2,
              out_dir=str(tmp_path), save_every=999)
    ref = csv_rows(os.path.join(tmp_path, "results.txt"))
    keys = [k for k in ref[0] if k.startswith(("train_", "valid_"))]
    for r in range(WORLD):
        got = csv_rows(os.path.join(out, f"grid{r}", "results.txt"))
        assert len(got) == 2
        for row_ref, row_got in zip(ref, got):
            for k in keys:
                assert np.isfinite(float(row_got[k]))
                np.testing.assert_allclose(
                    float(row_got[k]), float(row_ref[k]), **ROW_TOL,
                    err_msg=f"epoch {row_ref['epoch']} col {k} rank {r}")


def test_grid_chunked_epochs_equal_the_per_step_epochs(ranks):
    """TERRAIN_SCAN=2 on the 2x2 mesh: chunks of 2 on every rank, loss
    rows equal to the per-step epochs' to the bit; the step holds a data
    and a model group, over which one pass of train/step._on_any_rank
    carries rank 3's flag to every rank of the mesh."""
    res, out = ranks
    for r in range(WORLD):
        scan = res[r]["grid_scan"]
        assert scan["ks"] == [2] and scan["groups"] == 2 and scan["any"]
        rows = [[{k: v for k, v in row.items()
                  if k.startswith(("train_", "valid_"))}
                 for row in csv_rows(os.path.join(out, f"{name}{r}",
                                                  "results.txt"))]
                for name in ("gridscan", "grid")]
        assert len(rows[0]) == 2 and rows[0] == rows[1]


def test_dryrun_multichip_takes_n_model_2_at_4_ranks():
    entry.dryrun_multichip(4)

"""terrain_tpu_torch.parallel in one process on the CPU: the mesh's
shapes, laid out and with a faked world (tests/test_parallel.py's), the
tensor-parallel selection rule on terrain_tpu's leaves, the distributed
helpers and their single-process path, HostShardIterator, the nine
exports, and what a process group of one rank gives: the synced BatchNorm
against terrain_tpu's batch_norm (rtol 1e-5, atol 1e-6: fp32 sums in
another order), and a trainer on a world-1 mesh against one without a mesh
(the same fp32 rounding) and against itself (bit-equal), and its
checkpoint saved and resumed.  A sharding of image rows over 'model'
places each model index's rows of its data block, one of output features
its slice (tests/test_torch_tp.py runs tensor parallelism across
processes, tests/test_torch_spatial.py spatial parallelism).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from terrain_tpu.ops.norm import batch_norm as jbatch_norm
from terrain_tpu_torch import parallel
from terrain_tpu_torch.data import Hdf5Iterator
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.parallel import (
    HostShardIterator, host_batch_slice, initialize, make_mesh, place,
    replicated, spatial_batch_sharding, tp_shardings)
from terrain_tpu_torch.parallel.distributed import _TORCHRUN_ENV
from terrain_tpu_torch.parallel.mesh import Mesh, Sharding, gather
from terrain_tpu_torch.train.step import step_state
from terrain_tpu_torch.train.trainer import TwoStageGAN
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_mp_worker as w

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL = (None, None, None, "model")


@pytest.fixture
def no_cluster(monkeypatch):
    for k in (*_TORCHRUN_ENV, "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def world1(tmp_path, no_cluster):
    """A gloo process group of one rank, torn down after the test."""
    assert initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                      backend="gloo") == (0, 1)
    yield
    dist.destroy_process_group()


def test_mesh_shapes(no_cluster):
    mesh = make_mesh(n_data=4, n_model=2, ranks=range(8))
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert make_mesh(ranks=range(8)).shape == {"data": 8, "model": 1}
    one = make_mesh()  # no process group: the 1x1 mesh
    assert one.shape == {"data": 1, "model": 1}
    assert one.data_group is None and one.model_group is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(n_data=2, n_model=2)


def test_tp_shardings_select_wide_weights():
    """terrain_tpu's rule on tests/test_parallel.py's leaves (output
    features last)."""
    mesh = make_mesh(n_data=4, n_model=2, ranks=range(8))
    params = {"wide": np.zeros((3, 3, 64, 256)),
              "narrow": np.zeros((3, 3, 8, 16)),
              "dense": np.zeros((100, 512)),
              "bias": np.zeros((256,)),
              "odd": [np.zeros((3, 3, 64, 257))]}
    sh = tp_shardings(params, mesh)
    assert sh["wide"].spec == MODEL
    assert sh["dense"].spec == (None, "model")
    assert sh["narrow"].spec == () and sh["bias"].spec == ()
    assert sh["odd"][0].spec == ()
    # one rank on 'model': everything replicated
    one = make_mesh(ranks=range(8))
    assert tp_shardings(params, one)["wide"] == replicated(one)


def test_distributed_helpers_single_process(no_cluster):
    assert initialize() == (0, 1)  # no cluster environment: one process
    assert not dist.is_initialized()
    assert host_batch_slice(32) == slice(0, 32)
    assert host_batch_slice(32, process_index=2, process_count=4) == \
        slice(16, 24)


def test_a_partial_cluster_environment_raises(no_cluster, monkeypatch):
    """Only an environment without any of torchrun's variables is one
    process; a partial one is a failed initialization, which raises."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises((ValueError, RuntimeError, KeyError)):
        initialize(backend="gloo")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize(num_processes=2)


def test_host_shard_iterator_disjoint_and_complete():
    x, y = make_pairs(16, 8, seed=0)
    global_it = Hdf5Iterator(x, y, bs=8)
    hosts = [HostShardIterator(Hdf5Iterator(x, y, bs=8), process_index=i,
                               process_count=4) for i in range(4)]
    assert all(h.N == 16 for h in hosts)
    for _ in range(3):  # across epoch boundaries
        gx, gy = next(global_it)
        parts = [next(h) for h in hosts]
        assert all(px.shape[0] == 2 for px, _ in parts)
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                      gx)
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                      gy)


def test_top_level_exports():
    """terrain_tpu.parallel's nine names, and the spatial layer's four."""
    import terrain_tpu.parallel as jparallel

    spatial = {"shard_rows", "halo_exchange", "gather_rows", "scatter_rows"}
    assert sorted(set(parallel.__all__) - spatial) == sorted(jparallel.__all__)
    assert len(parallel.__all__) == 13
    assert all(callable(getattr(parallel, n)) for n in parallel.__all__)


def test_model_axis_places_rows_and_features(no_cluster):
    """Image rows over 'model' (spatial parallelism) place: each (data,
    model) index keeps its data block's rows of every image; output
    features over 'model' (tensor parallelism) place: each model index
    keeps its contiguous slice of the split axis."""
    mesh = make_mesh(n_data=2, n_model=2, ranks=range(4))
    batch = torch.arange(4 * 8 * 3.0).reshape(4, 8, 3, 1)
    for d in (0, 1):
        for m in (0, 1):
            laid_out = Mesh(mesh.ranks, data_index=d, model_index=m)
            got = place({"x": batch.clone()},
                        {"x": spatial_batch_sharding(laid_out)})
            assert got["x"].equal(batch[2 * d:2 * d + 2, 4 * m:4 * m + 4])
            assert got["x"].is_contiguous()
    # putting whole images back is a collective over the mesh's groups
    with pytest.raises(ValueError, match="process group"):
        gather({"x": batch[:2, :4]}, {"x": spatial_batch_sharding(mesh)})
    mesh = make_mesh(n_data=1, n_model=2, ranks=range(2))
    full = torch.arange(48.0).reshape(4, 3, 2, 2)
    for index in (0, 1):
        laid_out = Mesh(mesh.ranks, model_index=index)
        got = place({"w": full.clone(), "b": full[:, 0, 0, 0].clone()},
                    {"w": Sharding(laid_out, ("model", None, None, None)),
                     "b": replicated(laid_out)})
        assert got["w"].equal(full[2 * index:2 * index + 2])
        assert got["w"].is_contiguous() and got["b"].equal(full[:, 0, 0, 0])
    # a trainer on 'model' needs the ranks' process group
    with pytest.raises(ValueError, match="process group"):
        TwoStageGAN(**w.nets_kw(), mesh=mesh)
    with pytest.raises(ValueError, match="process group"):
        TwoStageGAN(**w.nets_kw(), mesh=make_mesh(ranks=range(2)))


def test_synced_batch_norm_at_world_1(world1):
    x, g, gamma, beta = w.bn_inputs()
    c = x.shape[-1]
    want, new_state = jbatch_norm(
        jnp.asarray(x), {"gamma": gamma, "beta": beta},
        {"mean": jnp.zeros(c), "inv_std": jnp.ones(c)}, train=True)
    out = {}
    for group in (None, dist.group.WORLD):
        bn = BatchNorm(c)
        bn.process_group = group
        with torch.no_grad():
            bn.gamma.copy_(torch.from_numpy(gamma))
            bn.beta.copy_(torch.from_numpy(beta))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt, train=True, update_stats=True)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
        out[group] = (y.detach(), dx)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(bn.mean.numpy(),
                                   np.asarray(new_state["mean"]), **TOL)
        np.testing.assert_allclose(bn.inv_std.numpy(),
                                   np.asarray(new_state["inv_std"]), **TOL)
    for a, b in zip(out[None], out[dist.group.WORLD]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_world_1_mesh_step_equals_no_mesh(world1):
    """NCCL's world of one, as the card checks it, here on gloo: the step
    over a one-rank mesh runs every collective (BN statistics, gradients,
    losses) and equals the step without a mesh to fp32 rounding, and
    itself bit for bit."""
    runs = []
    for mesh in (None, make_mesh(), make_mesh()):
        gan = TwoStageGAN(**w.nets_kw(), da=True, mesh=mesh)
        assert (gan._group is None) == (mesh is None)
        runs.append(w.one_step(gan, w.global_batch()))
    (l0, p0), (l1, p1), (l2, p2) = runs
    assert l1 == l2
    jax.tree.map(np.testing.assert_array_equal, p1, p2)
    for k in l0:
        np.testing.assert_allclose(l1[k], l0[k], err_msg=k, **TOL)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL), p1, p0)


def test_a_mesh_trainer_saves_and_resumes(world1, tmp_path):
    """A checkpoint written under a mesh (its BatchNorms hold the data
    group, which a copy of a module shares) loads back, through the
    broadcast from the data group's first rank, to the same tensors."""
    import copy

    gan = TwoStageGAN(**w.nets_kw(), mesh=make_mesh())
    bn = next(m for m in gan.nets["dcgan_gen"].modules()
              if isinstance(m, BatchNorm))
    assert copy.deepcopy(bn).process_group is bn.process_group is not None
    w.one_step(gan, w.global_batch())
    path = str(tmp_path / "1.model")
    gan.save_model(path)
    back = TwoStageGAN(**{**w.nets_kw(), "seed": 9}, mesh=make_mesh())
    back.load_model(path, exact=True)
    for a, b in zip(step_state(gan.nets, gan.opt_states),
                    step_state(back.nets, back.opt_states)):
        assert torch.equal(a, b)


def test_the_smoke_twin_calls_each_ranks_rows_alone():
    """chip_smoke.py's one-process twin of a two-rank step calls each
    discriminator once on each rank's rows of every block of the global
    batch (here real and fake rows: two blocks of 4), then puts the rows
    back: the same outputs and gradients as one call, to fp32 rounding,
    and the networks are themselves again after it."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gan = TwoStageGAN(**w.nets_kw())
    _, x, y = (torch.from_numpy(t) for t in w.global_batch())
    x, y = torch.cat([x, x.flip(0)]), torch.cat([y, y.flip(0)])
    seen = []
    for name, args in (("dcgan_disc", (x,)), ("p2p_disc", (x, y))):
        d = gan.nets[name]
        args = [a.clone().requires_grad_() for a in args]
        runs = []
        for twin in (False, True):
            with (smoke._discriminators_as_ranks(torch, gan, 2,
                                                 w.GLOBAL_BATCH)
                  if twin else contextlib.nullcontext()):
                out = d(*args, train=True)
                cot = torch.randn(out.shape,
                                  generator=torch.Generator().manual_seed(3))
                runs.append([out] + list(torch.autograd.grad(
                    out, args + list(d.parameters()), cot)))
            seen.append("forward" in vars(d))
        for a, b in zip(*runs):
            np.testing.assert_allclose(b.detach().numpy(),
                                       a.detach().numpy(), **TOL)
    assert not any(seen)

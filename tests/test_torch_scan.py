"""TERRAIN_SCAN in terrain_tpu_torch on the CPU: the persistent generators
that a CUDA graph of k steps draws from (re-seeded, each draws what a new
generator with the same seed draws, in augmentation and dropout, so the
trainer's numbers are those of its old per-step generators); the eval pass
chunked as the train pass is; the graph path's cache, held with a stand-in
for the CUDA graph that bakes lr as a capture does (an lr change between
chunks takes effect at the next chunk; adam's device step count advances
in a chunk as in eager steps and round-trips through terrain_tpu's
checkpoint format); and the port's chunked epoch, rmsprop and adam,
against terrain_tpu's scanned epoch (terrain_tpu's
tests/test_scan_step.py), from the same weights, data and prior draws,
augmentation off (its draws come from other generators in the two
packages), at terrain_tpu's tiny 16px test model.

Tolerances: the chunked epoch equals the per-step epoch exactly (the same
operations); against terrain_tpu 2e-4 relative on every loss column, as
tests/test_torch_trainer.py holds the unchunked trainers (fp32 sums in
another order).  The CUDA graph itself is held against eager steps on the
card by chip_smoke.py's scan phase.
"""

import os

import jax
import numpy as np
import pytest
import torch

from terrain_tpu.data import DeviceDataset as JDeviceDataset
from terrain_tpu.data.synthetic import make_pairs as jmake_pairs
from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.train.trainer import TwoStageGAN as JTwoStageGAN
from terrain_tpu_torch import experiments
from terrain_tpu_torch.data import DeviceDataset, augment_pair
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.models import convert, core, dcgan, unet
from terrain_tpu_torch.train import optim, step
from terrain_tpu_torch.train.losses import TRAIN_KEYS
from terrain_tpu_torch.train.trainer import TwoStageGAN
from tiny_cfg import csv_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

IN, LAT, BS = 16, 8, 4
LOSS_TOL = 2e-4
LOSS_COLS = [f"{s}_{k}" for s in ("train", "valid") for k in TRAIN_KEYS]
# terrain_tpu's tests/test_trainer.py tiny_model
NETS = dict(
    gen_params_dcgan={"nch": 8, "h": 3, "initial_size": 4, "final_size": IN,
                      "div": [2, 2]},
    disc_params_dcgan={"nch": IN, "h": 3, "div": [4, 2], "bn": False,
                       "nonlinearity": "linear"},
    gen_params_p2p={"nf": 4, "act": "tanh"},
    disc_params_p2p={"nf": 4, "bn": False, "act": "linear"},
    in_shp=IN, latent_dim=LAT, is_a_grayscale=True, is_b_grayscale=False,
    lsgan=True, opt="rmsprop", opt_args={"learning_rate": 1e-4},
    train_mode="both", verbose=False, da=False)


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _smoke_gan(**kw):
    return experiments.build_gan("smoke_synthetic", "cpu", verbose=False,
                                 **kw)[0]


def test_a_reseeded_generator_draws_what_a_fresh_one_draws(rng):
    x = torch.from_numpy(rng.rand(3, 16, 16, 1).astype(np.float32))
    y = torch.from_numpy(rng.rand(3, 16, 16, 3).astype(np.float32))
    g = torch.Generator()
    torch.rand(17, generator=g)  # a used generator, mid-stream
    for seed in (5, 123456789):
        fresh = augment_pair(torch.Generator().manual_seed(seed), x, y)
        again = augment_pair(g.manual_seed(seed), x, y)
        for a, b in zip(fresh, again):
            assert torch.equal(a, b)
        h = torch.ones(2, 8, 8, 4)
        assert torch.equal(
            core.dropout(h, 0.5, torch.Generator().manual_seed(seed), True),
            core.dropout(h, 0.5, g.manual_seed(seed), True))
    # a network's dropout through its forward
    net = unet.g_unet(IN, True, False, nf=4, dropout_p=0.5,
                      generator=torch.Generator().manual_seed(0))
    assert net.dropout_p == 0.5
    outs = [net(x, train=True, generator=gen)
            for gen in (torch.Generator().manual_seed(9), g.manual_seed(9))]
    assert torch.equal(*outs)


def test_the_trainers_generators_are_persistent_with_the_old_seeds():
    """Each step slot keeps its five generators; every step re-seeds them
    with ((seed * 1_000_003 + counter) << 3) + stream, the seeds of the
    fresh generators the trainer made before, so its draws are unchanged."""
    gan = _smoke_gan(seed=3)
    first = gan._next_rngs(0)
    assert list(first) == ["augment", *step.NET_NAMES]
    ids = {n: id(g) for n, g in first.items()}
    slot1 = gan._next_rngs(1)
    assert not set(map(id, slot1.values())) & set(ids.values())
    counter = gan._step_counter
    again = gan._next_rngs(0)
    assert {n: id(g) for n, g in again.items()} == ids
    for stream, n in enumerate(again):
        old = torch.Generator().manual_seed(
            ((3 * 1_000_003 + counter + 1) << 3) + stream)
        assert torch.equal(torch.rand(5, generator=again[n]),
                           torch.rand(5, generator=old)), n
    s = gan._next_generator()
    assert gan._next_generator() is s


def test_chunked_eval_equals_the_per_step_eval(monkeypatch):
    """The eval pass is chunked as the train pass is (terrain_tpu
    trainer.py:403-431), augmentation on, and its losses are the per-step
    pass's; the step counter advances alike."""
    _, valid = (DeviceDataset(*make_pairs(16, 64, seed=s), device="cpu")
                for s in (0, 1))
    chunks = []
    real = step.build_scan_eval
    monkeypatch.setattr("terrain_tpu_torch.train.trainer.build_scan_eval",
                        lambda ev: chunks.append(1) or real(ev))
    out = {}
    for scan in ("1", "4", "2"):
        monkeypatch.setenv("TERRAIN_SCAN", scan)
        gan = _smoke_gan(da=True, seed=1)
        np.random.seed(4)
        out[scan] = (gan._run_epoch(valid, BS, train=False),
                     gan._step_counter)
    assert out["4"] == out["1"] and out["2"] == out["1"]
    assert out["1"][1] == 4
    assert chunks == [1, 1]  # k = 4 and k = 2, none at k = 1


class _Baked:
    """A stand-in for `step.CapturedSteps` on the CPU: like a graph, it
    runs the step it was made with (whose lr is fixed) on new inputs."""

    made = []

    def __init__(self, fn, batches, rngs, state=()):
        self.fn = fn
        self.state = state
        _Baked.made.append(self)

    def __call__(self, batches):
        return step._stack_losses([self.fn(b, None) for b in batches])


def _chunks(seed, n=3):
    rnd = np.random.RandomState(seed)
    ds = DeviceDataset(*make_pairs(8, 64, seed=0), device="cpu")
    out = []
    for _ in range(n):
        Z = torch.from_numpy(rnd.rand(2, BS, 32).astype(np.float32))
        idx = torch.from_numpy(rnd.randint(0, 8, (2, BS)))
        out.append([ds.batch_args(Z[t], idx[t]) for t in range(2)])
    return ds, out


def test_an_lr_change_takes_effect_at_the_next_chunk(monkeypatch):
    """The graph path's cache, with `_Baked` in place of the CUDA graph:
    chunks at one lr reuse one capture; a new lr, or optimizer states at
    new addresses, re-capture; the losses and weights equal per-step runs
    with the same lr schedule."""
    lrs = (1e-4, 1e-4, 5e-5)
    ds, chunks = _chunks(0)
    runs = {}
    for mode in ("steps", "graph"):
        gan = _smoke_gan(seed=2)
        tr, _ = gan._build_steps(ds.make_prepare(augment=False))
        losses = []
        if mode == "steps":
            for lr, chunk in zip(lrs, chunks):
                losses += [tr(gan.opt_states, b, None, lr) for b in chunk]
        else:
            _Baked.made = []
            monkeypatch.setattr(step, "CapturedSteps", _Baked)
            monkeypatch.setattr(step, "_on_cpu", lambda b: False)
            scan = step.build_scan_step(tr)
            for lr, chunk in zip(lrs, chunks):
                out = scan(gan.opt_states, chunk, [None, None], lr)
                losses += [{k: v[t] for k, v in out.items()}
                           for t in range(2)]
            assert len(_Baked.made) == 2  # the lr change re-captured
            state = _Baked.made[-1].state
            assert len(state) == len(step.step_state(gan.nets,
                                                     gan.opt_states))
            gan._init_opt_states()  # new addresses: captured anew
            scan(gan.opt_states, chunks[0], [None, None], lrs[-1])
            assert len(_Baked.made) == 3
            monkeypatch.undo()
        runs[mode] = (losses, [p.detach().clone() for net in gan.nets.values()
                               for p in net.parameters()])
    for a, b in zip(runs["steps"][0], runs["graph"][0]):
        assert {k: float(v) for k, v in a.items()} == {
            k: float(v) for k, v in b.items()}
    # the last chunk of the graph run re-ran chunk 0 on fresh states, so
    # compare the weights of a per-step run that does the same
    gan = _smoke_gan(seed=2)
    tr, _ = gan._build_steps(ds.make_prepare(augment=False))
    for lr, chunk in zip(lrs, chunks):
        for b in chunk:
            tr(gan.opt_states, b, None, lr)
    gan._init_opt_states()
    for b in chunks[0]:
        tr(gan.opt_states, b, None, lrs[-1])
    want = [p for net in gan.nets.values() for p in net.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(runs["graph"][1], want))


def test_adam_is_refused_by_the_graph_path(monkeypatch):
    """The name is kept from when the graph path took rmsprop only, adam's
    step count then living on the host.  Now `t` is a device int32 tensor
    among the state the graph updates, so a chunked adam epoch through the
    graph path's cache (`_Baked` in place of the capture) equals eager
    adam: losses, weights and step counts."""
    ds, chunks = _chunks(1, n=2)
    runs = {}
    for mode in ("steps", "graph"):
        gan = _smoke_gan(seed=2)
        gan.optimizer = optim.adam()
        gan._init_opt_states()
        tr, _ = gan._build_steps(ds.make_prepare(augment=False))
        if mode == "steps":
            losses = [tr(gan.opt_states, b, None, 1e-4)
                      for chunk in chunks for b in chunk]
        else:
            _Baked.made = []
            monkeypatch.setattr(step, "CapturedSteps", _Baked)
            monkeypatch.setattr(step, "_on_cpu", lambda b: False)
            scan = step.build_scan_step(tr)
            losses = []
            for chunk in chunks:
                out = scan(gan.opt_states, chunk, [None, None], 1e-4)
                losses += [{k: v[t] for k, v in out.items()}
                           for t in range(2)]
            assert len(_Baked.made) == 1  # captured once, replayed
            held = {id(t) for t in _Baked.made[0].state}
            assert all(id(st["t"]) in held for st in gan.opt_states.values())
            monkeypatch.undo()
        runs[mode] = (losses, [p.detach().clone() for net in gan.nets.values()
                               for p in net.parameters()],
                      {n: st["t"] for n, st in gan.opt_states.items()})
    for a, b in zip(runs["steps"][0], runs["graph"][0]):
        assert {k: float(v) for k, v in a.items()} == {
            k: float(v) for k, v in b.items()}
    assert all(torch.equal(a, b) for a, b in zip(runs["steps"][1],
                                                 runs["graph"][1]))
    for t in (*runs["steps"][2].values(), *runs["graph"][2].values()):
        assert t.dtype == torch.int32 and t.shape == () and int(t) == 4


def test_adams_step_count_round_trips_through_a_jax_checkpoint(tmp_path):
    """adam's device `t` is written as terrain_tpu's int32 scalar, which
    terrain_tpu reads back, and a terrain_tpu-written `t` resumes in the
    port as a device int32 tensor that the next step advances."""
    from terrain_tpu.train import checkpoint as jckpt

    ds, chunks = _chunks(2, n=1)
    gan = _smoke_gan(seed=2)
    gan.optimizer = optim.adam()
    gan._init_opt_states()
    tr, _ = gan._build_steps(ds.make_prepare(augment=False))
    for b in chunks[0]:
        tr(gan.opt_states, b, None, 1e-4)
    path = str(tmp_path / "2.model")
    gan.save_model(path)
    params, states, extra = jckpt.load_model(path, {}, {})
    for n in step.NET_NAMES:
        t = extra["opt_states"][n]["t"]
        assert t.dtype == np.int32 and t.shape == () and int(t) == 2
        extra["opt_states"][n]["t"] = np.int32(7)
    jpath = str(tmp_path / "7.model")
    jckpt.save_model(jpath, params, states, extra=extra)
    back = _smoke_gan(seed=5)
    back.optimizer = optim.adam()
    back.load_model(jpath, exact=True)
    for n in step.NET_NAMES:
        t = back.opt_states[n]["t"]
        assert t.dtype == torch.int32 and int(t) == 7
        for a, b in zip(back.opt_states[n]["m"], gan.opt_states[n]["m"]):
            assert torch.equal(a, b)
    tr, _ = back._build_steps(ds.make_prepare(augment=False))
    tr(back.opt_states, chunks[0][0], None, 1e-4)
    assert all(int(st["t"]) == 8 for st in back.opt_states.values())


def _jax_gan(**kw):
    return JTwoStageGAN(
        gen_fn_dcgan=jdcgan.default_generator,
        disc_fn_dcgan=jdcgan.default_discriminator,
        gen_fn_p2p=jp2p.g_unet, disc_fn_p2p=jp2p.discriminator, seed=3,
        **{**NETS, **kw})


def _torch_gan(weights, **kw):
    gan = TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator, seed=3,
        device="cpu", **{**NETS, **kw})
    for n, (p, s) in weights.items():
        convert.load_jax(gan.nets[n], p, s)
    return gan


def _epoch(gan, cls, root, **kw):
    np.random.seed(42)  # the prior sampler draws from the global stream
    x, y = jmake_pairs(8, IN, seed=0)
    xv, yv = jmake_pairs(8, IN, seed=1)
    gan.train(cls(x, y, **kw), cls(xv, yv, **kw), batch_size=BS,
              num_epochs=2, out_dir=str(root), save_every=10)
    return csv_rows(str(root / "results.txt"))


def test_chunked_epochs_match_terrain_tpus_scanned_epochs(monkeypatch,
                                                          tmp_path):
    """Two epochs of 2 train and 2 eval steps each at TERRAIN_SCAN=2: both
    passes run as one chunk in each package."""
    _held_to_scanned_jax(monkeypatch, tmp_path)


def _held_to_scanned_jax(monkeypatch, tmp_path, **kw):
    monkeypatch.setenv("TERRAIN_SCAN", "2")
    jgan = _jax_gan(**kw)
    weights = {n: (jax.tree.map(np.asarray, jgan.params[n]),
                   jax.tree.map(np.asarray, jgan.states[n]))
               for n in jgan.nets}
    jrows = _epoch(jgan, JDeviceDataset, tmp_path / "jax")
    rows = {}
    for scan in ("2", "1"):
        monkeypatch.setenv("TERRAIN_SCAN", scan)
        rows[scan] = _epoch(_torch_gan(weights, **kw), DeviceDataset,
                            tmp_path / f"torch{scan}", device="cpu")
    for got, want in zip(rows["2"], jrows):
        for col in LOSS_COLS:
            assert float(got[col]) == pytest.approx(float(want[col]),
                                                    rel=LOSS_TOL), col
    for a, b in zip(rows["2"], rows["1"]):
        assert [a[c] for c in LOSS_COLS] == [b[c] for c in LOSS_COLS]


def test_chunked_adam_epochs_match_terrain_tpus_scanned_epochs(monkeypatch,
                                                               tmp_path):
    """The same with adam, whose step count terrain_tpu's scan carries in
    its optimizer state and the port's chunk on the device."""
    _held_to_scanned_jax(monkeypatch, tmp_path, opt="adam",
                         opt_args={"learning_rate": 1e-4})


def test_a_kernel_is_not_built_inside_a_capture(monkeypatch):
    """The warm-up step builds and binds every kernel; a first launch
    inside a capture raises instead of building there.  Launch counts are
    taken per call of `launch`, which a replay does not make."""
    from terrain_tpu_torch.ops.kernels import _build

    k = _build.CudaKernel("conv_thin", "no_such_entry", [])
    monkeypatch.setattr(_build, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        k.launch()
    assert k.launches == 0
    assert "replays" in _build.CudaKernel.__doc__

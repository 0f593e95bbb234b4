"""TERRAIN_CHECK_NANS=2 in terrain_tpu_torch (utils/nan_check.py) against
terrain_tpu's checkify float checks, on the CPU, at terrain_tpu's tiny
trainer configuration (16px).

The NaN-poisoned weight of terrain_tpu's own checkify test (p2p_gen's
first encoder conv, carried across with convert.load_jax) makes the port
raise in step 1, naming the network, the layer, the op and the step.  A clean checked run gives the
unchecked run's bits, per step and as a TERRAIN_SCAN chunk (a loop on the
CPU).  A NaN planted in step 2 of a chunk names step 2, one that only a
backward op makes names that op and its forward layer, Inf alone raises
nothing, and a hand-written kernel's outputs are checked under its name.
"""

import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from terrain_tpu.data.synthetic import make_pairs as jmake_pairs
from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import p2p as jp2p
from terrain_tpu.train.trainer import TwoStageGAN as JTwoStageGAN
from terrain_tpu_torch.data import DeviceDataset, Hdf5Iterator
from terrain_tpu_torch.models import convert, dcgan, unet
from terrain_tpu_torch.ops.kernels import (
    bilinear, bilinear_conv, conv_s2, conv_stem, conv_thin, pool2)
from terrain_tpu_torch.train import step as steps
from terrain_tpu_torch.train.trainer import TwoStageGAN
from terrain_tpu_torch.utils import nan_check
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

IN, LAT, BS = 16, 8, 4
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
    train_mode="both", verbose=False)


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _jax_gan():
    return JTwoStageGAN(
        gen_fn_dcgan=jdcgan.default_generator,
        disc_fn_dcgan=jdcgan.default_discriminator,
        gen_fn_p2p=jp2p.g_unet, disc_fn_p2p=jp2p.discriminator, **NETS)


def _torch_gan(weights=None, **kw):
    gan = TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        device="cpu", **{**NETS, **kw})
    for n, (p, s) in (weights or {}).items():
        convert.load_jax(gan.nets[n], p, s)
    return gan


def _iters(cls=Hdf5Iterator, n=8):
    x, y = jmake_pairs(n, IN, seed=0)
    xv, yv = jmake_pairs(4, IN, seed=1)
    return cls(x, y, BS), cls(xv, yv, BS)


def _device_sets():
    x, y = jmake_pairs(8, IN, seed=0)
    xv, yv = jmake_pairs(4, IN, seed=1)
    return (DeviceDataset(x, y, device="cpu"),
            DeviceDataset(xv, yv, device="cpu"))


def test_a_poisoned_weight_raises_in_both_packages(tmp_path, monkeypatch):
    """The weights of terrain_tpu/tests/test_trainer.py's checkify case,
    p2p_gen's first encoder conv poisoned with NaN, in the port: step 1
    raises, naming p2p_gen's layer.  That terrain_tpu raises on them is
    its own test (tests/test_trainer.py
    `test_checkify_nan_guard_localizes`); the JAX step under checkify is
    not compiled here a second time."""
    jgan = _jax_gan()
    jgan.params["p2p_gen"]["enc"][0]["conv"]["w"] = (
        jgan.params["p2p_gen"]["enc"][0]["conv"]["w"] * np.nan)
    weights = {n: (jax.tree.map(np.asarray, jgan.params[n]),
                   jax.tree.map(np.asarray, jgan.states[n]))
               for n in jgan.nets}
    monkeypatch.setenv("TERRAIN_CHECK_NANS", "2")
    gan = _torch_gan(weights)
    with pytest.raises(FloatingPointError, match="(?i)nan") as err:
        gan.train(*_iters(), BS, 1, str(tmp_path / "t"), None,
                  quick_run=True)
    msg = str(err.value)
    assert "step 1 of 1" in msg
    assert "p2p_gen enc.0.conv: aten.convolution.default (forward)" in msg


def _params(gan):
    return [t.detach().clone() for net in gan.nets.values()
            for t in (*net.parameters(), *net.buffers())]


@pytest.mark.parametrize("path", ["host", "scan"])
def test_a_clean_checked_run_equals_the_unchecked_run(tmp_path, monkeypatch,
                                                      path):
    """Two epochs from the same seeds, checked and unchecked: the same
    bits in every parameter, statistic and loss column.  "scan": the
    device-resident set in chunks of 2 (a loop on the CPU)."""
    got = {}
    for checked in (False, True):
        if checked:
            monkeypatch.setenv("TERRAIN_CHECK_NANS", "2")
        if path == "scan":
            monkeypatch.setenv("TERRAIN_SCAN", "2")
        gan = _torch_gan(da=True)
        np.random.seed(0)
        data = _iters() if path == "host" else _device_sets()
        out = tmp_path / str(checked)
        gan.train(*data, BS, 2, str(out), None)
        got[checked] = (_params(gan), (out / "results.txt").read_text())
    for a, b in zip(got[False][0], got[True][0], strict=True):
        assert torch.equal(a, b)
    strip = [",".join(r.split(",")[:-2]) for r in got[False][1].split("\n")]
    assert strip == [",".join(r.split(",")[:-2])
                     for r in got[True][1].split("\n")]


def test_a_nan_in_step_2_of_a_chunk_names_step_2(tmp_path, monkeypatch):
    """The prior of the chunk's second step holds a NaN: the DCGAN
    generator's first layer raises, named with step 2 of 2."""
    monkeypatch.setenv("TERRAIN_CHECK_NANS", "2")
    monkeypatch.setenv("TERRAIN_SCAN", "2")
    calls = []

    def sampler(n, d):
        calls.append(1)
        z = np.random.rand(n, d).astype(np.float32)
        if len(calls) == 2:
            z[0, 0] = np.nan
        return z

    gan = _torch_gan(sampler=sampler)
    with pytest.raises(FloatingPointError) as err:
        gan.train(*_device_sets(), BS, 1, str(tmp_path), None)
    msg = str(err.value)
    assert "step 2 of 2" in msg and "dcgan_gen " in msg, msg


class _Sqrt(nn.Module):
    """y = sqrt(|w x|) * 0: finite forward, 0/0 in its backward at x = 0."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward(self, x):
        return torch.sqrt((self.w * x).abs()) * 0.0


def _checked(body, net, groups=()):
    """A toy step of `body(x)` built as build_train_step builds one: it
    carries its NaN checks, and an eager call runs as a chunk of one."""
    def step(x):
        if steps._eager(step):
            return steps._loop(lambda b, r: step(b), [x], [None], step)[0]
        return body(x)

    step.nets, step.groups = {"toy": net}, groups
    step.checks = steps._checks(step.nets, True)
    return step


def _toy_step(net, groups=()):
    def body(x):
        y = net.inner(x)
        (g,) = torch.autograd.grad(y.sum() + x.sum(), [net.inner.w])
        return g

    return _checked(body, net, groups)


def test_a_nan_only_a_backward_op_makes_is_caught():
    net = nn.Module()
    net.inner = _Sqrt()
    run = _toy_step(net)
    assert torch.isfinite(run(torch.ones(3))).all()
    with pytest.raises(FloatingPointError) as err:
        run(torch.tensor([1.0, 0.0, 2.0]))
    msg = str(err.value)
    assert "toy inner" in msg and "backward" in msg, msg


def test_inf_alone_raises_nothing():
    net = nn.Module()
    net.inner = nn.Linear(3, 3)
    with torch.no_grad():
        net.inner.weight.fill_(1.0)

    def body(x):
        return net.inner(x) * 2.0

    out = _checked(body, net)(torch.tensor([[float("inf"), 1.0, 1.0]]))
    assert torch.isinf(out).all()


def test_each_kernel_is_checked_under_its_name():
    """Every hand-written kernel's wrapper passes its outputs to the checks
    (on the card, after its launch) under the name chip_smoke.py reports it
    by; a NaN there names the kernel."""
    kernels = {k.name for mod in (bilinear, bilinear_conv, conv_s2,
                                  conv_stem, conv_thin, pool2)
               for k in vars(mod).values()
               if isinstance(k, type(pool2.KERNEL_FWD))}
    assert kernels == {"bilinear_conv", "conv_thin", "conv_thin_dx",
                       "conv_thin_dw", "conv_stem_fwd", "conv_stem_dw",
                       "conv_stem_dx", "conv_s2_fwd", "conv_s2_dw",
                       "pool2_fwd", "pool2_bwd", "bilinear"}
    net = nn.Module()
    net.inner = nn.Linear(2, 2)
    bad = torch.full((2,), float("nan"))  # made before the checks record

    def body(x):
        y = net.inner(x)
        nan_check.kernel_outputs("conv_stem_fwd", bad)
        return y

    run = _checked(body, net)
    nan_check.KERNEL_CHECKS.clear()
    with pytest.raises(FloatingPointError, match="kernel conv_stem_fwd"):
        run(torch.ones(1, 2))
    assert nan_check.KERNEL_CHECKS == {"conv_stem_fwd": 1}
    nan_check.KERNEL_CHECKS.clear()

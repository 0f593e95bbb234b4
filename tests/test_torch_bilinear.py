"""terrain_tpu_torch's bilinear x2 op (ops/kernels/bilinear.py), the
switches that reach it, and the conv kernels' opt-outs, against terrain_tpu
on the CPU, fp32.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there); here `Bilinear2xFn` runs its plain version on CPU
tensors, and that is what is held against terrain_tpu's Pallas kernel in
interpret mode, its XLA path, and its custom VJP.

Tolerances: 1e-5 absolute on values of unit scale (fp32 sums of two or
four weighted terms, in another order than jax.image.resize's); 2e-4
absolute on the 512px U-Net's outputs in [-1, 1] (fp32 through ~20
layers, as tests/test_torch_models.py).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from terrain_tpu.models import unet as junet
from terrain_tpu.ops import fused as jfused
from terrain_tpu.ops import resize as jresize
from terrain_tpu.ops.pallas.bilinear import (
    _pallas_bilinear_2x, _xla_bilinear_2x, bilinear_2x_pallas,
    pallas_supported)
from terrain_tpu_torch.models import convert, unet
from terrain_tpu_torch.ops import conv, fused, resize
from terrain_tpu_torch.ops.kernels import bilinear as bl
from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
from terrain_tpu_torch.ops.kernels import conv_s2 as c2
from terrain_tpu_torch.ops.kernels import conv_stem as cs
from terrain_tpu_torch.ops.kernels import conv_thin as ct
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=0, atol=1e-5)
SWITCHES = ("TERRAIN_PALLAS", "TERRAIN_PALLAS_DECODER", "TERRAIN_PALLAS_CONV",
            "TERRAIN_RESIZE", "TERRAIN_PALLAS_STEM", "TERRAIN_PALLAS_THIN",
            "TERRAIN_PALLAS_CONVS2")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _x(rng, shape):
    return rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 8, 16, 256)])
def test_plain_version_matches_the_pallas_kernel_and_xla(shape, rng):
    x = _x(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(_pallas_bilinear_2x(jnp.asarray(x)))
    xla = np.asarray(_xla_bilinear_2x(jnp.asarray(x)))
    bl.PLAIN.calls = 0
    got = bl.bilinear_2x(torch.from_numpy(x)).numpy()
    assert bl.PLAIN.calls == 1
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 1, 5, 4)])
def test_gradient_matches_the_custom_vjp(shape, rng):
    """The transpose (PyTorch code) against jax.grad through
    bilinear_2x_pallas (its custom VJP, the XLA path's transpose), and
    against autograd of the plain version."""
    x = _x(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda v: jnp.sum(bilinear_2x_pallas(v) ** 2))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    bl.BACKWARD.calls = 0
    (got,) = torch.autograd.grad((bl.bilinear_2x(xt) ** 2).sum(), xt)
    assert bl.BACKWARD.calls == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    xp = torch.from_numpy(x).requires_grad_()
    (plain,) = torch.autograd.grad((bl.bilinear_2x_plain(xp) ** 2).sum(), xp)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_the_backward_is_deterministic_and_saves_no_tensor(rng):
    x = torch.from_numpy(_x(rng, (2, 16, 24, 8))).requires_grad_()
    y = bl.bilinear_2x(x)
    assert y.grad_fn is not None and not y.grad_fn.saved_tensors
    g = torch.from_numpy(_x(rng, tuple(y.shape)))
    a = torch.autograd.grad(y, x, g, retain_graph=True)[0]
    b = torch.autograd.grad(y, x, g)[0]
    assert torch.equal(a, b)


def test_regime_equals_terrain_tpus():
    for n, h, w, c in itertools.product(
            (1, 4), (64, 120, 128, 136, 250, 256, 512), (128, 200, 256),
            (64, 96, 128, 256, 384)):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16),
                         (torch.float16, jnp.float16)):
            assert bl.supported((n, h, w, c), tdt) == bool(
                pallas_supported((n, h, w, c), jdt)), (n, h, w, c, tdt)
    assert bl.supported((4, 128, 128, 256))      # the flagship's stage
    assert not bl.supported((4, 64, 64, 512))    # the stage before it
    assert bl.supported((2, 136, 200, 128))      # ragged, still in regime


@pytest.mark.parametrize("env,shape,kernel", [
    ({"TERRAIN_PALLAS": "1"}, (1, 128, 136, 128), True),
    ({"TERRAIN_PALLAS": "1"}, (1, 64, 64, 128), False),
    ({"TERRAIN_RESIZE": "dense"}, (2, 9, 7, 3), False),
    ({"TERRAIN_RESIZE": "dense", "TERRAIN_PALLAS": "1"}, (1, 128, 128, 128),
     True),
    ({}, (2, 9, 7, 3), False),
])
def test_upsample_dispatch_matches_terrain_tpu(env, shape, kernel,
                                               monkeypatch, rng):
    """upsample_bilinear_2x under terrain_tpu's switches, in both packages:
    the same values, and the port's kernel path exactly where terrain_tpu's
    Pallas kernel runs."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = _x(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jresize.upsample_bilinear_2x(jnp.asarray(x)))
    bl.PLAIN.calls = 0
    got = resize.upsample_bilinear_2x(torch.from_numpy(x)).numpy()
    assert bl.PLAIN.calls == int(kernel)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("env", [{"TERRAIN_PALLAS_DECODER": "0"},
                                 {"TERRAIN_PALLAS_CONV": "0"},
                                 {"TERRAIN_PALLAS_DECODER": "0",
                                  "TERRAIN_PALLAS": "1"}])
def test_unfused_decoder_composite_matches_terrain_tpu(env, monkeypatch,
                                                       rng):
    """bilinear2x_conv3x3 at a shape in bilinear_conv's regime, switched
    off: the composite runs (the fused op is never called) and equals
    terrain_tpu's composite."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shape, f = (1, 128, 128, 128), 8
    assert bc.supported(shape, (3, 3, shape[3], f))
    x = _x(rng, shape)
    w = (rng.randn(3, 3, shape[3], f) / 34.0).astype(np.float32)
    b = rng.randn(f).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.bilinear2x_conv3x3(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))

    def fused_op(*a):
        raise AssertionError("the fused kernel ran")

    monkeypatch.setattr(bc, "bilinear_conv", fused_op)
    bl.PLAIN.calls = 0
    got = fused.bilinear2x_conv3x3(
        torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
        torch.from_numpy(b)).numpy()
    assert bl.PLAIN.calls == int(env.get("TERRAIN_PALLAS") == "1")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_unet_512_with_the_unfused_decoder_matches_terrain_tpu(monkeypatch,
                                                               rng):
    """The slice: a 512px bilinear U-Net G (nf 32, the smallest width whose
    last decoder stage, (1,128,128,128), lies in the regime) under
    TERRAIN_PALLAS=1 TERRAIN_PALLAS_DECODER=0 in both packages, det mode,
    batch 1."""
    monkeypatch.setenv("TERRAIN_PALLAS", "1")
    monkeypatch.setenv("TERRAIN_PALLAS_DECODER", "0")
    kw = dict(nf=32, act="tanh", bilinear_upsample=True)
    tu = unet.g_unet(512, True, False, generator=torch.Generator()
                     .manual_seed(0), **kw)
    params, state = convert.to_jax(tu)
    ju = junet.g_unet(512, True, False, **kw)
    x = _x(rng, (1, 512, 512, 1))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ju.apply(params, state, jnp.asarray(x),
                                   train=False)[0])
    bl.PLAIN.calls = 0
    with torch.inference_mode():
        got = tu(torch.from_numpy(x)).numpy()
    assert bl.PLAIN.calls == 1  # the last bilinear stage, and only it
    assert got.shape == (1, 512, 512, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("env,on", [
    ({}, {"stem", "thin"}),
    ({"TERRAIN_PALLAS_CONVS2": "1"}, {"stem", "s2", "thin"}),
    ({"TERRAIN_PALLAS_STEM": "0"}, {"thin"}),
    ({"TERRAIN_PALLAS_THIN": "0", "TERRAIN_PALLAS_CONVS2": "1"},
     {"stem", "s2"}),
    ({"TERRAIN_PALLAS_CONV": "0", "TERRAIN_PALLAS_CONVS2": "1"}, set()),
    ({"TERRAIN_PALLAS_CONV": "0", "TERRAIN_PALLAS_STEM": "1"}, set()),
])
def test_conv_kernel_switches(env, on, monkeypatch, rng):
    """terrain_tpu's opt-outs (ops/conv.py:25-29,46-49,65-69): a kernel
    that is switched off is never called and the library conv gives the
    same values; nothing is caught."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    called = set()
    for name, mod, attr in (("stem", cs, "conv_stem"), ("s2", c2, "conv_s2"),
                            ("thin", ct, "conv_thin")):
        def spy(*a, _f=getattr(mod, attr), _n=name, **k):
            called.add(_n)
            return _f(*a, **k)

        monkeypatch.setattr(mod, attr, spy)
    x1 = torch.from_numpy(_x(rng, (1, 256, 256, 1)))
    x8 = torch.from_numpy(_x(rng, (1, 64, 128, 8)))
    w_stem = torch.from_numpy(rng.randn(8, 1, 5, 5).astype(np.float32))
    w_s2 = torch.from_numpy(rng.randn(8, 1, 3, 3).astype(np.float32))
    w_thin = torch.from_numpy(rng.randn(2, 8, 3, 3).astype(np.float32))
    outs = [conv.conv2d_leaky(x1, w_stem, slope=0.2),
            conv.conv2d(x1, w_s2, stride=2),
            conv.conv2d(x8, w_thin)]
    assert called == on
    refs = [torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(
                x1.permute(0, 3, 1, 2), w_stem, padding=2), 0.2),
            torch.nn.functional.conv2d(x1.permute(0, 3, 1, 2), w_s2,
                                       stride=2, padding=1),
            torch.nn.functional.conv2d(x8.permute(0, 3, 1, 2), w_thin,
                                       padding=1)]
    for got, ref in zip(outs, refs, strict=True):
        np.testing.assert_allclose(got.numpy(),
                                   ref.permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-4)

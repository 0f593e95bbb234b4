"""The gradient kernels' plain versions and the three differentiable ops of
terrain_tpu_torch/ops/kernels against terrain_tpu: `jax.grad` through the
Pallas kernels run in interpret mode (as tests/test_pallas.py runs them),
and through the XLA ops.  The CUDA kernels themselves run only on the card:
chip_smoke.py holds them against these plain versions there.

Inputs come from numpy with a seed and go to both packages, fp32.
Tolerance 1e-4 (rtol and atol) unless stated: both sides sum the same
products in different orders; weight gradients sum over every pixel, so
they get atol 1e-3 as in tests/test_pallas.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.ops import conv as jconv
from terrain_tpu.ops import fused as jfused
from terrain_tpu.ops import norm as jnorm
from terrain_tpu.ops import pool as jpool
from terrain_tpu.ops.pallas import bilinear_conv as jbc
from terrain_tpu.ops.pallas import conv_stem as jcs
from terrain_tpu.ops.pallas import conv_thin as jct
from terrain_tpu_torch import ops
from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
from terrain_tpu_torch.ops.kernels import conv_stem as cs
from terrain_tpu_torch.ops.kernels import conv_thin as ct

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_W = dict(rtol=1e-4, atol=1e-3)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _close(got, want, **tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


# ------------------------------------------------------------- conv_stem
def _stem_inputs(rng, shape, f):
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(5, 5, 1, f) * 0.1).astype(np.float32)
    b = rng.randn(f).astype(np.float32)
    cot = rng.randn(*shape[:3], f).astype(np.float32)
    return x, w, b, cot


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("shape,f", [((2, 8, 16, 1), 8),
                                     ((1, 16, 32, 1), 16)])
def test_conv_stem_plain_forward_matches_pallas(shape, f, slope, rng,
                                                monkeypatch):
    monkeypatch.setattr(jcs, "_INTERPRET", True)
    x, w, b, _ = _stem_inputs(rng, shape, f)
    want = jcs.conv_stem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         slope)
    got = cs.conv_stem(_t(x), _t(w), _t(b), slope)
    assert got.dtype == torch.float32
    _close(got, want, **TOL)
    xla = jcs._xla_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    if slope is not None:
        xla = jnp.where(xla >= 0, xla, slope * xla)
    _close(got, xla, **TOL)


@pytest.mark.parametrize("slope", [None, 0.2])
def test_conv_stem_gradient_ops_match_pallas_grads(slope, rng, monkeypatch):
    """dW, db and dX (with the mask taken from the saved output) against
    jax.grad through the interpret-mode kernels and through the XLA conv."""
    monkeypatch.setattr(jcs, "_INTERPRET", True)
    x, w, b, cot = _stem_inputs(rng, (2, 8, 24, 1), 8)

    def loss_pl(x, w, b):
        return jnp.sum(jcs.conv_stem(x, w, b, slope) * cot)

    def loss_xla(x, w, b):
        y = jcs._xla_conv(x, w, b)
        if slope is not None:
            y = jnp.where(y >= 0, y, slope * y)
        return jnp.sum(y * cot)

    args = tuple(map(jnp.asarray, (x, w, b)))
    y = cs.conv_stem_fwd_plain(_t(x), _t(w), _t(b), slope)
    dw, db = cs.conv_stem_dw(_t(x), _t(cot), y, slope)
    dx = cs.conv_stem_dx(_t(cot), _t(w), y, slope)
    assert dw.dtype == db.dtype == torch.float32
    for loss in (loss_pl, loss_xla):
        gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(*args)
        _close(dx, gx, **TOL)
        _close(dw, gw, **TOL_W)
        _close(db, gb, **TOL_W)


def test_conv_stem_mask_counts_zero_output_as_positive():
    # y == 0 exactly: the select passes g unscaled (y >= 0), as
    # terrain_tpu's where(y >= 0, g, slope*g)
    x = torch.zeros(1, 8, 8, 1)
    w = torch.ones(5, 5, 1, 8)
    g = torch.ones(1, 8, 8, 8)
    y = cs.conv_stem_fwd_plain(x, w, torch.zeros(8), 0.2)
    assert float(y.abs().max()) == 0.0
    _, db = cs.conv_stem_dw(x, g, y, 0.2)
    np.testing.assert_array_equal(db.numpy(), np.full(8, 64.0, np.float32))


# ------------------------------------------------------------- conv_thin
@pytest.mark.parametrize("shape,f", [((2, 16, 16, 8), 4),
                                     ((1, 32, 16, 16), 1)])
def test_conv_thin_gradient_ops_match_pallas_grads(shape, f, rng,
                                                   monkeypatch):
    monkeypatch.setattr(jct, "_INTERPRET", True)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], f) * 0.1).astype(np.float32)
    cot = rng.randn(*shape[:3], f).astype(np.float32)
    gx, gw = jax.grad(lambda x, w: jnp.sum(jct.conv_thin(x, w) * cot),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(ct.conv_thin_dx(_t(cot), _t(w)), gx, **TOL)
    dw = ct.conv_thin_dw(_t(x), _t(cot))
    assert dw.dtype == torch.float32
    _close(dw, gw, **TOL_W)


# --------------------------------------------------------- bilinear_conv
@pytest.mark.parametrize("h2,w2", [(4, 4), (4, 6), (10, 6), (16, 32)])
def test_dx_conv6_matches_jax(h2, w2, rng):
    """The port of _dx_conv6 against the original, down to the smallest
    size and at non-square ones (all four border strips differ)."""
    g = rng.randn(2, h2, w2, 8).astype(np.float32)
    w = (rng.randn(3, 3, 4, 8) * 0.1).astype(np.float32)
    want = jbc._dx_conv6(jnp.asarray(g), jnp.asarray(w))
    _close(bc.dx_conv6(_t(g), _t(w)), want, **TOL)
    with pytest.raises(ValueError):
        bc.dx_conv6(_t(g[:, :2]), _t(w))


@pytest.mark.parametrize("shape,f", [((1, 8, 8, 8), 8), ((2, 8, 24, 8), 16)])
def test_bilinear_conv_backward_matches_pallas_grads(shape, f, rng,
                                                     monkeypatch):
    monkeypatch.setattr(jbc, "_INTERPRET", True)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], f) * 0.1).astype(np.float32)
    b = rng.randn(f).astype(np.float32)
    cot = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], f).astype(
        np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jbc.bilinear2x_conv3x3_pallas(*a) * cot),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    args = (_t(x, True), _t(w, True), _t(b, True))
    got = torch.autograd.grad(bc.BilinearConvFn.apply(*args), args, _t(cot))
    for a, q, tol in zip(got, want, (TOL, TOL_W, TOL_W)):
        _close(a, q, **tol)


# ------------------------------------------- the autograd.Functions on CPU
def _fn_cases(rng):
    r = rng.randn
    f32 = np.float32
    return {
        "conv_thin": (ct.ConvThinFn.apply, ct.conv_thin_plain,
                      [r(2, 12, 20, 8), r(3, 3, 8, 3) * 0.1]),
        "conv_stem": (lambda *a: cs.ConvStemFn.apply(*a, None),
                      cs.conv_stem_fwd_plain,
                      [r(2, 12, 20, 1), r(5, 5, 1, 8) * 0.1, r(8)]),
        "conv_stem_leaky": (lambda *a: cs.ConvStemFn.apply(*a, 0.2),
                            lambda *a: cs.conv_stem_fwd_plain(*a, 0.2),
                            [r(2, 12, 20, 1), r(5, 5, 1, 8) * 0.1, r(8)]),
        "bilinear_conv": (bc.BilinearConvFn.apply, bc.bilinear_conv_plain,
                          [r(2, 6, 10, 8), r(3, 3, 8, 16) * 0.1, r(16)]),
    }, f32


@pytest.mark.parametrize("name", ["conv_thin", "conv_stem", "conv_stem_leaky",
                                  "bilinear_conv"])
def test_function_on_cpu_gives_the_plain_versions_gradients(name, rng):
    """No CUDA needed: on CPU tensors each Function's backward runs the
    plain gradient versions, which must equal autograd of the plain
    forward."""
    cases, f32 = _fn_cases(rng)
    fn, plain, arrays = cases[name]
    args = [_t(a.astype(f32), True) for a in arrays]
    y = fn(*args)
    cot = _t(rng.randn(*y.shape).astype(f32))
    got = torch.autograd.grad(y, args, cot)
    want = torch.autograd.grad(plain(*args), args, cot)
    for a, b in zip(got, want):
        _close(a, b.numpy(), **TOL_W)


def test_function_skips_gradients_nobody_needs(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(cs, "conv_stem_dx",
                        lambda *a: calls.append("dx") or
                        cs.conv_stem_dx_plain(*a))
    monkeypatch.setattr(cs, "conv_stem_dw",
                        lambda *a: calls.append("dw") or
                        cs.conv_stem_dw_plain(*a))
    x, w, b, cot = (_t(a) for a in _stem_inputs(rng, (1, 8, 8, 1), 8))
    # generator path: only the input needs a gradient
    xg = x.clone().requires_grad_()
    torch.autograd.grad(cs.ConvStemFn.apply(xg, w, b, 0.2), xg, cot)
    assert calls == ["dx"]
    # discriminator path: only the parameters do
    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
    torch.autograd.grad(cs.ConvStemFn.apply(x, wg, bg, 0.2), (wg, bg), cot)
    assert calls == ["dx", "dw"]


def test_wrappers_raise_off_cpu_off_cuda():
    m = dict(device="meta")
    with pytest.raises(ValueError):
        cs.conv_stem(torch.empty((1, 8, 8, 1), **m),
                     torch.empty((5, 5, 1, 8), **m), torch.empty((8,), **m))
    with pytest.raises(ValueError):
        cs.conv_stem_dw(torch.empty((1, 8, 8, 1), **m),
                        torch.empty((1, 8, 8, 8), **m))
    with pytest.raises(ValueError):
        cs.conv_stem_dx(torch.empty((1, 8, 8, 8), **m),
                        torch.empty((5, 5, 1, 8), **m))
    with pytest.raises(ValueError):
        ct.conv_thin_dx(torch.empty((1, 8, 8, 4), **m),
                        torch.empty((3, 3, 8, 4), **m))
    with pytest.raises(ValueError):
        ct.conv_thin_dw(torch.empty((1, 8, 8, 8), **m),
                        torch.empty((1, 8, 8, 4), **m))
    # a CPU tensor mixed with one elsewhere is refused too
    with pytest.raises(ValueError):
        ct.conv_thin(torch.empty((1, 8, 8, 8)), torch.empty((3, 3, 8, 4), **m))
    for k in (cs.KERNEL_FWD, cs.KERNEL_DW, cs.KERNEL_DX, ct.KERNEL_DX,
              ct.KERNEL_DW):
        assert k.launches == 0


# ------------------------------------------------------------ shape rules
def test_stem_regime_at_the_flagship_and_smoke_shapes():
    w = (5, 5, 1, 64)
    assert cs.supported((8, 512, 512, 1), w, (1, 1), "same")
    assert cs.supported((4, 512, 512, 1), w, 1, "same")
    assert cs.supported((2, 256, 256, 1), (5, 5, 1, 32), (1, 1), "same")
    # the 64px smoke model (k 3) and anything below 256px stay on F.conv2d
    assert not cs.supported((8, 64, 64, 1), (3, 3, 1, 16), (1, 1), "same")
    assert not cs.supported((8, 128, 128, 1), (5, 5, 1, 16), (1, 1), "same")


def test_stem_shape_rule_is_the_jax_guard_without_backend():
    for n, h, w, c, f, k, s, pad in itertools.product(
            (1, 8), (128, 256, 260, 512), (256, 320, 384, 512), (1, 3),
            (8, 12, 64, 520), (3, 5), (1, (1, 1), (2, 2)),
            ("same", "valid")):
        x, wt = (n, h, w, c), (k, k, c, f)
        assert cs.supported(x, wt, s, pad) == jcs.supported(
            x, wt, s, pad, backend="tpu"), (x, wt, s, pad)


# ------------------------------------------- gradients of the plain ops
def _grads_match(torch_fn, jax_fn, arrays, rng, tol=TOL_W):
    args = [_t(a, True) for a in arrays]
    y = torch_fn(*args)
    cot = rng.randn(*y.shape).astype(np.float32)
    got = torch.autograd.grad(y, args, _t(cot))
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot),
                    argnums=tuple(range(len(arrays))))(
                        *map(jnp.asarray, arrays))
    return got, want, tol


def test_conv2d_leaky_in_the_stem_regime_matches_jax_grads(rng):
    """conv2d_leaky at a stem-regime shape: the port takes conv_stem's
    plain version with the fused activation, terrain_tpu (off the TPU) the
    XLA conv and leaky_relu."""
    x = rng.randn(1, 256, 256, 1).astype(np.float32)
    w = (rng.randn(5, 5, 1, 8) * 0.1).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    assert cs.supported(x.shape, w.shape, (1, 1), "same")
    args = [_t(x, True), _t(_oihw(w), True), _t(b, True)]
    y = ops.conv2d_leaky(*args, slope=0.2)
    cot = rng.randn(*y.shape).astype(np.float32)
    gx, gw, gb = torch.autograd.grad(y, args, _t(cot))
    jy = jconv.conv2d_leaky(*map(jnp.asarray, (x, w, b)), slope=0.2)
    jx, jw, jb = jax.grad(
        lambda *a: jnp.sum(jconv.conv2d_leaky(*a, slope=0.2) * cot),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    _close(y, jy, **TOL)
    _close(gx, jx, **TOL)
    # the parameter gradients sum 65536 pixels: atol 5e-3 on values ~100
    _close(gw, _oihw(np.asarray(jw)), rtol=1e-4, atol=5e-3)
    _close(gb, jb, rtol=1e-4, atol=5e-3)


def test_conv2d_leaky_off_regime_matches_jax(rng):
    x = rng.randn(2, 9, 9, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 4) * 0.1).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = jconv.conv2d_leaky(*map(jnp.asarray, (x, w, b)), slope=0.01,
                              stride=2)
    got = ops.conv2d_leaky(_t(x), _t(_oihw(w)), _t(b), slope=0.01, stride=2)
    _close(got, want, **TOL)


def test_max_pool_gradient_and_ties_match_select_and_scatter(rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    # deliberate ties: whole windows of equal values, and pairs
    x[0, 0:2, 0:2, :] = 1.5
    x[1, 2:4, 4:6, 0] = x[1, 2, 5, 0]
    x[1, 4, 0, 1] = x[1, 5, 1, 1] = 9.0
    got, want, _ = _grads_match(ops.max_pool2d, jpool.max_pool2d, [x], rng)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the first element in row-major order takes a tied window's cotangent
    assert got[0][0, 0, 0, 0] != 0 and got[0][0, 0, 1, 0] == 0 \
        and got[0][0, 1, 0, 0] == 0
    _close(ops.max_pool2d(_t(x)), jpool.max_pool2d(jnp.asarray(x)),
           rtol=0, atol=0)


@pytest.mark.parametrize("size", [2, 4])
def test_avg_pool_matches_jax(size, rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    got, want, tol = _grads_match(lambda a: ops.avg_pool2d(a, size),
                                  lambda a: jpool.avg_pool2d(a, size), [x],
                                  rng)
    _close(got[0], want[0], **TOL)
    _close(ops.avg_pool2d(_t(x), size),
           jpool.avg_pool2d(jnp.asarray(x), size), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert ops.avg_pool2d(xb, size).dtype == torch.bfloat16


@pytest.mark.parametrize("k", [3, 5])
def test_upsample2x_nearest_conv_gradients_match_jax(k, rng):
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    w = (rng.randn(k, k, 4, 3) * 0.1).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    # the torch weight is OIHW: differentiate the JAX op w.r.t. HWIO and
    # carry the gradient over
    args = [_t(x, True), _t(_oihw(w), True), _t(b, True)]
    y = ops.upsample2x_nearest_conv(*args)
    cot = rng.randn(*y.shape).astype(np.float32)
    gx, gw, gb = torch.autograd.grad(y, args, _t(cot))
    jx, jw, jb = jax.grad(
        lambda *a: jnp.sum(jfused.upsample2x_nearest_conv(*a) * cot),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    _close(gx, jx, **TOL)
    _close(gw, _oihw(np.asarray(jw)), **TOL_W)
    _close(gb, jb, **TOL_W)


def test_deconv2x2_gradients_match_jax(rng):
    x = rng.randn(2, 5, 5, 4).astype(np.float32)
    w = (rng.randn(2, 2, 4, 3) * 0.1).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    # the port's transposed-conv weight: (I,O,kh,kw), spatially flipped
    wt = np.ascontiguousarray(np.flip(w, (0, 1)).transpose(2, 3, 0, 1))
    args = [_t(x, True), _t(wt, True), _t(b, True)]
    y = ops.deconv2x2(*args)
    cot = rng.randn(*y.shape).astype(np.float32)
    gx, gw, gb = torch.autograd.grad(y, args, _t(cot))
    jx, jw, jb = jax.grad(lambda *a: jnp.sum(jfused.deconv2x2(*a) * cot),
                          argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    _close(y, jfused.deconv2x2(*map(jnp.asarray, (x, w, b))), **TOL)
    _close(gx, jx, **TOL)
    _close(gw, np.flip(np.asarray(jw), (0, 1)).transpose(2, 3, 0, 1), **TOL_W)
    _close(gb, jb, **TOL_W)


def test_batch_norm_train_gradients_and_state_match_jax(rng):
    x = rng.randn(4, 5, 5, 6).astype(np.float32)
    gamma = (0.5 + rng.rand(6)).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    state = {"mean": rng.randn(6).astype(np.float32),
             "inv_std": (0.5 + rng.rand(6)).astype(np.float32)}
    cot = rng.randn(*x.shape).astype(np.float32)

    def jloss(x, gamma, beta):
        y, _ = jnorm.batch_norm(x, {"gamma": gamma, "beta": beta},
                                jax.tree.map(jnp.asarray, state), train=True)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, gamma, beta)))
    bn = ops.BatchNorm(6)
    bn.load_jax({"gamma": gamma, "beta": beta}, state)
    xt = _t(x, True)
    y = bn(xt, train=True, update_stats=True)
    got = torch.autograd.grad(y, (xt, bn.gamma, bn.beta), _t(cot))
    for a, b in zip(got, want):
        _close(a, b, **TOL_W)
    _, new = jnorm.batch_norm(
        jnp.asarray(x), {"gamma": jnp.asarray(gamma),
                         "beta": jnp.asarray(beta)},
        jax.tree.map(jnp.asarray, state), train=True)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.inv_std.numpy(),
                               np.asarray(new["inv_std"]), rtol=1e-5,
                               atol=1e-6)
    # without update_stats the statistics stay
    before = bn.mean.clone()
    bn(xt, train=True)
    assert torch.equal(bn.mean, before)

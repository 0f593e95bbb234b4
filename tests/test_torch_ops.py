"""terrain_tpu_torch ops against terrain_tpu's on the same numpy inputs (CPU,
fp32).  Tolerances: 1e-5 absolute for elementwise ops and BN (both sides
compute in fp32 with the same formula), 1e-4 for convolutions (the two
libraries sum the products in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.ops import activations as jact
from terrain_tpu.ops import conv as jconv
from terrain_tpu.ops import fused as jfused
from terrain_tpu.ops import norm as jnorm
from terrain_tpu.ops import resize as jresize
from terrain_tpu_torch.ops import activations, conv, fused, norm, resize
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oihw(w):
    return _t(np.transpose(w, (3, 2, 0, 1)))


def _deconv_w(w):
    """HWIO -> the port's flipped (I, O, kh, kw)."""
    return _t(np.flip(w, (0, 1)).transpose(2, 3, 0, 1))


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_lasagne_bn(train, rng):
    x = rng.randn(4, 5, 5, 6).astype(np.float32) * 2 + 1
    gamma = rng.rand(6).astype(np.float32) + 0.5
    beta = rng.randn(6).astype(np.float32)
    mean = rng.randn(6).astype(np.float32)
    inv_std = rng.rand(6).astype(np.float32) + 0.5
    want, wstate = jnorm.batch_norm(
        jnp.asarray(x), {"gamma": gamma, "beta": beta},
        {"mean": mean, "inv_std": inv_std}, train=train)
    got, (gmean, ginv) = norm.batch_norm(
        _t(x), _t(gamma), _t(beta), _t(mean), _t(inv_std), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gmean.numpy(), np.asarray(wstate["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(ginv.numpy(), np.asarray(wstate["inv_std"]),
                               atol=1e-6)
    # the module reads the running stats and never writes them
    bn = norm.BatchNorm(6)
    bn.load_jax({"gamma": gamma, "beta": beta},
                {"mean": mean, "inv_std": inv_std})
    np.testing.assert_allclose(bn(_t(x), train).detach().numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(bn.mean.numpy(), mean)


def test_bn_over_dense_features(rng):
    x = rng.randn(3, 10).astype(np.float32)
    p = {"gamma": np.ones(10, np.float32), "beta": np.zeros(10, np.float32)}
    s = {"mean": np.zeros(10, np.float32), "inv_std": np.ones(10, np.float32)}
    want, _ = jnorm.batch_norm(jnp.asarray(x), p, s, train=True)
    got, _ = norm.batch_norm(_t(x), *map(_t, (p["gamma"], p["beta"],
                                               s["mean"], s["inv_std"])),
                             train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_leaky_relu(slope, rng):
    x = rng.randn(2, 4, 4, 3).astype(np.float32)
    np.testing.assert_allclose(
        activations.leaky_relu(_t(x), slope).numpy(),
        np.asarray(jact.leaky_relu(jnp.asarray(x), slope)), atol=1e-7)
    for name in ("linear", "relu", "sigmoid", "tanh", "leaky_rectify"):
        np.testing.assert_allclose(
            activations.get_activation(name)(_t(x)).numpy(),
            np.asarray(jact.get_activation(name)(jnp.asarray(x))),
            atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get_activation("nope")


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 8, 8, 2)])
def test_upsample_nearest_and_bilinear(shape, rng):
    x = rng.randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        resize.upsample_nearest_2x(_t(x)).numpy(),
        np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_allclose(
        resize.upsample_bilinear_2x(_t(x)).numpy(),
        np.asarray(jresize.upsample_bilinear_2x(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("hw,k,stride,padding", [
    (8, 3, 2, "same"),    # even input, stride 2: Lasagne symmetric padding
    (9, 3, 2, "same"),    # odd input, stride 2
    (8, 5, 1, "same"),
    (2, 2, 1, "valid"),   # the U-Net bottleneck
])
def test_conv2d(hw, k, stride, padding, rng):
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 5).astype(np.float32) * 0.3
    b = rng.randn(5).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, padding=padding)
    got = conv.conv2d(_t(x), _oihw(w), _t(b), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("hw,stride", [(1, 1), (3, 1), (4, 2)])
def test_conv2d_transpose_flip(hw, stride, rng):
    x = rng.randn(2, hw, hw, 6).astype(np.float32)
    w = rng.randn(2, 2, 6, 4).astype(np.float32) * 0.3
    b = rng.randn(4).astype(np.float32)
    want = jconv.conv2d_transpose(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=stride)
    got = conv.conv2d_transpose(_t(x), _deconv_w(w), _t(b), stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_dense(rng):
    x = rng.randn(3, 7).astype(np.float32)
    w = rng.randn(7, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = jconv.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = conv.dense(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("k", [3, 5])
def test_upsample2x_nearest_conv(k, rng):
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    w = rng.randn(k, k, 4, 3).astype(np.float32) * 0.2
    b = rng.randn(3).astype(np.float32)
    want = jfused.upsample2x_nearest_conv(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b))
    got = fused.upsample2x_nearest_conv(_t(x), _oihw(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
    # and it is exactly the unfused upsample -> conv
    unfused = conv.conv2d(resize.upsample_nearest_2x(_t(x)), _oihw(w), _t(b))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **CONV_TOL)


def test_bilinear2x_conv3x3_composite(rng):
    # off the kernel's regime (H < 32): the plain composite on both sides
    x = rng.randn(1, 8, 6, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 8).astype(np.float32) * 0.2
    b = rng.randn(8).astype(np.float32)
    want = jfused.bilinear2x_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    got = fused.bilinear2x_conv3x3(_t(x), _oihw(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


# the deterministic formulations of the upsamples against the library ops
# they replace: a ragged shape, and 1- and 2-pixel extents where every
# bilinear tap is edge-clamped
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (3, 1, 2, 4), (1, 2, 1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deterministic_upsamples_match_the_library_ops(shape, dtype, rng):
    import torch.nn.functional as F

    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(shape[0], 2 * shape[1], 2 * shape[2],
                                   shape[3]).astype(np.float32)).to(dtype)

    def library(v, kind):
        if kind == "nearest":
            return v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        vf = v.float() if kind == "bilinear" else v
        up = F.interpolate(vf.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear", align_corners=False)
        return up.permute(0, 2, 3, 1).to(v.dtype)

    ops = {"nearest": resize.upsample_nearest_2x,
           "bilinear": resize.upsample_bilinear_2x,
           "lowp": resize.upsample_bilinear_2x_lowp}
    for kind, op in ops.items():
        got, want = [], []
        for fn, out in ((op, got), (lambda v: library(v, kind), want)):
            xv = x.clone().requires_grad_(True)
            y = fn(xv)
            (dx,) = torch.autograd.grad(y, xv, g)
            out += [y.detach().float(), dx.float()]
        assert got[0].dtype == want[0].dtype
        assert torch.equal(got[0], want[0]), kind  # the same forward
        # the adjoint sums up to 16 taps (4 for the nearest) in another
        # order, in fp32; in bf16 the library's nearest backward rounds
        # after each add: one bf16 rounding of the largest entry (2^-7)
        rel = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(
            got[1].numpy(), want[1].numpy(), rtol=0,
            atol=rel * float(want[1].abs().max()), err_msg=kind)

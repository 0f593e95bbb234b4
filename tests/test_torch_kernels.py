"""The CUDA kernels' plain versions against terrain_tpu's Pallas kernels run
in interpret mode (as tests/test_pallas.py runs them), and the kernels'
shape rules at the flagship shapes.  The CUDA kernels themselves run only
on the card: chip_smoke.py holds them against these plain versions there.

Tolerance 1e-4 (rtol and atol), fp32: both sides sum the same products in
different orders."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.ops.pallas import bilinear_conv as jbc
from terrain_tpu.ops.pallas import conv_thin as jct
from terrain_tpu_torch.ops import conv, fused
from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
from terrain_tpu_torch.ops.kernels import conv_thin as ct
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,f", [((2, 16, 16, 8), 4),
                                     ((1, 32, 16, 32), 8)])
def test_conv_thin_plain_matches_pallas(shape, f, rng, monkeypatch):
    monkeypatch.setattr(jct, "_INTERPRET", True)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], f) * 0.1).astype(np.float32)
    want = jct.conv_thin(jnp.asarray(x), jnp.asarray(w))
    got = ct.conv_thin(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,f", [((1, 16, 16, 8), 8),
                                     ((2, 32, 48, 8), 16)])
def test_bilinear_conv_plain_matches_pallas(shape, f, rng, monkeypatch):
    monkeypatch.setattr(jbc, "_INTERPRET", True)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], f) * 0.1).astype(np.float32)
    b = rng.randn(f).astype(np.float32)
    want = jbc.bilinear2x_conv3x3_pallas(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))
    got = bc.bilinear_conv(*map(torch.from_numpy, (x, w, b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flagship_shapes_are_in_regime():
    for n in (1, 2, 4, 8):  # every server bucket, n <= 4 gate dropped
        assert ct.supported((n, 256, 256, 64), (3, 3, 64, 4), (1, 1), "same")
        assert bc.supported((n, 64, 64, 512), (3, 3, 512, 128))
        assert bc.supported((n, 128, 128, 256), (3, 3, 256, 64))
        # decoder stages j=4,5 stay on the plain composite
        assert not bc.supported((n, 16, 16, 1024), (3, 3, 1024, 512))
        assert not bc.supported((n, 32, 32, 1024), (3, 3, 1024, 256))
    assert not ct.supported((4, 256, 256, 64), (3, 3, 64, 64), (1, 1), "same")
    assert not ct.supported((4, 256, 256, 64), (3, 3, 64, 4), (2, 2), "same")
    assert not ct.supported((4, 256, 256, 64), (5, 5, 64, 4), (1, 1), "same")
    assert not ct.supported((4, 256, 200, 64), (3, 3, 64, 4), (1, 1), "same")


def test_shape_rules_are_the_jax_guards_without_backend():
    for n, h, w, c, f in itertools.product(
            (1, 4, 8), (16, 32, 64, 96, 256), (32, 128, 256, 1152),
            (8, 24, 64, 128, 512), (4, 8, 64, 128, 1024)):
        x, wt = (n, h, w, c), (3, 3, c, f)
        assert bc.supported(x, wt) == jbc.supported(x, wt, backend="tpu")
        j = jct.supported(x, wt, (1, 1), "same", backend="tpu")
        p = ct.supported(x, wt, (1, 1), "same")
        assert p == j or (n > 4 and p and not j)


def test_cpu_dispatch_in_regime_runs_the_plain_versions(rng):
    # conv2d with a conv_thin-regime shape: the plain version, the same
    # numbers as the generic conv path
    x = torch.from_numpy(rng.randn(1, 64, 128, 8).astype(np.float32))
    w = torch.from_numpy((rng.randn(4, 8, 3, 3) * 0.1).astype(np.float32))
    assert ct.supported(tuple(x.shape), (3, 3, 8, 4), (1, 1), "same")
    got = conv.conv2d(x, w)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               **TOL)
    xb = torch.from_numpy(rng.randn(1, 32, 32, 8).astype(np.float32))
    wb = torch.from_numpy((rng.randn(8, 8, 3, 3) * 0.1).astype(np.float32))
    bb = torch.from_numpy(rng.randn(8).astype(np.float32))
    assert bc.supported(tuple(xb.shape), (3, 3, 8, 8))
    got = fused.bilinear2x_conv3x3(xb, wb, bb)
    want = conv.conv2d(
        torch.nn.functional.interpolate(
            xb.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1), wb, bb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wrappers_raise_off_cpu_without_a_kernel():
    # a tensor that is neither on the CPU nor on the card: no fallback
    x = torch.empty((1, 64, 128, 8), device="meta")
    with pytest.raises(ValueError):
        ct.conv_thin(x, torch.empty((3, 3, 8, 4), device="meta"))
    with pytest.raises(ValueError):
        bc.bilinear_conv(x, torch.empty((3, 3, 8, 8), device="meta"),
                         torch.empty((8,), device="meta"))
    # the row stream's guards: C a multiple of 8, x 16-byte aligned
    with pytest.raises(ValueError, match="multiple of 8"):
        ct.check_stream("conv_thin", torch.empty((1, 64, 128, 12),
                                                 device="meta"))
    flat = torch.empty(4 + 64 * 128 * 8, device="meta")
    with pytest.raises(ValueError, match="offset 4 mod 16"):
        ct.check_stream("conv_thin", flat[1:-3].view(1, 64, 128, 8))
    ct.check_stream("conv_thin", flat[4:].view(1, 64, 128, 8))
    for xs in (torch.empty((1, 64, 128, 12), device="meta"),
               flat[1:-3].view(1, 64, 128, 8)):
        with pytest.raises(ValueError):
            ct.conv_thin(xs, torch.empty((3, 3, xs.shape[3], 4),
                                         device="meta"))
    assert ct.KERNEL.launches == 0 and bc.KERNEL.launches == 0


@pytest.mark.parametrize("n,h,w,blocks", [
    (4, 256, 256, 264), (4, 256, 256, 132),   # main shape, 2 / 1 an SM
    (8, 256, 256, 264),                       # the served bucket 8
    (2, 64, 200, 264), (3, 37, 45, 264),      # W ragged, below one strip
    (1, 48, 130, 132), (1, 3, 7, 264)])       # more blocks than rows
def test_row_stream_walk_covers_every_output_once(n, h, w, blocks):
    strips, grid, share = ct.walk(n, h, w, blocks)
    assert grid <= blocks and grid * share >= n * strips * h
    seen = np.zeros((n, strips, h), np.int64)
    for b in range(grid):  # block b's share, as the kernels' RowCursor
        for lin in range(b * share, min((b + 1) * share, n * strips * h)):
            ns, r = divmod(lin, h)
            seen[ns // strips, ns % strips, r] += 1
    assert (seen == 1).all()
    # the strips' output columns tile [0, w) once
    cols = np.zeros(strips * ct.SW, np.int64)
    for s in range(strips):
        cols[s * ct.SW:(s + 1) * ct.SW] += 1
    assert (cols[:w] == 1).all() and strips * ct.SW - w < ct.SW

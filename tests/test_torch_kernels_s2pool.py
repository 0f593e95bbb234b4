"""terrain_tpu_torch's pool2 and conv_s2 ops against terrain_tpu's Pallas
kernels run in interpret mode (as tests/test_pallas.py runs them) on the
CPU.  The CUDA kernels themselves run only on the card: chip_smoke.py holds
them against the plain versions tested here.

Inputs come from numpy with a seed and go to both packages.  pool2 moves
values and never computes one, so it is held exactly, in fp32 and bf16,
deliberate ties included.  conv_s2: fp32 1e-4 (rtol and atol; weight
gradients sum over every pixel and get atol 1e-3, as in tests/test_pallas.py);
bf16 2e-2 of the reference's largest entry (both sides round an fp32 sum to
bf16)."""

import itertools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.ops import pool as jpool
from terrain_tpu.ops.pallas import conv_s2 as jc2
from terrain_tpu.ops.pallas import pool2 as jp2
from terrain_tpu_torch import ops
from terrain_tpu_torch.ops.kernels import conv_s2 as c2
from terrain_tpu_torch.ops.kernels import pool2 as p2
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_W = dict(rtol=1e-4, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


# ----------------------------------------------------------------- pool2
def _pool_inputs(rng, shape, dtype, ties):
    n, h, w, c = shape
    x = rng.randn(*shape).astype(np.float32)
    if ties:
        # few distinct values: most windows hold a tie of some kind
        x = np.round(x * 1.5) / 2.0
    cot = rng.randn(n, h // 2, w // 2, c).astype(np.float32)
    # round through the working type once, so both packages see equal bits
    x = _f32(jnp.asarray(x).astype(JDT[dtype]))
    cot = _f32(jnp.asarray(cot).astype(JDT[dtype]))
    return x, cot


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 8), (2, 8, 48, 16)])
def test_pool2_matches_pallas_exactly(shape, dtype, ties, rng, monkeypatch):
    assert p2.supported(shape)
    monkeypatch.setattr(jp2, "_INTERPRET", True)
    x, cot = _pool_inputs(rng, shape, dtype, ties)
    jx, jcot = (jnp.asarray(a).astype(JDT[dtype]) for a in (x, cot))
    want = jp2.max_pool2_pallas(jx)
    want_dx = jax.grad(lambda a: jnp.sum(
        (jp2.max_pool2_pallas(a) * jcot).astype(jnp.float32)))(jx)
    tx = _to_torch(x, dtype).requires_grad_()
    got = p2.max_pool2(tx)
    assert got.dtype == TDT[dtype] and got.grad_fn is not None
    np.testing.assert_array_equal(_tnp(got), _f32(want))
    (dx,) = torch.autograd.grad(got, tx, _to_torch(cot, dtype))
    assert dx.dtype == TDT[dtype]
    np.testing.assert_array_equal(_tnp(dx), _f32(want_dx))
    # the primitives alone give the same
    np.testing.assert_array_equal(
        _tnp(p2.pool2_bwd(tx.detach(), _to_torch(cot, dtype))), _f32(want_dx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool2_whole_window_ties_go_to_the_first_element(dtype):
    x = torch.ones(1, 8, 16, 8, dtype=TDT[dtype], requires_grad=True)
    (g,) = torch.autograd.grad(p2.max_pool2(x).float().sum(), x)
    g = g.float().numpy()
    np.testing.assert_array_equal(g[0, 0::2, 0::2], 1.0)
    assert g.sum() == 4 * 8 * 8
    # row tie with the maximum in the odd column of both rows: the even row
    # wins, and in it the odd column
    w = torch.tensor([[0.0, 2.0], [1.0, 2.0]]).reshape(1, 2, 2, 1)
    w = w.repeat(1, 4, 8, 8).to(TDT[dtype])
    dx = p2.pool2_bwd(w, torch.ones(1, 4, 8, 8, dtype=TDT[dtype]))
    np.testing.assert_array_equal(dx.float().numpy()[0, :2, :2, 0],
                                  [[0.0, 1.0], [0.0, 0.0]])


def test_pool2_matches_the_library_pool_without_nan(rng):
    import torch.nn.functional as F

    x = torch.from_numpy(rng.randn(2, 8, 16, 8).astype(np.float32))
    x = (x * 2).round() / 2  # ties
    x.requires_grad_()
    cot = torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32))
    lib = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(p2.max_pool2(x).detach().numpy(),
                                  lib.detach().numpy())
    np.testing.assert_array_equal(
        torch.autograd.grad(p2.max_pool2(x), x, cot)[0].numpy(),
        torch.autograd.grad(lib, x, cot)[0].numpy())
    # a NaN goes through the forward
    y = x.detach().clone()
    y[0, 0, 0, 0] = float("nan")
    assert torch.isnan(p2.pool2_fwd(y)[0, 0, 0, 0])


_POOL_GRID = [(n, h, w, c) for n, h, w, c in itertools.product(
    (1, 4), (4, 8, 14, 15, 16, 512), (8, 16, 24, 30, 512),
    (4, 8, 64, 256, 512, 520))]


def test_pool2_supported_equals_the_jax_guard():
    for shape in _POOL_GRID + [(4, 16, 16), (8, 512, 512, 64),
                               (4, 8, 8, 256), (4, 4096, 512, 512)]:
        assert p2.supported(shape) == jp2.supported(shape, backend="tpu"), \
            shape
    assert p2.supported((8, 512, 512, 64)) and not p2.supported((4, 8, 8, 256))


def test_max_pool2d_dispatch_follows_the_switch(rng, monkeypatch):
    x = torch.from_numpy(rng.randn(1, 16, 16, 8).astype(np.float32))
    monkeypatch.delenv("TERRAIN_POOL_VJP", raising=False)
    before = p2.PLAIN.calls
    ref = ops.max_pool2d(x, 2)
    assert p2.PLAIN.calls == before            # off: the library pool
    monkeypatch.setenv("TERRAIN_POOL_VJP", "pallas")
    got = ops.max_pool2d(x.clone().requires_grad_(), 2)
    assert p2.PLAIN.calls == before + 1        # on: the op's Function
    assert type(got.grad_fn).__name__ == "Pool2FnBackward"
    np.testing.assert_array_equal(got.detach().numpy(), ref.numpy())
    # off the regime (w/2 not a multiple of 8) and other windows: library
    for t, size in ((torch.rand(1, 16, 8, 8), 2), (torch.rand(1, 16, 16, 8), 4)):
        ops.max_pool2d(t, size)
    assert p2.PLAIN.calls == before + 1
    for mode, fn in (("lanes", "LanesPoolBackward"),
                     ("dense", "DensePoolBackward")):
        monkeypatch.setenv("TERRAIN_POOL_VJP", mode)
        got = ops.max_pool2d(x.clone().requires_grad_(), 2)
        assert type(got.grad_fn).__name__ == fn
        np.testing.assert_array_equal(got.detach().numpy(), ref.numpy())
    assert p2.PLAIN.calls == before + 1        # pool2 is not on these paths


# ------------------------------------------------- TERRAIN_POOL_VJP=lanes|dense
def _jax_alt_pool(mode, size):
    if mode == "lanes":
        return jpool._max_pool2d_lanes
    return lambda a: jpool._max_pool2d_nonoverlap(a, size)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,size", [("lanes", 2), ("dense", 2),
                                       ("dense", 4)])
def test_lanes_and_dense_match_terrain_tpu_exactly(mode, size, dtype, ties,
                                                   rng, monkeypatch):
    """The forward and the gradient of terrain_tpu's custom-VJP pools
    (terrain_tpu/ops/pool.py `_max_pool2d_lanes`,
    `_max_pool2d_nonoverlap`), bit for bit, through ops.max_pool2d."""
    monkeypatch.setenv("TERRAIN_POOL_VJP", mode)
    n, h, w, c = 2, 8, 16, 8
    x = rng.randn(n, h, w, c).astype(np.float32)
    if ties:
        x = np.round(x * 1.5) / 2.0
    cot = rng.randn(n, h // size, w // size, c).astype(np.float32)
    x, cot = (_f32(jnp.asarray(a).astype(JDT[dtype])) for a in (x, cot))
    jx, jcot = (jnp.asarray(a).astype(JDT[dtype]) for a in (x, cot))
    want, vjp = jax.vjp(_jax_alt_pool(mode, size), jx)
    (want_dx,) = vjp(jcot)
    tx = _to_torch(x, dtype).requires_grad_()
    got = ops.max_pool2d(tx, size)
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(_tnp(got), _f32(want))
    (dx,) = torch.autograd.grad(got, tx, _to_torch(cot, dtype))
    assert dx.dtype == TDT[dtype]
    np.testing.assert_array_equal(_tnp(dx), _f32(want_dx))


@pytest.mark.parametrize("mode", ["lanes", "dense", "sas"])
def test_pool_ties_route_the_cotangent_as_terrain_tpu_does(mode,
                                                           monkeypatch):
    """A window of four equal values: lanes and the library pool send the
    cotangent to its first element, dense splits it in four; a window
    whose maximum ties in its odd column of both rows: the even row's."""
    monkeypatch.setenv("TERRAIN_POOL_VJP", mode)
    x = torch.tensor([[1.0, 1.0, 0.0, 2.0],
                      [1.0, 1.0, 1.0, 2.0]]).reshape(1, 2, 4, 1)
    x = x.repeat(1, 1, 1, 8).requires_grad_()
    (dx,) = torch.autograd.grad(ops.max_pool2d(x, 2),
                                x, torch.full((1, 1, 2, 8), 4.0))
    want = {"dense": [[1.0, 1.0, 0.0, 2.0], [1.0, 1.0, 0.0, 2.0]]}.get(
        mode, [[4.0, 0.0, 0.0, 4.0], [0.0, 0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(dx[0, :, :, 0].numpy(), want)
    if mode != "sas":
        jdx = jax.grad(lambda a: jnp.sum(
            _jax_alt_pool(mode, 2)(a) * 4.0))(jnp.asarray(x.detach().numpy()))
        np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))


def test_lanes_and_dense_take_only_their_regime(monkeypatch):
    """As in terrain_tpu: lanes only a 2x2 window, dense any size of
    stride == size, both only floating x with H and W divisible by the
    size; a slab takes the whole image's regime (`route_shape`)."""
    for mode in ("lanes", "dense"):
        monkeypatch.setenv("TERRAIN_POOL_VJP", mode)
        for t, size, stride in ((torch.rand(1, 6, 8, 2), 4, None),
                                (torch.rand(1, 8, 8, 2), 2, 1),
                                (torch.rand(1, 5, 8, 2), 2, None)):
            y = ops.max_pool2d(t.requires_grad_(), size, stride)
            assert type(y.grad_fn).__name__ == "PermuteBackward0"
        y = ops.max_pool2d(torch.rand(1, 8, 8, 2).requires_grad_(), 4)
        assert type(y.grad_fn).__name__ == (
            "DensePoolBackward" if mode == "dense" else "PermuteBackward0")
        y = ops.max_pool2d(torch.rand(1, 4, 8, 2).requires_grad_(), 2,
                           route_shape=(1, 8, 8, 2))
        assert type(y.grad_fn).__name__ != "PermuteBackward0"


# --------------------------------------------------------------- conv_s2
def _s2_inputs(rng, shape, f):
    n, h, w, cin = shape
    x = rng.randn(*shape).astype(np.float32)
    wt = (rng.randn(3, 3, cin, f) * 0.2).astype(np.float32)
    b = rng.randn(f).astype(np.float32)
    cot = rng.randn(n, h // 2, w // 2, f).astype(np.float32)
    return x, wt, b, cot


def _jax_s2_grads(x, wt, b, cot, slope, dt):
    jx, jw, jcot = (jnp.asarray(a).astype(dt) for a in (x, wt, cot))
    jb = jnp.asarray(b)
    y = jc2.conv_s2(jx, jw, jb, slope)
    # terrain_tpu returns db in x's dtype; take the gradients one by one in
    # fp32 through a loss that casts, as a train step's loss does
    gx, gw = jax.grad(lambda xx, ww: jnp.sum(
        (jc2.conv_s2(xx, ww, jb, slope) * jcot).astype(jnp.float32)),
        argnums=(0, 1))(jx, jw)
    return y, gx, gw


@pytest.mark.parametrize("slope", [None, 0.01], ids=["linear", "leaky"])
@pytest.mark.parametrize("cin", [1, 2, 4])
def test_conv_s2_matches_pallas_fp32(cin, slope, rng, monkeypatch):
    monkeypatch.setattr(jc2, "_INTERPRET", True)
    x, wt, b, cot = _s2_inputs(rng, (2, 16, 32, cin), 8)
    want, gx, gw = _jax_s2_grads(x, wt, b, cot, slope, jnp.float32)
    # db from the XLA conv: terrain_tpu's own bwd rule casts db to x.dtype
    gb = jax.grad(lambda bb: jnp.sum(_leaky(jc2._xla_conv(
        jnp.asarray(x), jnp.asarray(wt), bb), slope) * cot))(jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, b))
    got = c2.conv_s2(tx, tw, tb, slope)
    assert got.dtype == torch.float32
    assert type(got.grad_fn).__name__ == "ConvS2FnBackward"
    np.testing.assert_allclose(_tnp(got), _f32(want), **TOL)
    dx, dw, db = torch.autograd.grad(got, (tx, tw, tb), torch.from_numpy(cot))
    np.testing.assert_allclose(_tnp(dx), _f32(gx), **TOL)
    np.testing.assert_allclose(_tnp(dw), _f32(gw), **TOL_W)
    np.testing.assert_allclose(_tnp(db), _f32(gb), **TOL_W)
    # the dW primitive takes the RAW cotangent and the saved output
    dw2, db2 = c2.conv_s2_dw(tx.detach(), torch.from_numpy(cot),
                             got.detach(), slope)
    assert dw2.dtype == db2.dtype == torch.float32
    np.testing.assert_array_equal(dw2.numpy(), dw.numpy())
    np.testing.assert_array_equal(db2.numpy(), db.numpy())


def _leaky(y, slope):
    return y if slope is None else jnp.maximum(y, slope * y)


@pytest.mark.parametrize("slope", [None, 0.01], ids=["linear", "leaky"])
@pytest.mark.parametrize("cin", [1, 4])
def test_conv_s2_matches_pallas_bf16(cin, slope, rng, monkeypatch):
    monkeypatch.setattr(jc2, "_INTERPRET", True)
    x, wt, b, cot = _s2_inputs(rng, (1, 16, 32, cin), 8)
    want, gx, gw = _jax_s2_grads(x, wt, b, cot, slope, jnp.bfloat16)
    bf = torch.bfloat16
    tx, tw = (torch.from_numpy(a).to(bf).requires_grad_() for a in (x, wt))
    tb = torch.from_numpy(b).requires_grad_()
    got = c2.conv_s2(tx, tw, tb, slope)
    assert got.dtype == bf
    dx, dw, db = torch.autograd.grad(got, (tx, tw, tb),
                                     torch.from_numpy(cot).to(bf))
    assert dx.dtype == bf and dw.dtype == bf and db.dtype == torch.float32
    for a, ref in ((got, want), (dx, gx), (dw, gw)):
        ref = _f32(ref)
        np.testing.assert_allclose(_tnp(a), ref, rtol=0,
                                   atol=2e-2 * np.abs(ref).max())


def test_conv_s2_pads_one_on_both_sides(rng):
    """Output row y taps rows 2y-1..2y+1 (Lasagne 'same'), not the
    low/high split of a framework's string 'same' at stride 2."""
    import torch.nn.functional as F

    x, wt, b, _ = _s2_inputs(rng, (1, 8, 16, 2), 8)
    got = c2.conv_s2_fwd(*(torch.from_numpy(a) for a in (x, wt, b)))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = F.conv2d(torch.from_numpy(xp).permute(0, 3, 1, 2),
                    torch.from_numpy(wt).permute(3, 2, 0, 1),
                    torch.from_numpy(b), stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_conv_s2_skips_gradients_nobody_needs(rng):
    x, wt, b, cot = _s2_inputs(rng, (1, 16, 32, 4), 8)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, b))
    calls = c2.PLAIN.calls
    y = c2.conv_s2(tx.clone().requires_grad_(), tw, tb, 0.01)  # dX only
    y.backward(torch.from_numpy(cot))
    assert c2.PLAIN.calls == calls + 1          # forward; dX is no primitive
    y = c2.conv_s2(tx, tw.clone().requires_grad_(), tb, 0.01)  # dW only
    y.backward(torch.from_numpy(cot))
    assert c2.PLAIN.calls == calls + 3          # forward and dW+db


_S2_GRID = [((n, h, w, c), (k, k, ci, f), s, p)
            for n, h, w, c, k, ci, f, s, p in itertools.product(
                (4,), (32, 64, 72, 80, 512), (128, 256, 260, 512), (1, 2, 3, 4),
                (3, 5), (1, 4), (8, 12, 64, 512, 520), ((2, 2), (1, 1)),
                ("same", "valid"))]


def test_conv_s2_supported_equals_the_jax_guard():
    n_true = 0
    for xs, ws, s, p in _S2_GRID:
        want = jc2.supported(xs, ws, s, p, backend="tpu")
        assert c2.supported(xs, ws, s, p) == want, (xs, ws, s, p)
        n_true += want
    assert n_true > 0
    assert c2.supported((4, 512, 512, 1), (3, 3, 1, 64), (2, 2), "same")
    assert c2.supported((8, 512, 512, 4), (3, 3, 4, 64), (2, 2), "same")
    assert not c2.supported((4, 256, 256, 64), (3, 3, 64, 128), (2, 2), "same")


def _dw_tiles(n, h, w, f):
    """dW+db's tiles as csrc/conv_s2.cu lays them out (`dw_tile_px` and the
    launcher's `tiles_w`), with DW_TPMAX and DW_ELEMS read from that source:
    (tp, tiles_w, ntiles, elems), tile t being output row t // tiles_w
    (image-major over the n * h/2 rows), pixels (t % tiles_w) * tp .. of it,
    up to tp of them; block b takes the tiles b, b + gridDim.x, ..."""
    src = (pathlib.Path(c2.__file__).parent / "csrc" / "conv_s2.cu").read_text()
    tpmax, elems = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
                    for name in ("DW_TPMAX", "DW_ELEMS"))
    for line in ("return f * DW_TPMAX <= DW_ELEMS ? DW_TPMAX : DW_ELEMS / f;",
                 "tiles_w = (wd / 2 + dw_tile_px(f) - 1) / dw_tile_px(f);",
                 "const int t = blockIdx.x + k * gridDim.x;"):
        assert line in src, line
    tp = tpmax if f * tpmax <= elems else elems // f
    tiles_w = -(-(w // 2) // tp)
    return tp, tiles_w, n * (h // 2) * tiles_w, elems


@pytest.mark.parametrize("n,h,w,f,blocks", [
    (8, 512, 512, 64, 132), (4, 512, 512, 64, 132),  # the main path's two
    (2, 64, 200, 64, 132),    # W/2 = 100: a short last tile a row
    (2, 64, 256, 128, 132),   # F = 128: 32-pixel tiles
    (1, 64, 256, 8, 132),     # 64 tiles, fewer than blocks
    (1, 8, 24, 512, 5)])      # F = 512: 8-pixel tiles, a ragged share
def test_conv_s2_dw_tile_walk_covers_every_output_once(n, h, w, f, blocks):
    """dW+db's walk (csrc/conv_s2.cu s2_dw_kernel: block b takes the tiles
    b, b + blocks, ...): every output pixel of every image in exactly one
    tile of exactly one block, each tile a whole number of 16-byte pieces
    of g within a stage's DW_ELEMS values."""
    tp, tiles_w, ntiles, elems = _dw_tiles(n, h, w, f)
    ho, wo = h // 2, w // 2
    seen = np.zeros((n, ho, wo), np.int64)
    for b in range(blocks):
        for t in range(b, ntiles, blocks):
            r, c = divmod(t, tiles_w)
            ox0 = c * tp
            assert 0 <= ox0 < wo
            npx = min(tp, wo - ox0)
            assert npx * f <= elems and npx * f * 2 % 16 == 0
            seen[r // ho, r % ho, ox0:ox0 + npx] += 1
    assert (seen == 1).all()


def test_conv_s2_dw_raises_on_unaligned_g_or_y():
    """The bulk copies of dW+db's tiles need g and y 16-byte aligned."""
    flat = torch.empty(4 + 2 * 8 * 64, device="meta")
    good = flat[4:].view(1, 2, 8, 64)
    bad = flat[1:-3].view(1, 2, 8, 64)
    c2.check_dw_aligned((good, good))
    for ts in ((bad, good), (good, bad), (bad,)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            c2.check_dw_aligned(ts)
    assert c2.KERNEL_DW.launches == 0


@pytest.mark.parametrize("leaky", [False, True], ids=["conv2d", "conv2d_leaky"])
def test_conv2d_dispatch_follows_the_switch(leaky, rng, monkeypatch):
    x, wt, b, _ = _s2_inputs(rng, (1, 64, 256, 1), 8)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    tb = torch.from_numpy(b)

    def run(t):
        if leaky:
            return ops.conv2d_leaky(t, tw, tb, slope=0.01, stride=2)
        return ops.conv2d(t, tw, tb, stride=2)

    monkeypatch.delenv("TERRAIN_PALLAS_CONVS2", raising=False)
    before = c2.PLAIN.calls
    ref = run(tx)
    assert c2.PLAIN.calls == before             # off: the library conv
    monkeypatch.setenv("TERRAIN_PALLAS_CONVS2", "1")
    got = run(tx.clone().requires_grad_())
    assert c2.PLAIN.calls == before + 1         # on: the op's Function
    assert type(got.grad_fn).__name__ == "ConvS2FnBackward"
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), **TOL)
    # off the regime (narrow image): the library conv, switch or not
    run(tx[:, :, :64])
    assert c2.PLAIN.calls == before + 1

"""terrain_tpu_torch's data layer against terrain_tpu's on the CPU: the
host iterator and epoch schedule (equal orders for equal seeds), synthetic
pairs (equal bytes), the device-resident dataset's gather + normalize, and
the paired augmentation with the angle and flips passed in.

Tolerance of the augmentation: 1e-5 absolute on images in [0,1] / [-1,1]
(the same fp32 formulas; sin/cos/tan and the fused multiply-adds may differ
in the last bit, and a coordinate one ulp across an integer moves a tap by
one pixel while the interpolated value stays continuous).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.data import augment as jaug
from terrain_tpu.data import device_cache as jdc
from terrain_tpu.data import hdf5 as jh5
from terrain_tpu.data import synthetic as jsyn
from terrain_tpu_torch import experiments
from terrain_tpu_torch.data import DeviceDataset, augment, hdf5, synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

AUG_TOL = dict(rtol=0, atol=1e-5)


def test_normalize_pair_matches_jax(rng):
    x = rng.randint(0, 256, (3, 8, 8, 1)).astype(np.uint8)
    y = rng.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    for ga, gb, u8 in ((True, False, True), (False, True, True),
                       (True, False, False)):
        got = hdf5.normalize_pair(x, y, ga, gb, u8)
        want = jh5.normalize_pair(x, y, ga, gb, u8)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,bs", [(16, 4), (10, 4), (3, 4)])
def test_epoch_index_schedule_matches_jax(n, bs):
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    assert ([s for s in hdf5.get_slices(n, bs)]
            == [s for s in jh5.get_slices(n, bs)])
    for _ in range(3):  # three epochs off one stream
        got = hdf5.epoch_index_schedule(n, bs, r1)
        want = jh5.epoch_index_schedule(n, bs, r2)
        assert len(got) == len(want) == n // bs
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_hdf5_iterator_order_matches_jax():
    x, y = synthetic.make_pairs(10, 16, seed=2)
    a = hdf5.Hdf5Iterator(x, y, 4, seed=3)
    b = jh5.Hdf5Iterator(x, y, 4, seed=3)
    assert a.N == b.N == 10
    for _ in range(7):  # over two passes, ragged tail batch included
        (xa, ya), (xb, yb) = next(a), b.next()
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError, match="unpaired"):
        hdf5.Hdf5Iterator(x, y[:3], 4)


@pytest.mark.parametrize("n,size,seed", [(3, 64, 0), (2, 32, 7)])
def test_make_pairs_byte_equal(n, size, seed):
    got, want = synthetic.make_pairs(n, size, seed), jsyn.make_pairs(
        n, size, seed)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_device_dataset_prepare_matches_jax():
    x, y = synthetic.make_pairs(8, 16, seed=1)
    for ga, gb in ((True, False), (False, True)):
        ds = DeviceDataset(x, y, ga, gb, device="cpu")
        jds = jdc.DeviceDataset(x, y, ga, gb)
        assert ds.N == jds.N == 8
        idx = np.array([5, 0, 7], np.int32)
        z = torch.rand(3, 4)
        Z, X, Y = ds.make_prepare(augment=False)(
            ds.batch_args(z, torch.from_numpy(idx)), None)
        _, Xj, Yj = jds.make_prepare(augment=False)((None, jnp.asarray(idx)),
                                                    None)
        assert Z is z and X.dtype == torch.float32
        np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
        np.testing.assert_array_equal(Y.numpy(), np.asarray(Yj))
    for mode in ("const", "arg"):  # one code path, both accepted
        assert DeviceDataset(x, y, device="cpu", mode=mode).mode == mode
    with pytest.raises(ValueError, match="const or arg"):
        DeviceDataset(x, y, device="cpu", mode="stream")
    with pytest.raises(ValueError, match="unpaired"):
        DeviceDataset(x, y[:2], device="cpu")


def test_device_dataset_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = synthetic.make_pairs(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataset(x, y)


@pytest.mark.parametrize("fast", [False, True], ids=["host", "device"])
def test_get_data_reads_an_h5_file(fast, tmp_path, monkeypatch):
    """TERRAIN_DATA: the h5 written by `write_h5` (the same bytes as
    terrain_tpu's) comes back as host iterators or, with TERRAIN_FAST=1, as
    device-resident datasets holding the file's arrays."""
    h5py = pytest.importorskip("h5py")
    path = synthetic.write_h5(str(tmp_path / "a.h5"), 8, 4, 16, seed=3)
    jpath = jsyn.write_h5(str(tmp_path / "b.h5"), 8, 4, 16, seed=3)
    with h5py.File(path, "r") as f, h5py.File(jpath, "r") as g:
        assert sorted(f) == sorted(g) == ["xt", "xv", "yt", "yv"]
        for k in f:
            np.testing.assert_array_equal(f[k][:], g[k][:])
    monkeypatch.setenv("TERRAIN_DATA", path)
    monkeypatch.delenv("TERRAIN_SYNTHETIC", raising=False)
    monkeypatch.delenv("TERRAIN_RASTER", raising=False)
    monkeypatch.setenv("TERRAIN_FAST", "1" if fast else "0")
    tr, va = experiments._get_data(16, device="cpu")
    assert (tr.N, va.N) == (8, 4)
    xt, yt = synthetic.make_pairs(8, 16, seed=3)
    if fast:
        assert isinstance(tr, DeviceDataset)
        np.testing.assert_array_equal(tr.x.numpy(), xt)
        np.testing.assert_array_equal(tr.y.numpy(), yt)
    else:
        want = hdf5.Hdf5Iterator(xt, yt, 4)
        for a, b in zip(next(tr), next(want)):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("TERRAIN_DATA", str(tmp_path / "missing.h5"))
    with pytest.raises(FileNotFoundError, match="TERRAIN_SYNTHETIC=1"):
        experiments._get_data(16, device="cpu")


def _pairs(n, size, seed):
    x, y = synthetic.make_pairs(n, size, seed)
    X, Y = hdf5.normalize_pair(x, y, True, False)
    return np.concatenate([X, Y], -1)


THETAS = [0.3, -2.0, 5.9, np.pi / 4 + 0.01, -np.pi / 2, 0.0]


@pytest.mark.parametrize("size", [32, 64])
def test_rotate_flip_gather_matches_jax(size):
    imgs = _pairs(len(THETAS), size, seed=size)
    for i, th in enumerate(THETAS):
        fh, fv = bool(i & 1), bool(i & 2)
        want = jaug._rotate_flip_one(jnp.asarray(imgs[i]), jnp.float32(th),
                                     fh, fv)
        got = augment._rotate_flip_one(torch.from_numpy(imgs[i]), th, fh, fv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **AUG_TOL)


@pytest.mark.parametrize("size", [32, 64])
def test_rotate_flip_shear_matches_jax(size):
    imgs = _pairs(len(THETAS), size, seed=size + 1)
    th = np.asarray(THETAS, np.float32)
    fh = np.array([0, 1, 0, 1, 1, 0], bool)
    fv = np.array([0, 0, 1, 1, 0, 1], bool)
    want = jaug._rotate_flip_shear(jnp.asarray(imgs), jnp.asarray(th),
                                   jnp.asarray(fh), jnp.asarray(fv))
    got = augment._rotate_flip_shear(torch.from_numpy(imgs),
                                     torch.from_numpy(th),
                                     torch.from_numpy(fh),
                                     torch.from_numpy(fv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AUG_TOL)
    # theta = 0 without flips is the identity, exactly
    same = augment._rotate_flip_shear(torch.from_numpy(imgs[:1]), 0.0, False,
                                      False)
    np.testing.assert_array_equal(same.numpy(), imgs[:1])


def test_shift_frac_is_the_roll_select_form(rng):
    """The gather along one axis with the reflect index against
    terrain_tpu's roll/select stages over the reflect-padded image."""
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    t = (rng.rand(2, 8, 1, 1).astype(np.float32) - 0.5) * 7.0
    want = jaug._shift_frac(jaug._reflect_pad(jnp.asarray(x), axis=2),
                            jnp.asarray(t), axis=2, max_abs=4.0)[:, :, :8]
    got = augment._shift_frac(torch.from_numpy(x), torch.from_numpy(t), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tt = np.ascontiguousarray(t.transpose(0, 2, 1, 3))
    want = jaug._shift_frac(jaug._reflect_pad(jnp.asarray(x), axis=1),
                            jnp.asarray(tt), axis=1, max_abs=4.0)[:, :8]
    got = augment._shift_frac(torch.from_numpy(x), torch.from_numpy(tt), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["shear", "gather"])
def test_augment_pair_pairs_exactly_and_is_reproducible(mode, monkeypatch):
    """A and B get the same transform: with B = A on every channel, B_aug
    equals A_aug bit for bit; the draws depend only on the generator's
    seed."""
    monkeypatch.setenv("TERRAIN_AUGMENT", mode)
    a = torch.from_numpy(_pairs(4, 32, seed=9)[..., :1])
    b = a.repeat(1, 1, 1, 3)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return augment.augment_pair(g, a, b, **kw)

    xa, ya = run(11)
    assert xa.shape == a.shape and ya.shape == b.shape
    for c in range(3):
        assert torch.equal(ya[..., c:c + 1], xa)
    xb, yb = run(11)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    xc, _ = run(12)
    assert not torch.equal(xa, xc)
    assert not torch.equal(xa, a)
    # flips only: a permutation of the pixels; nothing: the identity
    xf, _ = run(11, rotation=False)
    assert torch.equal(xf.flatten(1).sort(1).values,
                       a.flatten(1).sort(1).values)
    xi, yi = run(11, rotation=False, flips=False)
    assert torch.equal(xi, a) and torch.equal(yi, b)


def test_augment_draws_cover_the_reference_ranges():
    """theta ~ U(-2pi, 2pi) and two fair flips, from the generator."""
    seen = {}

    def spy(imgs, theta, fh, fv):
        seen.update(theta=theta, fh=fh, fv=fv)
        return imgs

    orig = augment._rotate_flip_shear
    augment._rotate_flip_shear = spy
    try:
        x = torch.zeros(4000, 2, 2, 1)
        augment.augment_pair(torch.Generator().manual_seed(0), x, x)
    finally:
        augment._rotate_flip_shear = orig
    th = seen["theta"].numpy()
    assert -2 * np.pi <= th.min() < -1.9 * np.pi
    assert 1.9 * np.pi < th.max() <= 2 * np.pi
    assert abs(th.mean()) < 0.3
    for f in (seen["fh"], seen["fv"]):
        assert f.dtype == torch.bool and 0.45 < f.float().mean() < 0.55
    assert not torch.equal(seen["fh"], seen["fv"])

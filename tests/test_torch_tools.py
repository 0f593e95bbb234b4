"""The port's side of the repository's data and quality tools
(terrain_tpu_torch/tools/{make_synthetic,build_dataset,pick_epoch,
compare_published}.py) against the repo-root tools (tools/*.py, which use
h5py, imageio and JAX) on the same inputs: the same arrays, picks, output
and exit codes, and table rows; and eval/resize.py against
jax.image.resize.

compare_published's numbers are held to 1e-4 with terrain_tpu's SWD and
terrain draws passed in (as tests/test_torch_eval.py does: the port cannot
draw threefry's numbers); the resize to 1e-6 (fp32 sums in another order).
"""

import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.eval import swd, terrain
from terrain_tpu_torch.eval.resize import resize_bilinear
from terrain_tpu_torch.serve.png import decode_png, encode_png
from terrain_tpu_torch.tools import (
    build_dataset, compare_published, make_synthetic, pick_epoch)
from test_torch_eval import jax_swd_draws, jax_terrain_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")
ImageFile = pytest.importorskip("PIL.ImageFile")
ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 24)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    """The repo-root tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    return _root_tool(name).main()


def _h5_arrays(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _same_h5(a, b):
    a, b = _h5_arrays(a), _h5_arrays(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_make_synthetic_writes_the_root_tools_arrays(tmp_path, monkeypatch,
                                                     capsys):
    args = ["--n", "6", "--n-valid", "3", "--size", "32", "--seed", "5"]
    assert make_synthetic.main([str(tmp_path / "a.h5"), *args]) == 0
    assert capsys.readouterr().out == f"wrote {tmp_path / 'a.h5'}\n"
    _run_root("make_synthetic", [str(tmp_path / "b.h5"), *args], monkeypatch)
    _same_h5(tmp_path / "a.h5", tmp_path / "b.h5")
    xt, _ = make_pairs(6, 32, seed=5)
    np.testing.assert_array_equal(_h5_arrays(tmp_path / "a.h5")["xt"], xt)


# ------------------------------------------------------------ build_dataset
def _rasters(tmp_path, h=420, w=700, progressive=False):
    """A heightmap PNG with an ocean (zeros) over its left third and a
    texture JPEG of the same size."""
    rnd = np.random.RandomState(1)
    yy, xx = np.mgrid[0:h, 0:w]
    hm = ((yy * 3 + xx) % 251 + 1).astype(np.uint8)
    hm[:, :w // 3] = 0
    hm[rnd.rand(h, w) < 0.05] = 0
    tex = np.stack([(yy + xx) % 256, (2 * yy) % 256, (3 * xx) % 256],
                   -1).astype(np.uint8)
    tex = np.clip(tex.astype(int) + rnd.randint(-9, 9, tex.shape), 0,
                  255).astype(np.uint8)
    (tmp_path / "hm.png").write_bytes(encode_png(hm))
    buf = io.BytesIO()
    Image.fromarray(tex).save(buf, "JPEG", quality=88,
                              progressive=progressive)
    (tmp_path / "tex.jpg").write_bytes(buf.getvalue())
    ref = np.full((20, 30, 3), (150, 110, 70), np.uint8)
    (tmp_path / "ref.png").write_bytes(encode_png(ref))
    return tmp_path / "hm.png", tmp_path / "tex.jpg", tmp_path / "ref.png"


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_build_dataset_writes_the_root_tools_arrays(progressive, tmp_path,
                                                    monkeypatch, capsys):
    hm, tex, ref = _rasters(tmp_path, progressive=progressive)
    common = ["--heightmap", str(hm), "--texture", str(tex), "--crop", "128",
              "--stride", "50"]
    for extra, tag in (([], "all"), (["--max-n", "7"], "max")):
        mine, theirs = tmp_path / f"m_{tag}.h5", tmp_path / f"r_{tag}.h5"
        build_dataset.main([*common, *extra, "--out", str(mine)])
        out_mine = capsys.readouterr().out.replace(str(mine), "OUT")
        _run_root("build_dataset", [*common, *extra, "--out", str(theirs)],
                  monkeypatch)
        out_theirs = capsys.readouterr().out.replace(str(theirs), "OUT")
        assert out_mine == out_theirs
        _same_h5(mine, theirs)
    n = len(_h5_arrays(tmp_path / "m_all.h5")["xt"])
    assert n > 20 and len(_h5_arrays(tmp_path / "m_max.h5")["xt"]) == 6
    for split in ([], ["--subset-valid-split"]):
        sub = ["--subset-from", str(tmp_path / "m_all.h5"), "--ref-img",
               str(ref), "--top-k", "10", *split]
        build_dataset.main([*sub, "--out", str(tmp_path / "m_sub.h5")])
        _run_root("build_dataset", [*sub, "--out",
                                    str(tmp_path / "r_sub.h5")], monkeypatch)
        _same_h5(tmp_path / "m_sub.h5", tmp_path / "r_sub.h5")


@pytest.mark.parametrize("kind", ["pgm16_webp", "pbm_tga"])
def test_build_dataset_reads_the_other_raster_formats_as_the_root_tool(
        kind, tmp_path, monkeypatch, capsys):
    """A 16-bit PGM heightmap with a lossy WebP texture, and a bitmap PBM
    (imageio reads its path through OpenCV) with a run-length TGA one: the
    port's decoders give the repo-root tool's arrays."""
    hm_png, tex_jpg, _ = _rasters(tmp_path, 300, 400)
    hm = decode_png(hm_png.read_bytes()).reshape(300, 400)
    tex = np.asarray(Image.open(tex_jpg))
    if kind == "pgm16_webp":
        hm_path, tex_path = tmp_path / "hm.pgm", tmp_path / "tex.webp"
        Image.fromarray(hm.astype(np.uint16) * 257).save(hm_path, "PPM")
        Image.fromarray(tex).save(tex_path, "WEBP", quality=80)
    else:
        hm_path, tex_path = tmp_path / "hm.pbm", tmp_path / "tex.tga"
        Image.fromarray(hm > 0).save(hm_path, "PPM")
        Image.fromarray(tex).save(tex_path, "TGA", rle=True)
    common = ["--heightmap", str(hm_path), "--texture", str(tex_path),
              "--crop", "128", "--stride", "50"]
    mine, theirs = tmp_path / "m.h5", tmp_path / "r.h5"
    build_dataset.main([*common, "--out", str(mine)])
    out_mine = capsys.readouterr().out.replace(str(mine), "OUT")
    _run_root("build_dataset", [*common, "--out", str(theirs)], monkeypatch)
    assert out_mine == capsys.readouterr().out.replace(str(theirs), "OUT")
    _same_h5(mine, theirs)
    assert len(_h5_arrays(mine)["xt"]) > 5


def test_build_dataset_streams_rows_into_the_file(tmp_path, monkeypatch):
    """The crops go into the file's memmaps one row at a time: the file
    exists at its full size before the first crop is written."""
    from terrain_tpu_torch.data import h5

    hm, tex, _ = _rasters(tmp_path, 300, 400)
    sizes = []
    orig = h5.create

    def create(path, specs):
        maps = orig(path, specs)
        sizes.append(os.path.getsize(path))
        return maps

    monkeypatch.setattr(h5, "create", create)
    out = tmp_path / "s.h5"
    build_dataset.main(["--heightmap", str(hm), "--texture", str(tex),
                        "--crop", "64", "--stride", "40", "--out", str(out)])
    assert sizes == [os.path.getsize(out)]


# --------------------------------------------------------------- pick_epoch
def _run_pick(tool_main, argv, capsys):
    rc = tool_main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("metric", ["swd_mean", "p2p_swd_mean", "both"])
def test_pick_epoch_prints_what_the_root_tool_prints(metric, tmp_path,
                                                     monkeypatch, capsys):
    out, models = tmp_path / "out", tmp_path / "models"
    out.mkdir()
    models.mkdir()
    (out / "swd.txt").write_text(
        "epoch,swd_mean,p2p_swd_mean\n1,0.9,0.5\n2,0.4,0.6\n3,0.5,0.2\n"
        "3,0.45,0.25\n4,0.7\n5,0.6,0.3\n")
    for e in (1, 3, 5):
        (models / f"{e}.model").write_bytes(b"")
    argv = [str(out), str(models), "--metric", metric]
    mine = _run_pick(pick_epoch.main, argv, capsys)

    def root(argv):
        monkeypatch.setattr(sys, "argv", ["tools/pick_epoch.py", *argv])
        return _root_tool("pick_epoch").main()

    assert mine == _run_pick(root, argv, capsys)
    assert mine[0] == 0 and mine[1].strip().endswith(".model")
    # no swd.txt: exit 1, the same message
    empty = [str(tmp_path), str(models)]
    mine = _run_pick(pick_epoch.main, empty, capsys)
    assert mine == _run_pick(root, empty, capsys) and mine[0] == 1


# -------------------------------------------------------- compare_published
@pytest.mark.parametrize("sizes", [(512, 256), (512, 128), (512, 200),
                                   (200, 512)])
def test_resize_is_jax_image_resize(sizes):
    import jax

    h, size = sizes
    x = np.random.RandomState(h + size).rand(2, h, h, 1).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, size, size, 1),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size, size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pngs(d, n, size, seed):
    d.mkdir()
    rnd = np.random.RandomState(seed)
    for i in range(n):
        low = rnd.rand(size // 8, size // 8)
        img = np.kron(low, np.ones((8, 8))) * 200 + rnd.rand(size, size) * 50
        img = img.astype(np.uint8)
        if i % 2:  # the published files replicate gray to RGB
            img = np.repeat(img[..., None], 3, -1)
        (d / f"{i}.png").write_bytes(encode_png(img))
    return d


def _rows(mod, monkeypatch):
    """Record the metric dicts of the module's table rows."""
    rows = []
    orig = mod.row

    def row(label, a, b, seed):
        m = orig(label, a, b, seed)
        rows.append((label, m))
        return m

    monkeypatch.setattr(mod, "row", row)
    return rows


def test_compare_published_needs_the_published_directory(tmp_path, capsys):
    """The published samples are not in the repo: --ref-dir has no
    default."""
    with pytest.raises(SystemExit) as e:
        compare_published.main([str(tmp_path), "--device", "cpu"])
    assert e.value.code == 2
    assert "--ref-dir" in capsys.readouterr().err


def test_compare_published_gives_the_root_tools_rows(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(swd, "swd_draws", jax_swd_draws)
    monkeypatch.setattr(terrain, "terrain_draws", jax_terrain_draws)
    ref = _pngs(tmp_path / "ref", 20, 96, 0)
    gen = _pngs(tmp_path / "gen", 12, 128, 1)
    real = tmp_path / "real.h5"
    with h5py.File(real, "w") as f:
        f.create_dataset("xt", data=make_pairs(30, 80, seed=2)[0])
    argv = [str(gen), "--ref-dir", str(ref), "--scale", "64", "--real-h5",
            str(real), "--seed", "3"]
    mine = _rows(compare_published, monkeypatch)
    assert compare_published.main([*argv, "--device", "cpu"]) == 0
    out_mine = capsys.readouterr().out
    root = _root_tool("compare_published")
    theirs = _rows(root, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["tools/compare_published.py", *argv])
    root.main()
    out_theirs = capsys.readouterr().out
    assert [label for label, _ in mine] == [label for label, _ in theirs]
    assert len(mine) == 5
    for (label, a), (_, b) in zip(mine, theirs):
        assert sorted(a) == sorted(b), label
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4, (label, k, a[k], b[k])
    assert out_mine.splitlines()[:2] == out_theirs.splitlines()[:2]

"""The port's four artifact tools (terrain_tpu_torch/tools/make_filmstrip,
make_gen_sheet, pack_artifacts, render_clip) against the repository's
(tools/*.py, on imageio) on the same synthetic directories: the outputs
decode equal, pack_artifacts' CSVs are byte-equal and its copies the same
files, the printed lines, the skipped-frame counts and the refusals are the
same.  Frames are a few dozen pixels a side."""

import importlib.util
import os
import shutil

import numpy as np
import pytest

from terrain_tpu_torch.serve.png import encode_png
from terrain_tpu_torch.tools import (make_filmstrip, make_gen_sheet,
                                     pack_artifacts, render_clip)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _repo_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, monkeypatch, capsys, name="tool"):
    """(printed lines, SystemExit's message or None) of main under argv."""
    monkeypatch.setattr("sys.argv", [name, *argv])
    msg = None
    try:
        main()
    except SystemExit as e:
        msg = str(e.code)
    return capsys.readouterr().out, msg


def _both(name, port_main, argv_of, tmp_path, monkeypatch, capsys):
    """Run the repository's tool and the port's on the same inputs, each
    into its own output; returns ((out, msg, path) of each)."""
    res = []
    for who, main in (("repo", _repo_tool(name).main), ("port", port_main)):
        out_path = str(tmp_path / who / "out")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        argv = argv_of(out_path)
        out, msg = _run(main, argv, monkeypatch, capsys)
        res.append((out.replace(out_path, "<out>"), msg, out_path))
    return res


def _frame(rnd, h=24, w=40):
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    base = np.concatenate([y * 200 + x * 50, x * 230 + 0 * y,
                           (1 - y) * 180 + 0 * x], -1)
    return np.clip(base + rnd.randint(0, 8, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _frames_dir(tmp_path, n=11, torn=(), repeat=(), gray=False):
    d = tmp_path / "clip"
    d.mkdir(exist_ok=True)
    rnd = np.random.RandomState(n)
    prev = None
    for i in range(n):
        img = prev if i in repeat else _frame(rnd)
        prev = img
        data = encode_png(img[..., 1] if gray else img)
        if i in torn:
            data = data[: len(data) // 3]  # an interrupted write
        (d / f"concat_{i:04d}.png").write_bytes(data)
    (d / "other_0000.png").write_bytes(encode_png(_frame(rnd)))
    return d


def _same_png(a, b):
    np.testing.assert_array_equal(iio.imread(a), iio.imread(b))


@pytest.mark.parametrize("argv", [[], ["--k", "3"], ["--k", "1"],
                                  ["--k", "20"],
                                  ["--pattern", "other_*.png"]])
def test_make_filmstrip(argv, tmp_path, monkeypatch, capsys):
    d = _frames_dir(tmp_path, torn=(5,))
    (r_out, r_msg, r_path), (p_out, p_msg, p_path) = _both(
        "make_filmstrip", make_filmstrip.main,
        lambda out: [str(d), out + ".png", *argv], tmp_path, monkeypatch,
        capsys)
    assert (p_out, p_msg) == (r_out, r_msg) and r_msg is None
    _same_png(r_path + ".png", p_path + ".png")


def test_make_filmstrip_refusals(tmp_path, monkeypatch, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    torn = _frames_dir(tmp_path, n=3, torn=(0, 1, 2))
    for d in (empty, torn):
        (r_out, r_msg, _), (p_out, p_msg, _) = _both(
            "make_filmstrip", make_filmstrip.main,
            lambda out: [str(d), out + ".png"], tmp_path, monkeypatch,
            capsys)
        assert (p_out, p_msg) == (r_out, r_msg) and r_msg


def _gen_dir(tmp_path, n, shape=(16, 16), odd=None):
    d = tmp_path / "gen"
    d.mkdir(exist_ok=True)
    rnd = np.random.RandomState(n)
    for i in range(n):
        s = odd if i == n - 1 and odd else shape
        (d / f"{i}.png").write_bytes(encode_png(
            rnd.randint(0, 256, s).astype(np.uint8)))
    return d


@pytest.mark.parametrize("n,argv", [(30, []), (30, ["--k", "2"]),
                                    (7, []), (1, ["--k", "3"])])
def test_make_gen_sheet(n, argv, tmp_path, monkeypatch, capsys):
    d = _gen_dir(tmp_path, n, shape=(16, 12, 3) if n == 7 else (16, 16))
    (r_out, r_msg, r_path), (p_out, p_msg, p_path) = _both(
        "make_gen_sheet", make_gen_sheet.main,
        lambda out: [str(d), out + ".png", *argv], tmp_path, monkeypatch,
        capsys)
    assert (p_out, p_msg) == (r_out, r_msg) and r_msg is None
    _same_png(r_path + ".png", p_path + ".png")


@pytest.mark.parametrize("case", ["mixed shapes", "no PNGs"])
def test_make_gen_sheet_refusals(case, tmp_path, monkeypatch, capsys):
    if case == "mixed shapes":
        d = _gen_dir(tmp_path, 6, odd=(16, 16, 3))
    else:
        d = tmp_path / "gen"
        d.mkdir()
    (r_out, r_msg, _), (p_out, p_msg, _) = _both(
        "make_gen_sheet", make_gen_sheet.main,
        lambda out: [str(d), out + ".png"], tmp_path, monkeypatch, capsys)
    assert (p_out, p_msg) == (r_out, r_msg) and r_msg


def _run_dir(tmp_path, n_out=7, n_dump=23, with_swd=True):
    """A trainer-shaped output directory: a resumed run's results.txt
    (epochs logged twice, a torn row, a junk line), swd.txt, two arch
    diagrams, out_<e>.png grids and dump_a's samples."""
    src = tmp_path / "run"
    src.mkdir()
    header = "epoch,train_a,train_b,valid_a,lr,time,mode"
    rows = [f"{e},{e * 0.5:.4f},{1 / e:.5f},{e * 0.25:.3f},2e-4,{e * 1.5},"
            f"both" for e in range(1, 6)]
    resumed = [r.replace("both", "both2") for r in rows[2:]]
    text = "\n".join([header] + rows + ["4,0.1,0.2", "x,junk",
                                        "9999999,1,2,3,4,5,6"]
                     + resumed + ["6,3.0,0.1,1.5,2e-4,9.0,both"]) + "\n"
    (src / "results.txt").write_text(text)
    if with_swd:
        (src / "swd.txt").write_text(
            "epoch,swd_mean,w1\n2,0.5,0.1\n1,0.7,0.2\n2,0.4,0.1\n3,0.3\n")
    rnd = np.random.RandomState(1)
    for name in ("arch_dcgan_gen.png", "arch_p2p_gen.png"):
        (src / name).write_bytes(encode_png(rnd.randint(
            0, 256, (8, 8, 3)).astype(np.uint8)))
    for e in range(1, n_out + 1):
        (src / f"out_{e}.png").write_bytes(encode_png(rnd.randint(
            0, 256, (10, 12, 3)).astype(np.uint8)))
    if n_dump:
        (src / "dump_a").mkdir()
        for i in range(n_dump):
            (src / "dump_a" / f"{i}.png").write_bytes(encode_png(
                rnd.randint(0, 256, (9, 11)).astype(np.uint8)))
    return src


@pytest.mark.parametrize("kind", ["full", "two grids", "no dump_a",
                                  "seven samples"])
def test_pack_artifacts(kind, tmp_path, capsys):
    src = _run_dir(tmp_path, n_out=2 if kind == "two grids" else 7,
                   n_dump={"no dump_a": 0, "seven samples": 7}.get(kind, 23),
                   with_swd=kind != "two grids")
    outs = {}
    for who, main in (("repo", _repo_tool("pack_artifacts").main),
                      ("port", pack_artifacts.main)):
        dst = tmp_path / who
        main(str(src), str(dst))
        outs[who] = (capsys.readouterr().out.replace(str(dst), "<dst>"),
                     dst)
    (r_out, r_dst), (p_out, p_dst) = outs["repo"], outs["port"]
    assert p_out == r_out
    assert sorted(os.listdir(p_dst)) == sorted(os.listdir(r_dst))
    for name in os.listdir(r_dst):
        if name == "dump_a_final.png":
            _same_png(r_dst / name, p_dst / name)
        else:  # the CSVs and the copied PNGs byte-equal
            assert (p_dst / name).read_bytes() == (r_dst / name).read_bytes()


@pytest.mark.parametrize("argv", [[], ["--fps", "30"],
                                  ["--pattern", "other_*.png"]])
@pytest.mark.parametrize("gray", [False, True])
def test_render_clip(argv, gray, tmp_path, monkeypatch, capsys):
    d = _frames_dir(tmp_path, n=8, torn=(6,), repeat=(3,), gray=gray)
    (r_out, r_msg, r_path), (p_out, p_msg, p_path) = _both(
        "render_clip", render_clip.main,
        lambda out: [str(d), out + ".gif", *argv], tmp_path, monkeypatch,
        capsys)
    assert (p_out, p_msg) == (r_out, r_msg) and r_msg is None
    if not argv:
        assert "skipped 1 unreadable frame(s)" in p_out
    want = iio.imread(r_path + ".gif", extension=".gif")
    got = iio.imread(p_path + ".gif", extension=".gif")
    np.testing.assert_array_equal(got, want)
    meta = iio.immeta(p_path + ".gif", extension=".gif")
    assert meta["loop"] == iio.immeta(r_path + ".gif",
                                      extension=".gif")["loop"] == 0


def test_render_clip_refusals(tmp_path, monkeypatch, capsys):
    """No frames, no readable frames, and an .mp4: the repository tool
    finds no ffmpeg backend where it writes, the port refuses it by name
    at the same place (after reading the frames)."""
    empty = tmp_path / "empty"
    empty.mkdir()
    torn = _frames_dir(tmp_path, n=2, torn=(0, 1))
    for d in (empty, torn):
        (r_out, r_msg, _), (p_out, p_msg, _) = _both(
            "render_clip", render_clip.main,
            lambda out: [str(d), out + ".gif"], tmp_path, monkeypatch,
            capsys)
        assert (p_out, p_msg) == (r_out, r_msg) and r_msg
    shutil.rmtree(torn)
    d = _frames_dir(tmp_path, n=3)
    monkeypatch.setattr("sys.argv", ["t", str(d), str(tmp_path / "c.mp4")])
    with pytest.raises(Exception, match="backend"):
        _repo_tool("render_clip").main()
    with pytest.raises(NotImplementedError, match="ffmpeg"):
        render_clip.main()
    assert not (tmp_path / "c.mp4").exists()


def test_the_outputs_must_be_png(tmp_path):
    """imageio picks a format by the name; the port writes PNG only and
    says so."""
    d = _gen_dir(tmp_path, 4)
    with pytest.raises(NotImplementedError, match=r"\.png"):
        make_gen_sheet.main([str(d), str(tmp_path / "sheet.jpg")])

"""TERRAIN_AOT and TERRAIN_AOT_KEY in terrain_tpu_torch (utils/aot.py,
ops/kernels/_build.py): a store of the port's built libraries.

On the CPU the host libraries build (g++): they go into the store with
their records, and a fresh process whose PATH holds no compiler loads them
and decodes the committed PNG, JPEG, TIFF, BMP, WebP, PNM, TGA and JPEG
2000 fixtures to their digests (SHA-256 of imageio's decodes).  A record that does not
fit is rebuilt
with a compiler and raises without one; an edited source gives a new
entry; TERRAIN_AOT_KEY=jaxpr keys on every file of the package.  The CUDA
sources need nvcc and a card, which the CPU tests do not assume: their
key, path and record logic only.  chip_smoke.py's `coldstart` phase runs the store on the
card."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from terrain_tpu_torch.data import jp2, jpeg, tiff, webp
from terrain_tpu_torch.ops.kernels import _build
from terrain_tpu_torch.serve import gif, png
from terrain_tpu_torch.utils import aot
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
HOSTS = [os.path.join(aot.PACKAGE, s) for s in _build.HOST_SOURCES]

KINDS = ("png", "jpeg", "tiff", "bmp", "webp", "pnm", "tga", "jp2", "pfm_pam",
         "hdr", "sun", "dds", "sgi", "pcx", "qoi", "im", "ico", "icns", "mpo")
DECODE = """
import hashlib, json, os, sys
from terrain_tpu_torch.data.raster import read_raster
out = {}
for kind in %r:
    d = os.path.join(sys.argv[1], kind)
    digests = json.load(open(os.path.join(d, "digests.json")))
    for name, want in digests.items():
        if name.startswith("strip_") or name == "reference" or \
                "refused" in want or "path_refused" in want or \
                want.get("path", want) is None or \
                "error" in want.get("path", want):
            continue
        a = read_raster(os.path.join(d, name))
        out[name] = hashlib.sha256(a.tobytes()).hexdigest()
print(json.dumps(out))
""" % (KINDS,)


@pytest.fixture
def store(tmp_path, monkeypatch):
    d = tmp_path / "store"
    monkeypatch.setenv("TERRAIN_AOT", str(d))
    monkeypatch.delenv("TERRAIN_AOT_KEY", raising=False)
    return d


def _no_compiler_env(tmp_path):
    """The environment of a process that finds no compiler: PATH holds
    only a directory with python in it, CUDA_HOME and CUDA_PATH unset."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    if not (bin_dir / "python").exists():
        (bin_dir / "python").symlink_to(sys.executable)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=str(bin_dir), PYTHONPATH=str(ROOT))
    return env


def _no_compiler(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)


def test_the_host_sources_are_the_decoders():
    """The PNG unfilter, the JPEG decoder, the TIFF, BMP, TGA, Sun,
    Radiance, SGI and PCX runs, the DDS blocks and the QOI ops (one
    library: data/bmp.py, tga.py, sun.py, hdr.py, dds.py, sgi.py, pcx.py
    and qoi.py bind data/tiff.py's), the GIF
    writer's quantizer and LZW coder, the WebP decoder and the JPEG 2000
    decoder: six host libraries."""
    assert sorted(HOSTS) == sorted([png._UNFILTER_SRC, jpeg._SRC, tiff._SRC,
                                    gif._SRC, webp._SRC, jp2._SRC])
    assert len(HOSTS) == 6


def test_host_libraries_go_to_the_store_with_their_records(store):
    paths = [_build.build_host(src) for src in HOSTS]
    for path, src in zip(paths, HOSTS):
        assert os.path.dirname(path) == str(store)
        rec = json.loads(pathlib.Path(aot.record_path(path)).read_text())
        assert rec["format"] == aot.FORMAT_VERSION
        assert rec["flags"] == _build.HOST_FLAGS
        assert path.endswith(f"-{rec['digest']}.so")
        assert rec["arch"].startswith("host-")
        assert rec["compiler"] and rec["device"] is None
        assert aot.mismatch(rec, rec["digest"], _build.HOST_FLAGS,
                            False) is None
    # a second build loads what is there
    mtimes = [os.stat(p).st_mtime_ns for p in paths]
    assert [_build.build_host(src) for src in HOSTS] == paths
    assert [os.stat(p).st_mtime_ns for p in paths] == mtimes


def test_a_process_without_compilers_loads_the_store_and_decodes(
        store, tmp_path):
    for src in HOSTS:
        _build.build_host(src)
    env = _no_compiler_env(tmp_path)
    env["TERRAIN_AOT"] = str(store)
    assert shutil.which("g++", path=env["PATH"]) is None
    assert shutil.which("c++", path=env["PATH"]) is None
    r = subprocess.run([sys.executable, "-c", DECODE, str(DATA)], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.splitlines()[-1])
    want = {}
    for kind in KINDS:
        digests = json.loads((DATA / kind / "digests.json").read_text())
        # read_raster(path) is imageio's decode of the path
        want.update({n: v.get("path", v)["sha256"]
                     for n, v in digests.items()
                     if not n.startswith("strip_") and n != "reference"
                     and v.get("path", v) is not None
                     and "error" not in v.get("path", v)
                     and "refused" not in v and "path_refused" not in v})
    assert len(want) >= 100 and set(want) <= set(got)
    assert {n: got[n] for n in want} == want
    assert "rebuilding" not in r.stdout
    # the same process on an empty store raises: nothing to load, no g++
    env["TERRAIN_AOT"] = str(tmp_path / "empty")
    r = subprocess.run([sys.executable, "-c", DECODE, str(DATA)], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no host C++ compiler" in r.stderr


RENDER = """
import numpy as np
from terrain_tpu_torch.serve.gif import encode_gif, read_gif
rng = np.random.RandomState(0)
frames = [rng.randint(0, 256, (24, 40, 3)).astype(np.uint8) for _ in range(3)]
got = read_gif(encode_gif(frames, 40))
print(got.shape, int(np.abs(got.astype(int) - np.stack(frames)).max()))
"""


def test_a_process_without_compilers_renders_a_clip_from_the_store(
        store, tmp_path):
    """The GIF writer's library comes from the store too: a clip is
    quantized, coded and read back with no compiler on PATH."""
    for src in HOSTS:
        _build.build_host(src)
    env = _no_compiler_env(tmp_path)
    env["TERRAIN_AOT"] = str(store)
    r = subprocess.run([sys.executable, "-c", RENDER], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    shape, err = r.stdout.split(")")
    assert shape == "(3, 24, 40, 3" and 0 < int(err) < 128


def test_the_png_fixture_digest_is_pillows_decode():
    """Every PNG digest is imageio's decode, through Pillow (a palette image
    expanded as imageio expands it)."""
    import imageio.v3 as iio
    import numpy as np

    digests = json.loads((DATA / "png" / "digests.json").read_text())
    for name, want in digests.items():
        if name == "reference":  # the Pillow and imageio versions
            continue
        a = np.asarray(iio.imread((DATA / "png" / name).read_bytes()))
        assert list(a.shape) == want["shape"]
        assert hashlib.sha256(a.tobytes()).hexdigest() == want["sha256"]


@pytest.mark.parametrize("field,value", [
    ("digest", "0" * 16), ("flags", ["-O0"]), ("format", 0),
    ("arch", "host-other"), (None, None), ("json", "[]")])
def test_a_record_that_does_not_fit_is_rebuilt_or_raises(
        field, value, store, monkeypatch, capsys):
    src = HOSTS[0]
    path = _build.build_host(src)
    rec = aot.read_record(path)
    if field is None:
        os.remove(aot.record_path(path))  # no record at all
    elif field == "json":
        pathlib.Path(aot.record_path(path)).write_text(value)  # no object
    else:
        aot.write_record(path, {**rec, field: value})
    why = aot.mismatch(aot.read_record(path), rec["digest"],
                       _build.HOST_FLAGS, False)
    assert why is not None
    with monkeypatch.context() as m:
        _no_compiler(m)
        with pytest.raises(RuntimeError) as err:
            _build.build_host(src)
        assert path in str(err.value) and why in str(err.value)
        assert "no host C++ compiler" in str(err.value)
    capsys.readouterr()
    before = os.stat(path).st_mtime_ns
    assert _build.build_host(src) == path
    out = capsys.readouterr().out
    assert out == f"rebuilding {path}: {why}\n"
    assert os.stat(path).st_mtime_ns != before
    assert aot.read_record(path) == rec


def test_an_edited_source_gives_a_new_entry(store, tmp_path):
    src = tmp_path / "png_unfilter.cpp"
    shutil.copy(png._UNFILTER_SRC, src)
    first = _build.build_host(str(src))
    src.write_text(src.read_text() + "\n// edited\n")
    second = _build.build_host(str(src))
    assert first != second
    assert {p.name for p in store.iterdir()} == {
        os.path.basename(f) for p in (first, second)
        for f in (p, aot.record_path(p))}


def test_the_jaxpr_key_covers_every_file_of_the_package(tmp_path,
                                                        monkeypatch):
    """TERRAIN_AOT_KEY=jaxpr adds the package's digest to every key; the
    digest moves with any file of the package, a module, a kernel or
    data alike, and not with its built libraries or caches."""
    copy = tmp_path / "pkg"
    shutil.copytree(aot.PACKAGE, copy, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    base = aot.package_digest(str(copy))
    seen = {base}
    for rel in ("ops/pool.py", "ops/kernels/csrc/pool2.cu",
                "data/csrc/jpeg_decode.cpp", "cudnn_errata.json"):
        f = copy / rel
        text = f.read_bytes()
        f.write_bytes(text + b"\n")
        aot.package_digest.cache_clear()
        d = aot.package_digest(str(copy))
        assert d not in seen, rel
        seen.add(d)
        f.write_bytes(text)
    (copy / "_build").mkdir()
    (copy / "_build" / "x.so").write_text("built")
    (copy / "__pycache__").mkdir()
    (copy / "__pycache__" / "x.pyc").write_text("cache")
    aot.package_digest.cache_clear()
    assert aot.package_digest(str(copy)) == base

    def key_of(value):
        if value is None:
            monkeypatch.delenv("TERRAIN_AOT_KEY", raising=False)
        else:
            monkeypatch.setenv("TERRAIN_AOT_KEY", value)
        return _build._digest("pool2"), aot.key(hashlib.sha256(b"x"))

    default = key_of(None)
    assert key_of("shapes") == default == key_of("other")
    jaxpr = key_of("jaxpr")
    assert jaxpr[0] != default[0] and jaxpr[1] != default[1]
    monkeypatch.setattr(aot, "package_digest", lambda root=None: "edited")
    assert key_of("jaxpr") != jaxpr


def test_cuda_libraries_go_to_the_store_and_need_nvcc(store, monkeypatch):
    """Under TERRAIN_AOT a CUDA library's path is in the store, named by
    its key; with no entry and no nvcc the build raises naming nvcc."""
    for name in _build.SOURCES:
        assert _build.lib_path(name) == str(
            store / f"{name}-{_build._digest(name)}.so")
    monkeypatch.delenv("TERRAIN_AOT")
    assert _build.lib_path("pool2").startswith(_build.BUILD_DIR)
    monkeypatch.setenv("TERRAIN_AOT", str(store))
    _no_compiler(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("pool2",))


def test_a_cuda_entry_built_on_another_card_is_not_loaded(store,
                                                          monkeypatch):
    """A store entry whose record names compute capability 8.0, on a
    card of 9.0: with no nvcc the build raises naming the entry and both
    capabilities; the library is never opened."""
    import torch

    name = "pool2"
    path = _build.lib_path(name)
    store.mkdir()
    pathlib.Path(path).write_bytes(b"not a library")
    rec = {"format": aot.FORMAT_VERSION, "digest": _build._digest(name),
           "flags": _build.NVCC_FLAGS, "arch": aot.CUDA_ARCH,
           "compiler": "release 12.4", "torch_cuda": torch.version.cuda,
           "device": "NVIDIA A100", "capability": "8.0"}
    aot.write_record(path, rec)
    monkeypatch.setattr(aot, "device", lambda: ("NVIDIA H100", "9.0"))
    _no_compiler(monkeypatch)
    with pytest.raises(RuntimeError) as err:
        _build.build((name,))
    msg = str(err.value)
    assert path in msg and "8.0" in msg and "9.0" in msg
    assert "nvcc not found" in msg
    # the same record on a card of 8.0 fits
    monkeypatch.setattr(aot, "device", lambda: ("NVIDIA A100", "8.0"))
    assert aot.mismatch(aot.read_record(path), rec["digest"],
                        _build.NVCC_FLAGS, True) is None
    # and a record of another CUDA major version does not
    other = dict(rec, torch_cuda="11.8" if torch.version.cuda != "11.8"
                 else "12.4")
    assert "CUDA" in aot.mismatch(other, rec["digest"], _build.NVCC_FLAGS,
                                  True)

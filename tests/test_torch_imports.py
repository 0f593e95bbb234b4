"""The port stands alone: no module of terrain_tpu_torch and no line of
chip_smoke.py imports jax, jaxlib or terrain_tpu, nor h5py, imageio or PIL
(the card's machine has none of the three: the port reads HDF5, PNG and
JPEG with its own code), importing the whole package builds no kernel and
touches no CUDA device, and its data path runs where the three cannot be
imported."""

import ast
import importlib
import pathlib
import sys

import pytest
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "terrain_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


JAX = ("jax", "jaxlib", "terrain_tpu")
LIBRARIES = ("h5py", "imageio", "PIL")  # none on the card's machine


def _imports(path, banned):
    """The names of `banned` packages that `path` imports anywhere."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def hit(name):
        return name.split(".")[0] in banned

    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if hit(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and hit(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and hit(a.value)]
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_terrain_tpu_imports(path):
    """Neither JAX nor the JAX package, nor h5py, imageio or PIL."""
    bad = _imports(path, JAX + LIBRARIES)
    assert not bad, f"{path.name} imports {bad}"


def test_the_file_list_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py", "terrain_tpu_torch/serve/server.py",
                 "terrain_tpu_torch/ops/kernels/bilinear_conv.py",
                 "terrain_tpu_torch/ops/kernels/conv_stem.py",
                 "terrain_tpu_torch/ops/kernels/conv_thin.py",
                 "terrain_tpu_torch/ops/pool.py",
                 "terrain_tpu_torch/train/losses.py",
                 "terrain_tpu_torch/train/optim.py",
                 "terrain_tpu_torch/train/step.py",
                 "terrain_tpu_torch/experiments.py",
                 "terrain_tpu_torch/ops/kernels/pool2.py",
                 "terrain_tpu_torch/ops/kernels/conv_s2.py",
                 "terrain_tpu_torch/data/hdf5.py",
                 "terrain_tpu_torch/data/synthetic.py",
                 "terrain_tpu_torch/data/augment.py",
                 "terrain_tpu_torch/data/device_cache.py",
                 "terrain_tpu_torch/utils/async_writer.py",
                 "terrain_tpu_torch/utils/images.py",
                 "terrain_tpu_torch/train/schedule.py",
                 "terrain_tpu_torch/train/checkpoint.py",
                 "terrain_tpu_torch/train/trainer.py",
                 "terrain_tpu_torch/cli.py",
                 "terrain_tpu_torch/__main__.py",
                 "terrain_tpu_torch/ops/kernels/bilinear.py",
                 "terrain_tpu_torch/ops/blur.py",
                 "terrain_tpu_torch/eval/__init__.py",
                 "terrain_tpu_torch/eval/swd.py",
                 "terrain_tpu_torch/eval/terrain.py",
                 "terrain_tpu_torch/data/prefetch.py",
                 "terrain_tpu_torch/utils/profiling.py",
                 "terrain_tpu_torch/parallel/__init__.py",
                 "terrain_tpu_torch/parallel/mesh.py",
                 "terrain_tpu_torch/parallel/distributed.py",
                 "terrain_tpu_torch/parallel/tp.py",
                 "terrain_tpu_torch/parallel/spatial.py",
                 "terrain_tpu_torch/tools/conv5_dw.py",
                 "terrain_tpu_torch/data/h5.py",
                 "terrain_tpu_torch/data/jpeg.py",
                 "terrain_tpu_torch/data/raster.py",
                 "terrain_tpu_torch/data/tiff.py",
                 "terrain_tpu_torch/data/bmp.py",
                 "terrain_tpu_torch/data/webp.py",
                 "terrain_tpu_torch/data/pnm.py",
                 "terrain_tpu_torch/data/tga.py",
                 "terrain_tpu_torch/data/cvread.py",
                 "terrain_tpu_torch/data/hdr.py",
                 "terrain_tpu_torch/data/sun.py",
                 "terrain_tpu_torch/data/dds.py",
                 "terrain_tpu_torch/data/sgi.py",
                 "terrain_tpu_torch/data/pcx.py",
                 "terrain_tpu_torch/data/qoi.py",
                 "terrain_tpu_torch/data/im.py",
                 "terrain_tpu_torch/data/ico.py",
                 "terrain_tpu_torch/data/icns.py",
                 "terrain_tpu_torch/data/pillow_open.py",
                 "terrain_tpu_torch/tools/import_reference_weights.py",
                 "terrain_tpu_torch/eval/resize.py",
                 "terrain_tpu_torch/tools/make_synthetic.py",
                 "terrain_tpu_torch/tools/build_dataset.py",
                 "terrain_tpu_torch/tools/pick_epoch.py",
                 "terrain_tpu_torch/tools/compare_published.py",
                 "terrain_tpu_torch/entry.py"):
        assert must in names


def test_importing_every_module_builds_nothing_and_touches_no_device():
    import torch

    from terrain_tpu_torch.ops.kernels import _build

    def built():
        d = pathlib.Path(_build.BUILD_DIR)
        return sorted(p.name for p in d.iterdir()) if d.exists() else []

    before = built()
    for path in FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__main__"):
            continue  # an entry point: it parses sys.argv when imported
        name = name.removesuffix(".__init__")
        importlib.import_module(name)
    assert built() == before
    assert not torch.cuda.is_initialized()
    assert "triton" not in sys.modules


BLOCKED = """
import sys
for name in ("h5py", "imageio", "PIL"):
    assert name not in sys.modules, name
    sys.modules[name] = None  # an import of it raises ImportError
import hashlib, json, os
import numpy as np
from terrain_tpu_torch.data import h5
from terrain_tpu_torch.data.jpeg import decode_jpeg
from terrain_tpu_torch.experiments import get_iterators
from terrain_tpu_torch.tools import (
    build_dataset, compare_published, make_synthetic, pick_epoch)
data = sys.argv[1]
d = json.load(open(os.path.join(data, "h5", "digests.json")))
with h5.File(os.path.join(data, "h5", "pairs_earliest_gzip.h5")) as f:
    a = np.ascontiguousarray(f["yt"])
assert hashlib.sha256(a.tobytes()).hexdigest() == \
    d["pairs_earliest_gzip.h5"]["yt"]["sha256"]
tr, va = get_iterators(os.path.join(data, "h5",
                                    "pairs_earliest_contiguous.h5"),
                       2, True, False)
assert tr.N == 6 and next(tr)[0].shape == (2, 64, 64, 1)
j = json.load(open(os.path.join(data, "jpeg", "digests.json")))
name = "progressive_2048x1024_420_cut2.jpg"
img = decode_jpeg(open(os.path.join(data, "jpeg", name), "rb").read())
assert hashlib.sha256(img.tobytes()).hexdigest() == j[name]["sha256"]
from terrain_tpu_torch.data.raster import read_raster
from terrain_tpu_torch.tools import import_reference_weights
for kind, name in (("tiff", "rgb8_lzw_pred2_tiles_be.tif"),
                   ("bmp", "rle4.bmp"), ("png", "palette4_adam7.png"),
                   ("webp", "alph_filter3_vp8l.webp"), ("pnm", "p4.pbm"),
                   ("tga", "map16_rle.tga"), ("pfm_pam", "cv_pf_gray.pfm"),
                   ("pfm_pam", "pam_comments_cr.pam"), ("hdr", "all_rle.hdr"),
                   ("sun", "rle_depth8.ras"), ("sun", "depth8_map2.sr"),
                   ("dds", "dx10_bc7.dds"), ("dds", "dx10_bc6h_sf16.dds"),
                   ("sgi", "rle_rgba16.sgi"), ("pcx", "planes4_w3.pcx"),
                   ("qoi", "ops_rgba.qoi"), ("im", "b4_colour_lut.im"),
                   ("ico", "dib4_mask.ico"), ("ico", "pillow_png_p.ico"),
                   ("icns", "it32_t8mk.icns"), ("icns", "ic07_jp2_rgb.icns"),
                   ("mpo", "pillow_progressive.mpo")):
    d = json.load(open(os.path.join(data, kind, "digests.json")))[name]
    a = read_raster(os.path.join(data, kind, name))
    assert hashlib.sha256(a.tobytes()).hexdigest() == \
        d.get("path", d)["sha256"], name
for name, key in (("layout4_btree2.h5", "plain"),
                  ("edge_unfiltered_btree2.h5", "shuffle_gzip_fletcher32_4d")):
    with h5.File(os.path.join(data, "h5", name)) as f:
        a = np.ascontiguousarray(f[key])
    assert hashlib.sha256(a.tobytes()).hexdigest() == json.load(open(
        os.path.join(data, "h5", "digests.json")))[name][key]["sha256"]
print("ok")
"""


def test_the_data_path_runs_without_h5py_imageio_or_pil():
    """A process in which h5py, imageio and PIL cannot be imported reads
    the committed h5py files (a layout-4 B-tree too, and one with partial
    edge chunks stored unfiltered), a progressive JPEG, a TIFF, a BMP, an
    interlaced palette PNG, a WebP with a filtered VP8L ALPH chunk, a PBM
    at its path, a run-length TGA, a PFM at its path (OpenCV's reading), a
    PAM, a run-length Radiance file, Sun rasters at *.ras and *.sr paths,
    BC7 and BC6H DDS files, a run-length 16-bit SGI, a 4-plane PCX, a QOI
    of every op, a 4-bit IM with a colour Lut, DIB and PNG icons, an icns
    of it32 runs and one of a JPEG 2000 entry and a progressive MPO to
    their digests and imports the port's data tools and the weights
    importer."""
    import subprocess

    r = subprocess.run([sys.executable, "-c", BLOCKED,
                        str(ROOT / "tests" / "data")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

"""The port stands alone: no module of terrain_tpu_torch and no line of
chip_smoke.py imports jax, jaxlib or terrain_tpu, and importing the whole
package builds no kernel and touches no CUDA device."""

import ast
import importlib
import pathlib
import sys

import pytest
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "terrain_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "terrain_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_terrain_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and _banned(a.value)]
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

"""The port stands alone: no module of terrain_tpu_torch and no line of
chip_smoke.py imports jax, jaxlib or terrain_tpu."""

import ast
import pathlib

import pytest

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
                 "terrain_tpu_torch/ops/kernels/bilinear_conv.py"):
        assert must in names

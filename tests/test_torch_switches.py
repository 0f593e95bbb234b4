"""terrain_tpu's TERRAIN_* switches in terrain_tpu_torch: every switch the
JAX package reads is read by the port, refused on a value the port does not
honour, or named as a no-op on this card with its reason; TERRAIN_PLATFORM
at the CLI and server entry points; and TERRAIN_BC_BWD=xla32 under bf16
computing the decoder stages' backward in fp32.  TERRAIN_AOT,
TERRAIN_AOT_KEY and TERRAIN_POOL_VJP's lanes and dense, once refused, are
honoured: read where they act, and named by no NotImplementedError.

The JAX package's names are read from its sources as text, without
importing it: a switch added there later fails here until the port decides
what to do with it."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from terrain_tpu_torch import cli, device
from terrain_tpu_torch.ops import activations, fused
from terrain_tpu_torch.ops.kernels import bilinear_conv as bc
from terrain_tpu_torch.ops.kernels import conv_s2, conv_stem, conv_thin
from terrain_tpu_torch.serve import __main__ as serve_main
from terrain_tpu_torch.serve import server
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_OP_MODULES = (activations, fused, conv_stem, conv_s2, conv_thin, server)


def _jax_switches():
    names = set()
    for path in (ROOT / "terrain_tpu").rglob("*.py"):
        names.update(re.findall(r"TERRAIN_[A-Z0-9_]+", path.read_text()))
    return names


def _code_strings(path):
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs}


def test_every_jax_switch_is_read_refused_or_a_named_no_op():
    """A name counts as handled when the port's code (not a comment or a
    docstring) names it: where it reads the switch, where it refuses it, or
    in a module's NO_OP_SWITCHES table."""
    port = set()
    for path in (ROOT / "terrain_tpu_torch").rglob("*.py"):
        for s in _code_strings(path):
            port.update(re.findall(r"TERRAIN_[A-Z0-9_]+", s))
    jax_names = _jax_switches()
    assert len(jax_names) >= 49
    assert sorted(jax_names - port) == []


def test_no_op_tables_name_jax_switches_with_a_reason():
    jax_names = _jax_switches()
    listed = {}
    for mod in NO_OP_MODULES:
        for name, reason in mod.NO_OP_SWITCHES.items():
            assert name in jax_names, (mod.__name__, name)
            assert len(reason) > 40, (mod.__name__, name)
            listed.setdefault(name, []).append(mod.__name__)
    assert set(listed) == {
        "TERRAIN_LEAKY_MUL", "TERRAIN_NEAREST_BWD", "TERRAIN_DECONV_BWD",
        "TERRAIN_ACT_BWD", "TERRAIN_STEM_PLANES", "TERRAIN_STEM_TH",
        "TERRAIN_THIN_TH", "TERRAIN_SERVE_QFETCH"}
    # terrain_tpu reads TERRAIN_ACT_BWD in both conv kernels' backwards
    assert len(listed["TERRAIN_ACT_BWD"]) == 2


def _refusals(path):
    """The TERRAIN_* names in the messages of a module's
    `raise NotImplementedError(...)` statements."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        exc = getattr(node, "exc", None) if isinstance(node, ast.Raise) \
            else None
        if isinstance(exc, ast.Call) and getattr(
                exc.func, "id", None) == "NotImplementedError":
            for c in ast.walk(exc):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.update(re.findall(r"TERRAIN_[A-Z0-9_]+", c.value))
    return names


@pytest.mark.parametrize("name,module", [
    ("TERRAIN_AOT", "utils/aot.py"), ("TERRAIN_AOT_KEY", "utils/aot.py"),
    ("TERRAIN_POOL_VJP", "ops/pool.py")])
def test_the_switches_once_refused_are_honoured(name, module, monkeypatch):
    port = ROOT / "terrain_tpu_torch"
    assert name in _code_strings(port / module)
    for path in port.rglob("*.py"):
        assert name not in _refusals(path), path
    if name == "TERRAIN_POOL_VJP":
        from terrain_tpu_torch.ops import max_pool2d

        for mode in ("lanes", "dense"):
            monkeypatch.setenv(name, mode)
            assert max_pool2d(torch.ones(1, 4, 4, 2), 2).shape == (1, 2, 2, 2)


@pytest.mark.parametrize("value,want", [(None, "cuda"), ("", "cuda"),
                                        ("cpu", "cpu")])
def test_terrain_platform_sets_the_entry_points_device(value, want,
                                                       monkeypatch):
    if value is None:
        monkeypatch.delenv("TERRAIN_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("TERRAIN_PLATFORM", value)
    assert device.platform_device() == want
    seen = {}
    monkeypatch.setattr("terrain_tpu_torch.experiments.run",
                        lambda name, mode, dev: seen.update(cli=dev))
    cli.main(["smoke_synthetic", "gen"])
    assert seen == {"cli": want}


@pytest.mark.parametrize("entry", ["cli", "serve"])
def test_terrain_platform_other_than_cpu_raises(entry, monkeypatch):
    monkeypatch.setenv("TERRAIN_PLATFORM", "tpu")
    main = cli.main if entry == "cli" else serve_main.main
    with pytest.raises(ValueError, match="TERRAIN_PLATFORM"):
        main(["smoke_synthetic", "gen"] if entry == "cli"
             else ["smoke_synthetic", "--no-weights"])


def _bc_grads(x, w, b, cot, mode, monkeypatch):
    monkeypatch.setenv("TERRAIN_BC_BWD", mode)
    args = tuple(t.clone().requires_grad_() for t in (x, w, b))
    return torch.autograd.grad(bc.BilinearConvFn.apply(*args), args, cot)


def test_xla32_under_bf16_computes_the_backward_in_fp32(rng, monkeypatch):
    """The fault TERRAIN_BC_BWD used to hide: under bf16 compute, xla32 is
    the fp32 backward (as terrain_tpu's `_xla_composite` vjp), so its
    gradients lie closer to the fp32 ones than conv6's bf16 computation."""
    bf = torch.bfloat16
    x = torch.from_numpy(rng.randn(2, 8, 12, 16).astype(np.float32)).to(bf)
    w = torch.from_numpy((rng.randn(3, 3, 16, 8) * 0.1).astype(
        np.float32)).to(bf)
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2, 16, 24, 8).astype(np.float32)).to(bf)
    # the same bf16 values in fp32, through the fp32 backward
    ref = _bc_grads(x.float(), w.float(), b, cot.float(), "conv6",
                    monkeypatch)
    dtypes = []
    real = bc.composite_grads
    monkeypatch.setattr(bc, "composite_grads", lambda x, w, g, dt, *a:
                        dtypes.append(dt) or real(x, w, g, dt, *a))
    errs = {}
    for mode in ("conv6", "xla32"):
        got = _bc_grads(x, w, b, cot, mode, monkeypatch)
        assert [t.dtype for t in got] == [bf, bf, torch.float32]
        errs[mode] = [float((g.float() - r).abs().max() / r.abs().max())
                      for g, r in zip(got[:2], ref[:2])]
    assert dtypes == [bf, torch.float32]
    for i in range(2):  # dX and dW
        assert errs["xla32"][i] < errs["conv6"][i], errs
        # xla32 only rounds its fp32 result to bf16
        assert errs["xla32"][i] <= 2 ** -8, errs


@pytest.mark.parametrize("mode", ["conv6", "dense", "xla32"])
def test_bilinear_conv_backward_computes_only_what_is_asked(mode, rng,
                                                            monkeypatch):
    """The generator path through the U-Net needs dX only, the U-Net's own
    parameters dW and db only: under every TERRAIN_BC_BWD value the other
    gradients are not computed."""
    monkeypatch.setenv("TERRAIN_BC_BWD", mode)
    asked = []
    real = bc.composite_grads
    monkeypatch.setattr(bc, "composite_grads", lambda x, w, g, dt, need:
                        asked.append(tuple(need)) or real(x, w, g, dt, need))
    conv6 = []
    monkeypatch.setattr(bc, "dx_conv6", lambda g, w: conv6.append(1) or
                        torch.zeros(g.shape[0], g.shape[1] // 2,
                                    g.shape[2] // 2, w.shape[2]))
    x, w, b = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(1, 6, 8, 8), rng.randn(3, 3, 8, 8) * 0.1, rng.randn(8)))
    cot = torch.ones(1, 12, 16, 8)
    xg = x.clone().requires_grad_()
    torch.autograd.grad(bc.BilinearConvFn.apply(xg, w, b), xg, cot)
    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
    torch.autograd.grad(bc.BilinearConvFn.apply(x, wg, bg), (wg, bg), cot)
    if mode == "conv6":
        assert asked == [(False, False, False), (False, True, True)]
        assert conv6 == [1]
    else:
        assert asked == [(True, False, False), (False, True, True)]
        assert conv6 == []

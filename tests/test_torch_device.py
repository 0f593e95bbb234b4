"""terrain_tpu_torch/device.py's strict_fp32 on the CPU: the cuDNN settings
of the port's fp32 numerics, and the errata file that keeps cuDNN's FFT
engines out of the fp32 step (chip_smoke.py `ballast` shows on the card
that the step's bits then do not depend on free memory)."""

import json
import os

import pytest
import torch

from terrain_tpu_torch import device
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def _restore(monkeypatch):
    monkeypatch.delenv("CUDNN_ERRATA_JSON_FILE", raising=False)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    yield monkeypatch
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def test_strict_fp32_sets_the_numerics_and_the_errata_file(_restore):
    device.strict_fp32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
    assert os.environ["CUDNN_ERRATA_JSON_FILE"] == device.CUDNN_ERRATA
    device.strict_fp32()  # again: the same file is no conflict


def test_the_errata_file_blocks_the_fft_engines():
    """The engines cuDNN's heuristics rank first for the flagship's fp32
    convs and that carry CUDNN_NUMERICAL_NOTE_FFT: forward engine 3 and
    data-gradient engine 50, pinned to the cuDNN build they were measured
    on: the range holds its compile-time and runtime versions and no
    version past them."""
    with open(device.CUDNN_ERRATA) as f:
        rules = json.load(f)["rules"]
    blocked = {(r["operation"], r["engine"]) for r in rules}
    assert blocked == {("ConvFwd", 3), ("ConvBwdData", 50)}
    lo, hi = sorted(device.CUDNN_MEASURED.values())
    assert all(r["cudnn_version_start"] == lo
               and r["cudnn_version_end"] == hi + 1 for r in rules)


def test_another_errata_file_raises(_restore, tmp_path):
    other = tmp_path / "errata.json"
    other.write_text('{"version": 1, "rules": []}')
    _restore.setenv("CUDNN_ERRATA_JSON_FILE", str(other))
    with pytest.raises(ValueError, match="FFT engines blocked"):
        device.strict_fp32()

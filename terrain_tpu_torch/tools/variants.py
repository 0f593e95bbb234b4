"""What the by-parts tools of this directory share: copies of a kernel
source with edits made, one nvcc for each copy, all started together,
ptxas's registers and spills of the kernels built, C entry points bound
through ctypes, and CUDA-event times of a launch.  The edited copies live in
a directory the caller gives; the kernels' build directory is not touched.
"""

import ctypes
import os
import re
import shutil
import statistics
import subprocess

from terrain_tpu_torch.ops.kernels import _build


def edited_source(name, edits):
    """csrc/<name>.cu with each (old, new) edit made; every old is found
    exactly once, so a variant measures what its name says."""
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit target found {text.count(old)} times "
                               f"in {name}.cu, not once: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas_summary(log, pattern):
    """{entry: 'N registers, S bytes spilled, B bytes of stack frame'} of
    the kernels whose mangled names match the regex `pattern`, an entry
    named by the pattern's groups that matched, joined by spaces."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(pattern, line)
            entry = " ".join(s for s in m.groups() if s) if m else None
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            out[entry] = (f"{m.group(2)} bytes spilled, {m.group(1)} bytes "
                          f"of stack frame")
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[entry] = f"{regs} registers, {out.get(entry, '?')}"
    return out


def build_all(tmp, texts, pattern):
    """One nvcc for each source of {key: text}, all started together, into
    `tmp` -> {key: (lib, ptxas_summary(its log, pattern))}."""
    shutil.copy(os.path.join(_build.CSRC, "common.cuh"), tmp)
    procs = {}
    for i, (key, text) in enumerate(texts.items()):
        src = os.path.join(tmp, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"v{i}.so")
        procs[key] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for key, (p, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{out}")
        built[key] = (so, ptxas_summary(out, pattern))
    return built


def bind(so, entry, argtypes):
    """The C entry point `entry` of the library `so`, returning an int."""
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def times_ms(torch, fn, reps=10, burst=20):
    """(single, stream): one launch per event pair after a synchronize, and
    `burst` launches back to back per pair, per launch; medians."""
    for _ in range(3):
        fn()
    single, stream = [], []
    for _ in range(reps):
        for count, out in ((1, single), (burst, stream)):
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(count):
                fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / count)
    return statistics.median(single), statistics.median(stream)

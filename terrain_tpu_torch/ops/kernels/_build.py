"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (sm_90a) into its own shared
library with a plain C interface and loaded with ctypes -- seconds per
file, where a PyTorch C++ extension takes minutes.  Libraries go to
terrain_tpu_torch/_build/ (git-ignored), named by a hash of the sources
and flags, so an edited source is rebuilt and a built one is reused.  The
build happens at first use, or for all kernels at once (one nvcc process
per source, started together) through `build()`.  A failed build raises.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `CudaKernel.launch` raises if that is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))  # .../ops/kernels
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("conv_thin", "bilinear_conv", "conv_stem", "conv_s2", "pool2",
           "bilinear")

_lock = threading.Lock()


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _digest(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def lib_path(name):
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def build(names=SOURCES):
    """Compile every named source that has no library yet, all nvcc
    processes at once.  Returns {name: (path, ptxas report)}; raises with
    the compiler's output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = lib_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    failed = []
    for name, (p, tmp, path) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (rc {p.returncode})\n{out}")
            continue
        with open(f"{path}.log", "w") as f:
            f.write(out)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    report = {}
    for name in names:
        log = f"{lib_path(name)}.log"
        text = open(log).read() if os.path.exists(log) else ""
        report[name] = (lib_path(name), text)
    return report


class CudaKernel:
    """One C entry point of one csrc/<source>.cu library.

    `launches` counts successful launches made through `launch`; a run
    sets it to 0 and reads it to show the path went through the kernel."""

    def __init__(self, source, entry, argtypes):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def _bind(self):
        with _lock:
            if self._fn is None:
                build((self.source,))
                lib = ctypes.CDLL(lib_path(self.source))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.source}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._err = err
                self._fn = fn
        return self._fn

    def launch(self, *args):
        rc = self._bind()(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"{self.entry} launch failed: {msg} ({rc})")
        self.launches += 1


class OpCounter:
    """Counts the calls of an op that is no kernel of its own (a backward
    pass made of PyTorch ops), for the same purpose as
    `CudaKernel.launches`."""

    def __init__(self):
        self.calls = 0


def all_on_cpu(name, *tensors):
    """True when every tensor lies on the CPU (the caller then runs its plain
    version).  Otherwise all must lie on one CUDA device and be contiguous,
    or this raises: there is no fallback for a tensor off the CPU."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    return False


def nhwc_contiguous(t, counter):
    """t, or a contiguous copy of it, counted on `counter`: a copy of a
    large activation can cost more than the kernel it feeds, so a run
    reports how many an op made."""
    if t.is_contiguous():
        return t
    counter.calls += 1
    return t.contiguous()


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def partial_blocks(t, per_sm=2):
    """Number of blocks of a two-pass reduction kernel: a fixed multiple of
    the card's SM count, so the partial sums and their order are the same
    from run to run."""
    import torch

    return per_sm * torch.cuda.get_device_properties(
        t.device).multi_processor_count

"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (sm_90a) into its own shared
library with a plain C interface and loaded with ctypes -- seconds per
file, where a PyTorch C++ extension takes minutes.  Libraries go to
terrain_tpu_torch/_build/ (git-ignored), or to TERRAIN_AOT's store when
that is set (read at each build; utils/aot.py), named by a hash of the
sources and flags, so an edited source is rebuilt and a built one is
reused; each has a record beside it (flags, compiler, card), and one whose
record does not fit the process is rebuilt, or raises where no compiler
is found (utils/aot.py).  The build happens at first use, or for all
kernels at once (one nvcc process per source, started together) through
`build()`.  A failed build raises.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `CudaKernel.launch` raises if that is not 0.  While
a profiler records (and no graph capture is under way), `launch` names the
call in the trace: a `record_function` labelled with `label`, which the
kernel's `__global__` launches inside it link to through the trace's
correlation ids (tools/summarize_trace.py reads it).  The
stream is the device's current one (`stream_of`): inside a CUDA graph
capture (train/step.py) that is the capturing stream, so the kernels are
recorded into the graph with PyTorch's own launches.  A kernel is built,
bound and given its launch attributes on its first launch, which must not
fall inside a capture: the graph's warm-up step makes it.

`build_host` compiles the port's host C++ (a plain C interface, such as
serve/csrc/png_unfilter.cpp) the same way, with the host compiler.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

from terrain_tpu_torch.utils import aot, nan_check

_HERE = os.path.dirname(os.path.abspath(__file__))  # .../ops/kernels
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("conv_thin", "bilinear_conv", "conv_stem", "conv_s2", "pool2",
           "bilinear")

_lock = threading.Lock()


HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# the host C++ sources, relative to the package (serve/png.py, data/jpeg.py,
# data/tiff.py with data/bmp.py, tga.py, sun.py, hdr.py and dds.py,
# serve/gif.py, data/webp.py, data/jp2.py)
HOST_SOURCES = ("serve/csrc/png_unfilter.cpp", "data/csrc/jpeg_decode.cpp",
                "data/csrc/raster_decode.cpp", "serve/csrc/gif_encode.cpp",
                "data/csrc/webp_decode.cpp", "data/csrc/jp2_decode.cpp")


def lib_dir():
    """Where libraries go: TERRAIN_AOT's store when set, else BUILD_DIR."""
    return aot.store_dir() or BUILD_DIR


def nvcc_path():
    """nvcc under CUDA_HOME (or CUDA_PATH), else on PATH: a process given
    neither finds no compiler (a machine that runs from a TERRAIN_AOT
    store)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME, or put nvcc on "
                       "PATH); the CUDA kernels are built from csrc/ at "
                       "first use")


def _digest(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return aot.key(h)


def lib_path(name, digest=None):
    return os.path.join(lib_dir(), f"{name}-{digest or _digest(name)}.so")


def _loadable(path, digest, flags, cuda, compiler):
    """Whether the library at `path` exists and its record fits this
    process.  One whose record does not fit is rebuilt when `compiler()`
    finds a compiler (one printed line says which and why), and raises
    naming it and the mismatch when none is found: it is never loaded."""
    if not os.path.exists(path):
        return False
    why = aot.mismatch(aot.read_record(path), digest, flags, cuda)
    if why is None:
        return True
    try:
        compiler()
    except RuntimeError as e:
        raise RuntimeError(f"{path} is not loaded: {why}; and it cannot be "
                           f"rebuilt: {e}") from None
    print(f"rebuilding {path}: {why}", flush=True)
    return False


def build(names=SOURCES):
    """Compile every named source that has no library yet, all nvcc
    processes at once.  Returns {name: (path, ptxas report)}; raises with
    the compiler's output if one fails."""
    os.makedirs(lib_dir(), exist_ok=True)
    procs = {}
    for name in names:
        digest = _digest(name)
        path = lib_path(name, digest)
        if _loadable(path, digest, NVCC_FLAGS, True, nvcc_path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path, digest)
    failed = []
    for name, (p, tmp, path, digest) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (rc {p.returncode})\n{out}")
            continue
        with open(f"{path}.log", "w") as f:
            f.write(out)
        aot.write_record(path, aot.make_record(digest, NVCC_FLAGS,
                                               nvcc_path(), True))
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    report = {}
    for name in names:
        log = f"{lib_path(name)}.log"
        text = ""
        if os.path.exists(log):
            with open(log) as f:
                text = f.read()
        report[name] = (lib_path(name), text)
    return report


def host_compiler():
    """The host C++ compiler: g++, the one nvcc drives, else c++."""
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the "
                       "port's host C++ is built from source at first use")


def build_host(src):
    """Compile one host C++ source with a plain C interface into the
    library directory (`lib_dir`), named by a hash of the source and
    flags, unless that library exists with a record that fits.  Returns
    its path; raises with the compiler's output if it fails."""
    with open(src, "rb") as f:
        text = f.read()
    digest = aot.key(hashlib.sha256(" ".join(HOST_FLAGS).encode() + text))
    name = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(lib_dir(), f"{name}-{digest}.so")
    if _loadable(path, digest, HOST_FLAGS, False, host_compiler):
        return path
    os.makedirs(lib_dir(), exist_ok=True)
    cxx = host_compiler()
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    p = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"host C++ build of {src} failed (rc "
                           f"{p.returncode}):\n{p.stdout}{p.stderr}")
    aot.write_record(path, aot.make_record(digest, HOST_FLAGS, cxx, False))
    os.replace(tmp, path)
    return path


class CudaKernel:
    """One C entry point of one csrc/<source>.cu library.

    `launches` counts successful calls of `launch`: eager launches, and
    each launch recorded into a CUDA graph once, at its capture.  A
    graph's replays run the recorded launches without calling `launch`,
    so they add nothing; a run sets the count to 0 and reads it to show
    the path went through the kernel.  `name` (the entry point without
    "_launch" unless given) names it in reports and NaN checks.  `symbol`
    is the `__global__` function the entry point launches, as a profiler
    names it; `cost_args` are the names of the shape arguments of its
    module's `cost(name, ...)`, in the order `launch`'s `shape` gives
    their values."""

    def __init__(self, source, entry, argtypes, name=None, symbol=None,
                 cost_args=()):
        import torch

        self.source = source
        self.entry = entry
        # the kernel's name in reports and NaN checks
        self.name = name or entry.removesuffix("_launch")
        self.symbol = symbol
        self.cost_args = tuple(cost_args)
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._profiling = torch._C._autograd._profiler_enabled

    def _bind(self):
        if self._fn is None and _capturing():
            raise RuntimeError(
                f"{self.entry}: first launch inside a CUDA graph capture; "
                f"the kernel is built and bound by a warm-up launch before "
                f"the capture")
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

    def label(self, shape):
        """`terrain::<name>(<arg>=<value>,...)`, the shape values named by
        `cost_args`; a dtype is written as "float32" or "bfloat16"."""
        vals = ",".join(f"{k}={str(v).removeprefix('torch.')}"
                        for k, v in zip(self.cost_args, shape, strict=True))
        return f"terrain::{self.name}({vals})"

    def labelled(self):
        """True while a profiler records outside a graph capture: `launch`
        then labels its call.  With no profiler this is the one check a
        launch adds."""
        return self._profiling() and not _capturing()

    def launch(self, *args, outputs=(), shape=()):
        """Calls the entry point with `args`; `outputs`, the tensors it
        writes, are then checked for NaNs when TERRAIN_CHECK_NANS=2's
        checks are recording (utils/nan_check.py).  `shape`, the values of
        `cost_args`, labels the call while a profiler records outside a
        graph capture; otherwise nothing is opened."""
        fn = self._bind()
        if self.labelled():
            import torch

            with torch.profiler.record_function(self.label(shape)):
                rc = fn(*args)
        else:
            rc = fn(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"{self.entry} launch failed: {msg} ({rc})")
        self.launches += 1
        nan_check.kernel_outputs(self.name, *outputs)


def _capturing():
    import torch

    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


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
    if not any(t.is_cuda for t in tensors):
        if all(t.device.type == "cpu" for t in tensors):
            return True
    else:  # is_cuda and get_device() cost less than building devices
        dev = tensors[0].get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors):
            if not all(t.is_contiguous() for t in tensors):
                raise ValueError(f"{name}: every tensor must be contiguous")
            return False
    raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")


def nhwc_contiguous(t, counter):
    """t, or a contiguous copy of it, counted on `counter`: a copy of a
    large activation can cost more than the kernel it feeds, so a run
    reports how many an op made."""
    if t.is_contiguous():
        return t
    counter.calls += 1
    return t.contiguous()


def stream_of(t):
    """The raw handle of t's device's current stream: the call PyTorch's
    own generated code makes, which skips building a `torch.cuda.Stream`
    object at every launch as `current_stream` does."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def partial_blocks(t, per_sm=2):
    """Number of blocks of a two-pass reduction kernel: a fixed multiple of
    the card's SM count, so the partial sums and their order are the same
    from run to run."""
    return per_sm * _sm_count(t.get_device())

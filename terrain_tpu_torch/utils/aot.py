"""TERRAIN_AOT: a store of the port's built libraries, shipped with the
model, so that a cold process starts without compiling (the counterpart of
terrain_tpu/utils/aot.py, whose store holds XLA executables).

The port's compiled programs are its libraries: the six CUDA sources of
ops/kernels/csrc/ (nvcc, sm_90a) and the six host C++ sources
(`_build.HOST_SOURCES`, the PNG unfilter, the JPEG decoder, the TIFF,
BMP, TGA, Sun and Radiance run decoders with the DDS block decoders, the
GIF writer's quantizer and LZW coder, the WebP decoder and the JPEG 2000
decoder; g++), built
by ops/kernels/_build.py at first use.  `TERRAIN_AOT=dir`, read at each
build, puts them into `dir` instead of terrain_tpu_torch/_build/.  Each
library `<name>-<key>.so` has its record `<name>-<key>.json` beside it
(in _build/ too):
  * `format`: FORMAT_VERSION;
  * `digest` and `flags`: the key (a hash of the sources and the flags)
    and the compiler's flags;
  * `arch`: sm_90a, or `host-<machine>` for a host library;
  * `compiler`: nvcc's `--version` release line, or the host compiler's
    first line;
  * `torch_cuda`: torch.version.cuda;
  * `device` and `capability`: the card the library was built on (a host
    library's are null: the host decoders run in data workers, which must
    not touch the card).
A library is loaded only when its record fits this process (`mismatch`):
the same format, digest, flags and arch, and for a CUDA library the
current card's compute capability and torch's CUDA major version.  One
that does not fit is never loaded: where the compiler is found it is
rebuilt, and one printed line names the entry and why (terrain_tpu
recompiles and re-saves alike); where no compiler is found the build
raises, naming the entry and the mismatch.  A filled store thus runs on a
machine with no nvcc and no g++.  Writes are atomic (a temporary file and
`os.replace`: the record first, then the library), so several torchrun
ranks can share one store.

Key.  By default the key covers the library's own sources and flags, so
an edited kernel gets a new entry and an unchanged one is reused.
`TERRAIN_AOT_KEY=jaxpr`, terrain_tpu's exhaustive key, also covers every
file of terrain_tpu_torch (`package_digest`, taken once a process): any
edit of the package then invalidates the store.  Any other value is the
default key, as in terrain_tpu.

TERRAIN_CHECK_NANS=2 leaves the libraries as they are (its checks read
the kernels' outputs from Python, utils/nan_check.py), so the store
applies under the checks too, where terrain_tpu skips its store (a
checkified program is another program).  Not stored: TERRAIN_SCAN's CUDA
graphs (a graph cannot be serialized; each process captures its chunks
again, ~1.5-2 s on the flagship) and cuDNN's choice of plans, which a
process makes at its first call of each conv.

`fill()` builds every library into the store (the trainer calls it on the
card when TERRAIN_AOT is set), so a store filled by one run holds what
any later run loads.
"""

import functools
import hashlib
import json
import os
import platform
import subprocess

FORMAT_VERSION = 1
CUDA_ARCH = "sm_90a"
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def store_dir():
    """TERRAIN_AOT's directory, or None when unset."""
    return os.environ.get("TERRAIN_AOT") or None


def exhaustive():
    """Whether TERRAIN_AOT_KEY asks for terrain_tpu's exhaustive key."""
    return os.environ.get("TERRAIN_AOT_KEY", "shapes") == "jaxpr"


@functools.lru_cache(maxsize=None)
def package_digest(root=PACKAGE):
    """A hash of every file under `root` (the package's code, kernels,
    host C++ and data; its built libraries and bytecode caches left out),
    by path relative to root and content."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("_build", "__pycache__"))
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def key(h):
    """The entry key from `h`, a sha256 of a library's flags and sources:
    with TERRAIN_AOT_KEY=jaxpr the package's digest is added."""
    if exhaustive():
        h.update(b"package " + package_digest().encode())
    return h.hexdigest()[:16]


def record_path(lib):
    return os.path.splitext(lib)[0] + ".json"


def device():
    """(name, "major.minor") of the current CUDA device, or (None, None)
    without one."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    i = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(i)
    return torch.cuda.get_device_name(i), f"{major}.{minor}"


@functools.lru_cache(maxsize=None)
def compiler_release(compiler):
    """nvcc's release line (`Cuda compilation tools, release 12.4, ...`),
    or a host compiler's first line of `--version`."""
    out = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    release = [ln for ln in out if "release" in ln]
    return (release or out or ["?"])[0].strip()


def _arch(cuda):
    return CUDA_ARCH if cuda else f"host-{platform.machine()}"


def _cuda_major(version):
    return version.split(".")[0] if version else None


def make_record(digest, flags, compiler, cuda):
    """The record of a library just built with `compiler`."""
    import torch

    name, cap = device() if cuda else (None, None)
    return {"format": FORMAT_VERSION, "digest": digest, "flags": list(flags),
            "arch": _arch(cuda), "compiler": compiler_release(compiler),
            "torch_cuda": torch.version.cuda, "device": name,
            "capability": cap}


def read_record(lib):
    """The record beside a library as JSON gives it, or None (missing or
    unreadable)."""
    try:
        with open(record_path(lib)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_record(lib, record):
    path = record_path(lib)
    tmp = f"{path}.{os.getpid()}.{id(record)}.tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)


def mismatch(record, digest, flags, cuda):
    """Why a library's record does not fit this process (a string), or
    None when the library may be loaded."""
    import torch

    if not isinstance(record, dict):
        return "no readable record beside it"
    want = {"format": FORMAT_VERSION, "digest": digest,
            "flags": list(flags), "arch": _arch(cuda)}
    for field, value in want.items():
        if record.get(field) != value:
            return f"its {field} {record.get(field)!r} is not {value!r}"
    if cuda:
        _, cap = device()
        if cap is not None and record.get("capability") != cap:
            return (f"it was built on compute capability "
                    f"{record.get('capability')}, this card is {cap}")
        got = _cuda_major(record.get("torch_cuda"))
        if got != _cuda_major(torch.version.cuda):
            return (f"it was built for CUDA {record.get('torch_cuda')}, "
                    f"torch runs CUDA {torch.version.cuda}")
    return None


def fill():
    """Build (or check) every library of the port into the store: the six
    CUDA sources at once, then the host sources.  Returns their paths."""
    from terrain_tpu_torch.ops.kernels import _build

    paths = [path for path, _ in _build.build().values()]
    return paths + [_build.build_host(os.path.join(PACKAGE, src))
                    for src in _build.HOST_SOURCES]

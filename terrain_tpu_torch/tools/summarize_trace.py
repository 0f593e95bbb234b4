"""Summarize a torch.profiler Chrome trace of the port into per-kernel device
time, families, launching ops and roofline headroom.

The port's counterpart of tools/summarize_trace.py, which reads a TPU's
"XLA Ops" thread and XLA's cost fields; a torch.profiler trace (the one
TERRAIN_PROFILE writes through utils/profiling.trace, or any with CUDA
activity and record_shapes) has neither, so the cost comes from the port's
own models:

  * device events are the `kernel`, `gpu_memcpy` and `gpu_memset` events;
    "busy" is the sum of their durations, and, since the port's kernels
    can overlap on several streams, the union of their intervals too;
  * each is grouped into a family (`family_of`): the six hand-written
    kernel files by the `__global__` names of ops/kernels/csrc/*.cu, cuDNN
    fprop / dgrad / wgrad, GEMM, PyTorch's native kernels, NCCL, copies
    and memsets, other;
  * its launching op stands in for the JAX tool's hlo_category: the
    kernel's `correlation` gives its `cuda_runtime` / `cuda_driver` launch
    event, and the innermost `cpu_op` or `terrain::<kernel>(<shape>)`
    annotation (ops/kernels/_build.CudaKernel.launch) around that launch
    on its thread is the op (the kernel's `External id` names the same
    innermost cpu_op); a replayed CUDA graph's kernels link to its
    `cudaGraphLaunch`.  A hand-written kernel whose launch cannot be linked
    is matched to its kernel's annotations by name and order, and the
    summary counts how many took that route;
  * its source is the nearest enclosing `user_annotation` other than a
    `terrain::` one, "(none)" where there is none;
  * the roofline unit is the launching op instance, which may launch
    several kernels (cuDNN's layout transposes with its conv).  Its bound
    (utils/roofline.bound_ms, H100 SXM data-sheet peaks) comes from the
    hand-written kernel's `cost()` for a `terrain::` annotation, and from
    `op_cost` for library ops: convolutions and their backward (FLOPs as
    torch.utils.flop_counter counts them), mm / addmm / bmm, and bytes
    alone for elementwise, copy and reduce ops, from the op's `Input Dims`,
    `Input type` and `Concrete Inputs`.  fp32 products are bounded at the
    CUDA cores' fp32 peak (device.strict_fp32 turns TF32 off), bf16 ones
    at the bf16 tensor cores'.  An op with no model has no bound (not 0);
    a graph replay's kernels have none.  headroom = measured - bound is
    what a perfect kernel could recover.

`--csv` writes the JAX tool's header; one row per kernel name and
launching op (`hlo_category` holds the op, `source` the annotation), and
family where a dW's shared kernel ran in a graph for several kernels.
`flops`, `bytes`, `bound_ms` and `headroom_ms` are filled only on rows
where every instance of the op launched that kernel alone, so a row's bound
is that kernel's.  tools/diff_traces.py reads two such CSVs.

The trace is read in one pass, decoded event by event (`load_events`), so
a 100 MB trace of a trainer epoch is never one object in memory.  A trace
with no device events, or a `terrain::` label this cannot parse, raises.

Usage: python -m terrain_tpu_torch.tools.summarize_trace <trace.json[.gz]>
       [--top 40] [--csv out]
"""

import argparse
import collections
import functools
import gzip
import json
import math
import re
import time

from terrain_tpu_torch.ops.kernels import all_kernels
from terrain_tpu_torch.utils import roofline

CHUNK = 1 << 22          # characters decoded at a time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = "cudaGraphLaunch"
LABEL_PREFIX = "terrain::"
LABEL = re.compile(r"terrain::(\w+)\((\w+=\w+(?:,\w+=\w+)*)?\)\Z")
# a csrc/common.cuh kernel that each dW entry point launches after its own
# kernel: it belongs to the entry point that launched it
SHARED_SYMBOLS = ("sum_partials_kernel",)
COPY_FAMILY = "copies and memsets"
# library families, tried in order on the kernel's name in lower case; no
# pattern may match a hand-written kernel's name (tests hold them to it)
FAMILIES = [
    ("cuDNN fprop", re.compile(r"fprop|implicit_convolve|precomputed_convolve"
                               r"|conv2d_grouped_direct")),
    ("cuDNN dgrad", re.compile(r"dgrad")),
    ("cuDNN wgrad", re.compile(r"wgrad")),
    ("GEMM", re.compile(r"gemm|gemv|cublas|cutlass::kernel|nvjet")),
    # cuDNN's layout, padding and scaling kernels beside its convolutions
    ("cuDNN other", re.compile(r"cudnn|convolve|addpaddingkernel")),
    ("NCCL", re.compile(r"nccl")),
    ("PyTorch reduce", re.compile(r"at::native::\w*reduce|reduce_kernel")),
    ("PyTorch elementwise", re.compile(
        r"elementwise_kernel|multi_tensor_apply")),
    ("PyTorch other", re.compile(r"at::native::")),
]
# the families that must be bounded (chip_smoke.py holds them to 99%)
LIBRARY_BOUNDED = ("cuDNN fprop", "cuDNN dgrad", "cuDNN wgrad", "GEMM")
HAND_PREFIX = "hand-written "


# ------------------------------------------------------------------ reading
class _Reader:
    """A JSON text read in chunks: whitespace and punctuation skipped by
    hand, each value decoded by json's own scanner."""

    _WS = re.compile(r"[ \t\n\r]*")

    def __init__(self, f):
        self.f = f
        self.buf = ""
        self.pos = 0
        self.dec = json.JSONDecoder()

    def _fill(self):
        more = self.f.read(CHUNK)
        if not more:
            return False
        self.buf = self.buf[self.pos:] + more
        self.pos = 0
        return True

    def char(self):
        """The next character that is not whitespace, consumed."""
        while True:
            self.pos = self._WS.match(self.buf, self.pos).end()
            if self.pos < len(self.buf):
                self.pos += 1
                return self.buf[self.pos - 1]
            if not self._fill():
                raise ValueError("the trace ends early")

    def peek(self):
        c = self.char()
        self.pos -= 1
        return c

    def value(self):
        self.peek()
        while True:
            try:
                v, end = self.dec.raw_decode(self.buf, self.pos)
            except json.JSONDecodeError:
                if not self._fill():
                    raise
                continue
            # a number may go on in the next chunk
            if end == len(self.buf) and self._fill():
                continue
            self.pos = end
            return v


def load_events(path, meta=None):
    """Yields the trace's events one at a time, decoded from its file (or
    its gzip) in chunks; the trace's other top-level keys go into `meta`
    when it is given (those after the events once they are read)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        r = _Reader(f)
        if r.char() != "{":
            raise ValueError(f"{path}: not a Chrome trace object")
        if r.peek() == "}":
            return
        while True:
            key = r.value()
            if r.char() != ":":
                raise ValueError(f"{path}: bad key {key!r}")
            if key == "traceEvents":
                if r.char() != "[":
                    raise ValueError(f"{path}: traceEvents is no list")
                if r.peek() == "]":
                    r.char()
                else:
                    while True:
                        yield r.value()
                        c = r.char()
                        if c == "]":
                            break
                        if c != ",":
                            raise ValueError(f"{path}: bad event list")
            else:
                v = r.value()
                if meta is not None:
                    meta[key] = v
            c = r.char()
            if c == "}":
                return
            if c != ",":
                raise ValueError(f"{path}: bad top-level object")


# ----------------------------------------------------------- kernel names
@functools.cache
def kernel_base(name):
    """The function's own name in a demangled kernel name:
    "void (anonymous namespace)::thin_fwd_kernel<float, 4>(...)" ->
    "thin_fwd_kernel"."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


@functools.cache
def hand_written():
    """{`__global__` name: CudaKernel} of the hand-written kernels."""
    return {k.symbol: k for k in all_kernels().values()}


def library_family(name):
    """The library family of a kernel name, "other" if none matches."""
    low = name.lower()
    for fam, pat in FAMILIES:
        if pat.search(low):
            return fam
    return "other"


@functools.cache
def family_of(name, cat="kernel"):
    """A device event's family from its name: a hand-written kernel's file
    ("hand-written conv_stem"), "copies and memsets", or a library family.
    None for a kernel that several hand-written entry points launch
    (SHARED_SYMBOLS): its family is its launcher's."""
    if cat != "kernel":
        return COPY_FAMILY
    base = kernel_base(name)
    k = hand_written().get(base)
    if k is not None:
        return HAND_PREFIX + k.source
    if base in SHARED_SYMBOLS:
        return None
    return library_family(name)


def parse_label(label):
    """"terrain::conv_thin(n=4,...,dtype=float32)" -> ("conv_thin",
    {"n": 4, ..., "dtype": "float32"}); raises on anything else."""
    m = LABEL.match(label)
    kern = m and all_kernels().get(m.group(1))
    if kern is None:
        raise ValueError(f"cannot parse the kernel label {label!r}")
    shape = {}
    for kv in (m.group(2) or "").split(","):
        if kv:
            k, v = kv.split("=")
            shape[k] = v if k == "dtype" else int(v)
    if tuple(shape) != kern.cost_args:
        raise ValueError(f"kernel label {label!r}: arguments "
                         f"{tuple(shape)}, expected {kern.cost_args}")
    return m.group(1), shape


# --------------------------------------------------------- library costs
_TYPES = {"float": "float32", "c10::BFloat16": "bfloat16",
          "c10::Half": "float16", "double": "float64", "long int": "int64",
          "int": "int32", "short int": "int16", "unsigned char": "uint8",
          "signed char": "int8", "bool": "bool"}
# ScalarType codes in Concrete Inputs (c10/core/ScalarType.h)
_CODES = {0: "uint8", 1: "int8", 2: "int16", 3: "int32", 4: "int64",
          5: "float16", 6: "float32", 7: "float64", 11: "bool",
          15: "bfloat16"}
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "where", "neg", "abs", "sgn", "sign",
    "pow", "sqrt", "rsqrt", "exp", "log", "tanh", "sigmoid", "relu",
    "leaky_relu", "leaky_relu_backward", "tanh_backward", "sigmoid_backward",
    "threshold_backward", "hardtanh", "clamp", "clamp_min", "clamp_max",
    "maximum", "minimum", "ge", "gt", "le", "lt", "eq", "ne", "addcdiv",
    "addcmul", "lerp", "square", "reciprocal", "masked_fill", "flip",
    "bitwise_and", "bitwise_or", "logical_not", "logical_and", "copy",
    "fill", "zero", "_to_copy", "clone", "isnan", "isinf", "round",
    "floor", "ceil", "trunc", "frac", "exp2", "log2", "sin", "cos"}
REDUCE = {"sum", "mean", "var", "std", "var_mean", "std_mean", "amax",
          "amin", "max", "min", "norm", "linalg_vector_norm", "prod", "any",
          "all", "argmax", "argmin", "nansum"}
_COMPARE = {"ge", "gt", "le", "lt", "eq", "ne", "isnan", "isinf",
            "logical_not", "logical_and"}
_CONV = {"aten::convolution", "aten::_convolution",
         "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
         "aten::convolution_backward"}
_GEMM = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"}


def _ints(s):
    return [int(v) for v in re.findall(r"-?\d+", s or "")]


def _prod(dims):
    return math.prod(dims) if dims else 1


def _tensors(dims, types):
    """[(numel, dtype name)] of an op's tensor arguments, lists spread and
    given the dtype of the first tensor argument; [] when that is not
    known (a tensor list alone: its dtype is not recorded)."""
    out = []
    for d, t in zip(dims, types):
        if t == "TensorList":
            out += [(_prod(x), None) for x in d]
        elif t in _TYPES:
            out.append((_prod(d), _TYPES[t]))
    first = next((t for _, t in out if t), None)
    if first is None:   # a list's dtype is not recorded
        return []
    return [(n, t or first) for n, t in out]


def _conv_out(x, w, stride, padding, dilation, transposed, out_pad):
    sp = []
    for i, size in enumerate(x[2:]):
        k = w[2 + i]
        s, p, d = stride[i], padding[i], dilation[i]
        if transposed:
            sp.append((size - 1) * s - 2 * p + d * (k - 1) + out_pad[i] + 1)
        else:
            sp.append((size + 2 * p - d * (k - 1) - 1) // s + 1)
    return [x[0], w[0], *sp]


def _conv_flops(x_shape, w_shape, out_shape, transposed):
    """torch.utils.flop_counter.conv_flop_count's count."""
    conv_shape = (x_shape if transposed else out_shape)[2:]
    c_out, c_in, *filt = w_shape
    return (_prod(conv_shape) * _prod(filt) * x_shape[0] * c_out * c_in
            * 2)


def _pad(v, n):
    return v * n if len(v) == 1 else v


def _conv_cost(name, dims, conc, types):
    es = roofline.itemsize(_TYPES[types[0]])
    if name == "aten::convolution_backward":
        # dX reads g and w and writes x's size; dW reads g and x and writes
        # w's size; db writes the bias
        go, x, w = dims[0], dims[1], dims[2]
        transposed = conc[7] == "True"
        dx, dw, db = (v == "True" for v in re.findall(r"True|False",
                                                      conc[10]))
        flops = 0
        if dx:
            flops += _conv_flops(go, w, x, not transposed)
        if dw:
            def t(s):
                return [s[1], s[0], *s[2:]]
            flops += (_conv_flops(t(go), t(x), t(w), False) if transposed
                      else _conv_flops(t(x), t(go), t(w), False))
        bias = _prod(_ints(conc[3])) if db else 0
        return flops, es * (_prod(go) + (dx + dw) * (_prod(x) + _prod(w))
                            + bias)
    x, w = dims[0], dims[1]
    nsp = len(x) - 2
    if name in ("aten::convolution", "aten::_convolution"):
        stride, padding, dilation = (_pad(_ints(conc[i]), nsp)
                                     for i in (3, 4, 5))
        transposed = conc[6] == "True"
        out_pad = _pad(_ints(conc[7]), nsp)
        groups = int(conc[8])
        bias = _prod(dims[2]) if dims[2] else 0
    elif name == "aten::cudnn_convolution":
        padding, stride, dilation = (_pad(_ints(conc[i]), nsp)
                                     for i in (2, 3, 4))
        transposed, out_pad, groups, bias = False, [0] * nsp, int(conc[5]), 0
    else:  # aten::cudnn_convolution_transpose
        padding, out_pad, stride, dilation = (_pad(_ints(conc[i]), nsp)
                                              for i in (2, 3, 4, 5))
        transposed, groups, bias = True, int(conc[6]), 0
    out = _conv_out(x, w, stride, padding, dilation, transposed, out_pad)
    if transposed:  # w is (C_in, C_out / groups, ...)
        out[1] = w[1] * groups
    flops = _conv_flops(x, w, out, transposed)
    return flops, es * (_prod(x) + _prod(w) + _prod(out) + bias)


def op_cost(name, args):
    """(flops, bytes, fp32) of one op instance from its recorded shapes, or
    None where the port has no model of the op (or its shapes were not
    recorded).  FLOPs of convolutions and products as
    torch.utils.flop_counter counts them; bytes: each tensor input read
    once, each output written once; elementwise ops count bytes alone (an
    out-of-place op's output the broadcast of its inputs, an in-place op's
    its first input), reductions their inputs alone."""
    dims = args.get("Input Dims")
    types = args.get("Input type")
    conc = args.get("Concrete Inputs")
    if dims is None or types is None:
        return None
    if name in _CONV:
        if types[0] not in ("float", "c10::BFloat16", "c10::Half"):
            return None
        flops, nbytes = _conv_cost(name, dims, conc or [""] * len(dims),
                                   types)
        return flops, nbytes, types[0] == "float"
    if name in _GEMM:
        if types[0] not in ("float", "c10::BFloat16", "c10::Half"):
            return None
        i = 1 if name in ("aten::addmm", "aten::baddbmm") else 0
        a, b = dims[i], dims[i + 1]
        flops = 2 * _prod(a) * b[-1]
        out = [*a[:-1], b[-1]]
        es = roofline.itemsize(_TYPES[types[0]])
        nbytes = es * (_prod(a) + _prod(b) + _prod(out)
                       + (_prod(dims[0]) if i else 0))
        return flops, nbytes, types[0] == "float"
    op = name.removeprefix("aten::")
    inplace = op.endswith("_") and not op.startswith("__")
    base = op.rstrip("_")
    ts = _tensors(dims, types)
    if not ts:
        return None

    def size(n, t):
        return n * roofline.itemsize(t)

    if base in REDUCE:
        return 0, sum(size(n, t) for n, t in ts), True
    if base == "cat":
        return 0, 2 * sum(size(n, t) for n, t in ts), True
    if base not in ELEMENTWISE:
        return None
    read = sum(size(n, t) for n, t in ts)
    if base in ("copy", "fill", "zero"):
        return 0, read, True       # src read, dst written; or dst written
    if inplace:
        return 0, read + size(*ts[0]), True
    n_out = max(n for n, _ in ts)
    t_out = ts[0][1]
    if base in _COMPARE:
        t_out = "bool"
    elif base == "_to_copy" and conc and len(conc) > 1 and conc[1]:
        t_out = _CODES.get(int(conc[1]), t_out)
    return 0, read + size(n_out, t_out), True


# --------------------------------------------------------------- summary
class OpStat:
    """Device time of one kernel name under one launching op."""

    __slots__ = ("ms", "calls", "family", "category", "source", "flops",
                 "bytes", "bound", "alone")

    def __init__(self, family, category, source):
        self.ms = 0.0
        self.calls = 0
        self.family = family
        self.category = category   # the launching op
        self.source = source
        self.flops = 0.0
        self.bytes = 0.0
        self.bound = 0.0           # ms, over the instances with a bound
        self.alone = True          # every instance launched this alone

    @property
    def bound_ms(self):
        """The row's bound, or None unless every instance of its op had a
        bound and launched this kernel alone."""
        return self.bound if self.alone else None

    @property
    def headroom_ms(self):
        b = self.bound_ms
        return None if b is None else self.ms - b


class Instance:
    """One launching op instance: its kernels' device time and its
    bound."""

    __slots__ = ("op", "key", "ms", "kernels", "cost", "bound", "source")

    def __init__(self, op, key, cost, source):
        self.op = op            # the launching op's name
        self.key = key          # op and shape, for the headroom table
        self.cost = cost        # (flops, bytes, fp32, tf32_passes) or None
        self.bound = (None if cost is None
                      else roofline.bound_ms(*cost)[0])
        self.ms = 0.0
        self.kernels = 0
        self.source = source


class Summary:
    """What `summarize` found.  `per_op` {(kernel name, launching op,
    family): OpStat} (the family differs for one name only where a shared
    kernel ran for several entry points under one op); `instances` the
    launching op instances; `families`
    {family: [ms, events, bounded ms]}; `hand` {hand-written kernel:
    {"events", "labels", "linked", "by_order", "ms"}}; `busy_ms` (sum of
    device event time), `union_ms` (their intervals' union over all
    streams), `wall_ms` (first device event's start to the last one's
    end); `sequence`, the device events [(ts, dur, name, family,
    Instance or None)] in time order; `meta`, the trace's top-level keys
    other than its events."""

    def __init__(self):
        self.per_op = {}
        self.instances = []
        self.families = collections.defaultdict(lambda: [0.0, 0, 0.0])
        self.hand = {}
        self.busy_ms = self.union_ms = self.wall_ms = 0.0
        self.devices = 0
        self.sequence = []
        self.unmatched = {}
        self.meta = {}
        self.seconds = 0.0

    @property
    def bounded_ms(self):
        return sum(v[2] for v in self.families.values())

    @property
    def bound_ms(self):
        return sum(i.bound for i in self.instances if i.bound is not None)


def _enclosing(ops, launches):
    """For each launch (tid, ts, index) the innermost op of `ops` (sorted
    (ts, -dur) per thread: [(ts, end, index)]) that holds it."""
    found = {}
    for tid, lst in launches.items():
        spans = ops.get(tid, [])
        lst.sort()
        stack = []
        j = 0
        for ts, idx in lst:
            while j < len(spans) and spans[j][0] <= ts:
                s = spans[j]
                while stack and stack[-1][1] < s[0]:
                    stack.pop()
                stack.append(s)
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            found[idx] = stack[-1][2] if stack else None
    return found


def _union(intervals):
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize(events, meta=None):
    """One pass over `events` (load_events), then the links; returns a
    Summary.  Raises if there is no device event or a `terrain::` label
    cannot be parsed."""
    t0 = time.perf_counter()
    hand = hand_written()
    devs = []       # (ts, dur, name, cat, stream, correlation)
    launch = {}     # correlation -> (name, (pid, tid), ts)
    ops = []        # (name, (pid, tid), ts, end, args, is label, is user)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a = e.get("args") or {}
            devs.append((e["ts"], e.get("dur", 0), e["name"], cat,
                         (e.get("pid"), a.get("stream", e.get("tid"))),
                         a.get("correlation")))
        elif cat in LAUNCH_CATS:
            a = e.get("args") or {}
            if "correlation" in a:
                launch[a["correlation"]] = (e["name"],
                                            (e["pid"], e["tid"]), e["ts"])
        elif cat in ("cpu_op", "user_annotation"):
            name = e["name"]
            is_label = name.startswith(LABEL_PREFIX)
            ops.append((name, (e["pid"], e["tid"]), e["ts"],
                        e["ts"] + e.get("dur", 0),
                        e.get("args") if cat == "cpu_op" else None,
                        is_label, cat == "user_annotation"))
    if not devs:
        raise ValueError("the trace holds no device events (kernels, "
                         "memcpys, memsets): was CUDA activity traced?")
    out = Summary()
    out.meta = dict(meta or {})

    # the labels: parsed once, counted per kernel
    labels = {}
    for i, o in enumerate(ops):
        if o[5]:
            labels[i] = parse_label(o[0])
    out.hand = {k.name: {"events": 0, "labels": 0, "linked": 0,
                         "by_order": 0, "ms": 0.0} for k in hand.values()}
    for kname, _ in labels.values():
        out.hand[kname]["labels"] += 1

    # each launch's innermost op (cpu_op or label) and source annotation
    by_tid, src_tid = collections.defaultdict(list), \
        collections.defaultdict(list)
    for i, o in enumerate(ops):
        if o[5] or not o[6]:     # a label or a cpu_op
            by_tid[o[1]].append((o[2], o[3], i))
        else:                    # another user annotation
            src_tid[o[1]].append((o[2], o[3], i))
    for d in (by_tid, src_tid):
        for v in d.values():
            v.sort(key=lambda s: (s[0], -s[1]))
    queries = collections.defaultdict(list)
    for corr, (_, tid, ts) in launch.items():
        queries[tid].append((ts, corr))
    op_of = _enclosing(by_tid, queries)
    src_of = _enclosing(src_tid, queries)

    # device events in time order on each stream
    order = sorted(range(len(devs)), key=lambda i: (devs[i][4], devs[i][0]))
    inst_of = {}     # op index or graph launch correlation -> Instance
    unlinked = collections.defaultdict(list)   # kernel -> [device index]
    assigned = [None] * len(devs)              # device index -> Instance
    fam = [None] * len(devs)
    prev_hand = {}   # stream -> (device index, CudaKernel) of its last
    shared_prev = {}  # shared kernel's device index -> its dW kernel's

    def instance(key, make):
        inst = inst_of.get(key)
        if inst is None:
            inst = inst_of[key] = make()
            out.instances.append(inst)
        return inst

    for i in order:
        ts, dur, name, cat, stream, corr = devs[i]
        f = family_of(name, cat)
        base = kernel_base(name) if cat == "kernel" else None
        kern = hand.get(base)
        ln = launch.get(corr)
        label = None
        if ln is not None and ln[0] == GRAPH_LAUNCH:
            inst = instance(("graph", corr), lambda: Instance(
                GRAPH_LAUNCH, GRAPH_LAUNCH, None, _source(ops, src_of[corr])))
        elif ln is not None and op_of.get(corr) is not None:
            j = op_of[corr]
            label = labels.get(j)
            inst = instance(j, lambda: _op_instance(ops, j, labels.get(j),
                                                    src_of.get(corr)))
        else:
            inst = None
        if base in SHARED_SYMBOLS:
            if label is not None:
                launcher = all_kernels()[label[0]]
            elif stream in prev_hand:
                shared_prev[i], launcher = prev_hand[stream]
            else:
                raise ValueError(f"{name} at {ts}: no hand-written kernel "
                                 f"ran before it on its stream")
            f = HAND_PREFIX + launcher.source
        elif kern is not None:
            prev_hand[stream] = (i, kern)
            h = out.hand[kern.name]
            h["events"] += 1
            h["ms"] += dur / 1e3
            if label is not None and label[0] == kern.name:
                h["linked"] += 1
            elif ln is None or ln[0] != GRAPH_LAUNCH:
                unlinked[kern.name].append(i)
        fam[i] = f
        assigned[i] = inst

    # unlinked hand-written kernels: their kernel's unused labels by order
    if unlinked:
        free = collections.defaultdict(list)
        for j in sorted(labels, key=lambda j: ops[j][2]):
            if j not in inst_of:
                free[labels[j][0]].append(j)
        for kname, idx in unlinked.items():
            idx.sort(key=lambda i: devs[i][0])
            for i, j in zip(idx, free[kname]):
                assigned[i] = instance(j, lambda j=j: _op_instance(
                    ops, j, labels[j], None))
                out.hand[kname]["by_order"] += 1
    # a shared kernel launched with no link goes with its dW kernel
    for i, k in shared_prev.items():
        if assigned[i] is None:
            assigned[i] = assigned[k]

    _aggregate(out, sorted(((devs[i][0], devs[i][1], devs[i][2], fam[i],
                             assigned[i]) for i in order),
                           key=lambda r: r[0]))
    out.seconds = time.perf_counter() - t0
    return out


def _aggregate(out, seq):
    """The per-kernel rows, families, instance totals and busy times of
    `seq`, the device events [(ts, dur, name, family, Instance or None)]
    in time order, into `out` (kept as `out.sequence`)."""
    out.sequence = seq
    for _, dur, name, f, inst in seq:
        ms = dur / 1e3
        if inst is not None:
            inst.ms += ms
            inst.kernels += 1
        op = inst.op if inst is not None else "(no op)"
        st = out.per_op.get((name, op, f))
        if st is None:
            src = inst.source if inst is not None else "(none)"
            st = out.per_op[(name, op, f)] = OpStat(f, op, src)
        st.ms += ms
        st.calls += 1
        fr = out.families[f]
        fr[0] += ms
        fr[1] += 1
        if inst is not None and inst.bound is not None:
            fr[2] += ms
    for _, _, name, f, inst in seq:
        op = inst.op if inst is not None else "(no op)"
        st = out.per_op[(name, op, f)]
        if inst is None or inst.bound is None or inst.kernels != 1:
            st.alone = False
        elif st.alone:
            st.flops += inst.cost[0]
            st.bytes += inst.cost[1]
            st.bound += inst.bound
    times = [(ts, ts + dur) for ts, dur, _, _, _ in seq]
    out.devices = len(seq)
    out.busy_ms = sum(e - s for s, e in times) / 1e3
    out.union_ms = _union(times) / 1e3
    out.wall_ms = (max(e for _, e in times) - min(s for s, _ in times)) / 1e3


def borrow_bounds(replay, eager, steps):
    """`replay`'s summary with the op instances of `eager`'s, an eager run
    of one of the replay's `steps` steps: a graph replay's kernels carry
    no op, but where the replay ran a kernel name `steps` times as often
    as the eager step did, its j-th kernel of that name takes the
    launching op, shape and bound of the name's (j mod count)-th eager
    kernel, one instance per step (by name and order: a graph may run
    independent kernels at once, so the interleaving of names may
    differ); its source reads cudaGraphLaunch.  Names run another number
    of times (work the graph does once a chunk, or the eager step alone)
    keep no bound and are listed in the result's `unmatched` {name:
    (replayed, eager)}.  Raises ValueError if no name matches."""
    graph = [r for r in replay.sequence
             if r[4] is not None and r[4].op == GRAPH_LAUNCH]
    ref = collections.defaultdict(list)
    for r in eager.sequence:
        ref[r[2]].append(r[4])
    seen = collections.Counter(r[2] for r in graph)
    unmatched = {n: (seen.get(n, 0), len(ref.get(n, ())))
                 for n in set(seen) | set(ref)
                 if seen.get(n, 0) != steps * len(ref.get(n, ()))}
    if not set(seen) - set(unmatched):
        raise ValueError(f"no kernel of the replay ran {steps} times as "
                         f"often as in the eager run")
    out = Summary()
    out.meta = replay.meta
    out.hand = replay.hand
    out.unmatched = unmatched
    made = {}

    def copy(key, inst, source):
        new = made.get(key)
        if new is None:
            new = made[key] = Instance(inst.op, inst.key, inst.cost, source)
            out.instances.append(new)
        return new

    seq, nth = [], collections.Counter()
    for ts, dur, name, f, inst in replay.sequence:
        if inst is not None and inst.op == GRAPH_LAUNCH \
                and name not in unmatched:
            j = nth[name]
            nth[name] += 1
            e_inst = ref[name][j % len(ref[name])]
            step = j // len(ref[name])
            inst = (None if e_inst is None else
                    copy((step, id(e_inst)), e_inst, GRAPH_LAUNCH))
        elif inst is not None:
            inst = copy(("own", id(inst)), inst, inst.source)
        seq.append((ts, dur, name, f, inst))
    _aggregate(out, seq)
    out.seconds = replay.seconds + eager.seconds
    return out


def _source(ops, j):
    return ops[j][0] if j is not None else "(none)"


def _op_instance(ops, j, label, src):
    name, _, _, _, args, _, _ = ops[j]
    if label is not None:
        kname, shape = label
        from terrain_tpu_torch.ops.kernels import cost

        flops, nbytes, passes = cost(kname, **shape)
        op = LABEL_PREFIX + kname
        key = name
        return Instance(op, key, (flops, nbytes,
                                  shape["dtype"] != "bfloat16", passes),
                        _source(ops, src))
    c = op_cost(name, args or {})
    dims = (args or {}).get("Input Dims")
    key = f"{name} {json.dumps(dims, separators=(',', ':'))}" \
        f" {(args or {}).get('Input type', [''])[0]}"
    return Instance(name, key, None if c is None else (*c, 0),
                    _source(ops, src))


# ----------------------------------------------------------------- report
def _short(s, n):
    return s if len(s) <= n else s[:n - 3] + "..."


def headroom_rows(summary):
    """[(key, ms, bound ms, calls, source)] of the bounded instances
    grouped by op and shape, most headroom first."""
    rows = {}
    for inst in summary.instances:
        if inst.bound is None:
            continue
        r = rows.setdefault(inst.key, [0.0, 0.0, 0, inst.source])
        r[0] += inst.ms
        r[1] += inst.bound
        r[2] += 1
    return sorted(((k, *v) for k, v in rows.items()),
                  key=lambda r: -(r[1] - r[2]))


def family_table(summary):
    """[(family, ms, share of busy, events, bounded share)], largest
    first."""
    busy = max(summary.busy_ms, 1e-12)
    return [(f, v[0], v[0] / busy, v[1], v[2] / v[0] if v[0] else 0.0)
            for f, v in sorted(summary.families.items(),
                               key=lambda kv: -kv[1][0])]


def report(summary, top=40, out=print):
    """The JAX tool's tables, in the port's terms."""
    s = summary
    busy = max(s.busy_ms, 1e-12)
    names = {name for name, _, _ in s.per_op}
    out(f"device kernels: {len(names)} distinct, {s.devices} events, "
        f"{s.busy_ms:.3f} ms busy (summed), {s.union_ms:.3f} ms busy (union "
        f"over streams), {s.wall_ms:.3f} ms wall (busy frac "
        f"{s.busy_ms / max(s.wall_ms, 1e-12):.3f} summed, "
        f"{s.union_ms / max(s.wall_ms, 1e-12):.3f} union)")
    out(f"roofline bound of the whole program: {s.bound_ms:.3f} ms over the "
        f"{100 * s.bounded_ms / busy:.1f}% of busy time that has a bound "
        f"({s.bounded_ms:.3f} ms; speed-of-light fraction there "
        f"{s.bound_ms / max(s.bounded_ms, 1e-12):.3f}); unbounded "
        f"{s.busy_ms - s.bounded_ms:.3f} ms "
        f"({100 * (1 - s.bounded_ms / busy):.1f}%)")
    out("\nby family (ms, % of busy, events, % of its ms bounded):")
    for fam, ms, share, n, bnd in family_table(s):
        out(f"  {fam:<30} {ms:10.3f} {100 * share:6.1f}% {n:7d} "
            f"{100 * bnd:6.1f}%")
    for title, key in (("launching op", lambda st: st.category),
                       ("source", lambda st: st.source)):
        agg = collections.defaultdict(float)
        for st in s.per_op.values():
            agg[key(st)] += st.ms
        out(f"\nby {title} (ms, % of busy), top {top}:")
        for k, ms in sorted(agg.items(), key=lambda kv: -kv[1])[:top]:
            out(f"  {ms:10.3f} {100 * ms / busy:6.1f}%  {_short(k, 70)}")
    rows = sorted(s.per_op.items(), key=lambda kv: -kv[1].ms)
    out(f"\ntop {top} kernels (ms total, calls, ms/call, launching op):")
    for (name, op, _), st in rows[:top]:
        out(f"  {st.ms:10.3f} {st.calls:6d} {st.ms / st.calls:8.4f}  "
            f"{_short(name, 56):<56} {_short(op, 36)}")
    out(f"\ntop {top} launching ops by roofline HEADROOM (measured - "
        "max(flops/peak, bytes/bw) of each instance; rank kernel work by "
        "this):")
    out("  headroom   measured      bound  xbound  calls  op / shape")
    for key, ms, bound, calls, src in headroom_rows(s)[:top]:
        if ms - bound <= 0:
            break
        out(f"  {ms - bound:8.3f} {ms:10.3f} {bound:10.3f} "
            f"{min(ms / max(bound, 1e-12), 999):6.1f} {calls:6d}  "
            f"{_short(key, 90)}" + ("" if src == "(none)" else f"  [{src}]"))


CSV_HEADER = ("op,total_ms,calls,ms_per_call,family,hlo_category,source,"
              "flops,bytes,bound_ms,headroom_ms")


def write_csv(summary, path):
    """One row per kernel name and launching op, the JAX tool's columns."""
    def q(v):
        return '"' + str(v).replace('"', '""') + '"'

    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for (name, op, _), st in sorted(summary.per_op.items(),
                                     key=lambda kv: -kv[1].ms):
            b = st.bound_ms
            tail = (f"{st.flops:.0f},{st.bytes:.0f},{b:.4f},"
                    f"{st.headroom_ms:.4f}" if b is not None else ",,,")
            f.write(f"{q(name)},{st.ms:.4f},{st.calls},"
                    f"{st.ms / st.calls:.5f},{q(st.family)},{q(op)},"
                    f"{q(st.source)},{tail}\n")


def run(argv=None, out=print):
    """The command line's work, its lines given to `out`; returns the
    Summary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    meta = {}
    s = summarize(load_events(args.trace, meta), meta)
    report(s, args.top, out)
    if args.csv:
        write_csv(s, args.csv)
        out(f"\nwrote {args.csv}")
    out(f"\nsummarized {args.trace} in {time.perf_counter() - t0:.2f} s")
    return s


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's trace summarizer (terrain_tpu_torch/tools/summarize_trace.py),
its cost models and the kernels' profiler labels, on the CPU.

The card's trace schema is held by the committed fixture
tests/data/trace/step.json.gz (tests/make_trace_fixture.py: the field
names torch 2.11's profiler writes on an NVIDIA H100 80GB HBM3), the
library cost model by a real CPU trace against torch.utils.flop_counter,
and the kernels' models by the bounds PERF.md §6 lists for the main shapes.
"""

import csv
import gzip
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from terrain_tpu_torch.ops.kernels import _build, all_kernels, cost
from terrain_tpu_torch.tools import summarize_trace as st
from terrain_tpu_torch.utils import profiling, roofline
from test_torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "data", "trace", "step.json.gz")
CSRC = os.path.join(ROOT, "terrain_tpu_torch", "ops", "kernels", "csrc")


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_trace_fixture", os.path.join(HERE, "make_trace_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _fixture_module()


@pytest.fixture(scope="module")
def summary():
    meta = {}
    return st.summarize(st.load_events(FIXTURE, meta), meta)


def test_the_fixture_is_what_its_script_writes():
    with gzip.open(FIXTURE, "rt") as f:
        assert json.load(f) == json.loads(json.dumps(FX.build()))


@pytest.mark.parametrize("chunk", [7, 1000, st.CHUNK])
def test_load_events_streams_what_json_loads(monkeypatch, tmp_path, chunk):
    """Events and top-level keys, decoded in chunks cut anywhere (inside
    numbers and strings too), from a gzip and from a plain file."""
    with gzip.open(FIXTURE, "rt") as f:
        whole = json.load(f)
    plain = tmp_path / "t.json"
    plain.write_text(json.dumps(whole, indent=2))
    monkeypatch.setattr(st, "CHUNK", chunk)
    for path in (FIXTURE, str(plain)):
        meta = {}
        assert list(st.load_events(path, meta)) == whole["traceEvents"]
        assert meta == {k: v for k, v in whole.items()
                        if k != "traceEvents"}


def test_family_rows_sum_to_busy_and_union(summary):
    want = FX.EXPECTED
    got = {f: round(v[0] * 1e3, 6) for f, v in summary.families.items()}
    assert got == {f: float(us) for f, us in want["families_us"].items()}
    assert summary.busy_ms == pytest.approx(want["busy_us"] / 1e3, abs=1e-9)
    assert sum(v[0] for v in summary.families.values()) == \
        pytest.approx(summary.busy_ms, rel=1e-12)
    # the all-reduce runs inside the add on the other stream
    assert summary.union_ms == pytest.approx(
        (want["busy_us"] - want["overlap_us"]) / 1e3, abs=1e-9)
    assert summary.devices == sum(v[1] for v in summary.families.values())


def test_kernels_link_to_their_launching_op(summary):
    ops = {}
    for (name, op, _), row in summary.per_op.items():
        ops.setdefault(st.kernel_base(name), set()).add(op)
    assert ops["nchwToNhwcKernel"] == {"aten::cudnn_convolution"}
    assert ops[st.kernel_base(FX.LIB["fprop"][0])] == \
        {"aten::cudnn_convolution"}
    assert ops["wgrad2d_grouped_direct_kernel"] == \
        {"aten::convolution_backward"}
    assert ops["splitKreduce_kernel"] == {"aten::mm"}
    assert ops["Memcpy DtoD"] == {"aten::copy_"}
    assert ops["Memset"] == {"aten::zero_"}
    # each hand-written kernel's launch sits in its label, inside the
    # autograd Function's cpu_op: the label is the innermost op
    for kern in all_kernels().values():
        assert f"terrain::{kern.name}" in ops[kern.symbol]
    assert ops["sum_partials_kernel"] == {
        "terrain::conv_thin_dw", "terrain::conv_stem_dw",
        "terrain::conv_s2_dw", st.GRAPH_LAUNCH}
    sources = {op: row.source for (name, op, _), row in summary.per_op.items()}
    assert sources["aten::cudnn_convolution"] == "train_step"
    assert sources["aten::convolution_backward"] == "(none)"
    assert sources[st.GRAPH_LAUNCH] == "replay"


def test_every_label_counts_its_kernel_once(summary):
    """Events, labels and the trace's launch counts agree; one pool2_fwd
    kernel has no launch event and is matched to its label by order."""
    launched = summary.meta["terrain_launches"]
    for name, h in summary.hand.items():
        graph = sum(1 for kind, what, _ in FX.GRAPH
                    if kind == "k" and what == name)
        assert h["events"] == launched[name] + graph, name
        assert h["labels"] == launched[name], name
        assert h["linked"] + h["by_order"] == launched[name], name
    assert summary.hand["pool2_fwd"]["by_order"] == 1
    assert sum(h["by_order"] for h in summary.hand.values()) == 1


def test_a_graph_replay_is_named_by_kernel_name(summary):
    rows = {(st.kernel_base(n), op, f): r for (n, op, f), r in
            summary.per_op.items() if op == st.GRAPH_LAUNCH}
    thin, stem = "hand-written conv_thin", "hand-written conv_stem"
    assert ("thin_fwd_kernel", st.GRAPH_LAUNCH, thin) in rows
    assert ("stem_dw_kernel", st.GRAPH_LAUNCH, stem) in rows
    # each sum of partials goes with the dW kernel before it on its stream
    assert rows[("sum_partials_kernel", st.GRAPH_LAUNCH, thin)].calls == 1
    assert rows[("sum_partials_kernel", st.GRAPH_LAUNCH, stem)].calls == 1
    fams = [summary.families["hand-written conv_thin"][0],
            summary.families["hand-written conv_stem"][0]]
    want = FX.EXPECTED["families_us"]
    assert [round(f * 1e3, 6) for f in fams] == \
        [want["hand-written conv_thin"], want["hand-written conv_stem"]]
    graph = [i for i in summary.instances if i.op == st.GRAPH_LAUNCH]
    assert len(graph) == 1 and graph[0].bound is None
    assert graph[0].kernels == len(FX.GRAPH)


def test_bounds_of_the_fixture(summary):
    """Every hand-written and cuDNN/GEMM op instance of the eager step has
    a bound; those that launch one kernel carry it on their CSV row."""
    for fam, (ms, _, bounded) in summary.families.items():
        eager_ms = ms - sum(r.ms for (n, op, _), r in summary.per_op.items()
                            if r.family == fam and op == st.GRAPH_LAUNCH)
        if fam in st.LIBRARY_BOUNDED or fam.startswith(st.HAND_PREFIX):
            assert bounded == pytest.approx(eager_ms, abs=1e-12), fam
    for fam in ("NCCL", "other"):
        assert summary.families[fam][2] == 0.0
    row = summary.per_op[(FX.KERNELS["bilinear_conv"],
                          "terrain::bilinear_conv",
                          "hand-written bilinear_conv")]
    assert row.bound_ms == pytest.approx(0.46857, abs=5e-5)
    assert row.headroom_ms == pytest.approx(1.162 - row.bound_ms)
    # a dW launches two kernels: its rows carry no bound
    assert summary.per_op[(FX.KERNELS["conv_stem_dw"],
                           "terrain::conv_stem_dw",
                           "hand-written conv_stem")].bound_ms is None
    conv = next(i for i in summary.instances
                if i.op == "aten::cudnn_convolution")
    flops = 2 * 4 * 64 * 128 * 128 * 64 * 9
    assert conv.cost[:3] == (flops, 4 * (2 * 4 * 64 * 128 * 128
                                         + 64 * 64 * 9), True)
    assert conv.bound == pytest.approx(flops / roofline.F32_PEAK * 1e3)
    assert conv.kernels == 2


def test_no_hand_written_kernel_reaches_a_library_family():
    """Every `__global__` of csrc/ is a kernel's symbol or a shared
    kernel, no library pattern matches one, and each symbol's family is
    its kernel's file."""
    globals_ = {}
    for fn in os.listdir(CSRC):
        with open(os.path.join(CSRC, fn)) as f:
            text = f.read()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(",
                             text):
            globals_[m.group(1)] = fn
    hand = st.hand_written()
    assert set(globals_) == set(hand) | set(st.SHARED_SYMBOLS)
    for sym, fn in globals_.items():
        for dressed in (sym, f"void (anonymous namespace)::{sym}<float>("
                             f"float const*, float*, int)",
                        f"(anonymous namespace)::{sym}(float const*)"):
            assert st.library_family(dressed) == "other", dressed
            if sym in hand:
                assert st.family_of(dressed) == \
                    st.HAND_PREFIX + hand[sym].source
                assert fn == hand[sym].source + ".cu"
            else:
                assert st.family_of(dressed) is None


@pytest.mark.parametrize("label", [
    "terrain::conv_thin_dw(x)", "terrain::no_such_kernel(n=1)",
    "terrain::conv_thin(n=4,h=256,w=256,c=64,dtype=float32)",
    "terrain::conv_thin(n=4,h=256,w=256,c=64,f=4,dtype=float32"])
def test_an_unparseable_label_raises(label):
    events = FX.build()["traceEvents"]
    for e in events:
        if e.get("name", "").startswith("terrain::conv_thin_dw("):
            e["name"] = label
            break
    with pytest.raises(ValueError, match="label"):
        st.summarize(iter(events))


def test_no_device_events_raises():
    events = [e for e in FX.build()["traceEvents"]
              if e.get("cat") not in st.DEVICE_CATS]
    with pytest.raises(ValueError, match="no device events"):
        st.summarize(iter(events))


def _jax_tool_header():
    with open(os.path.join(ROOT, "tools", "summarize_trace.py")) as f:
        text = f.read()
    m = re.search(r'f\.write\("(op,total_ms[^"]*)"\s*"([^"]*)\\n"\)', text)
    return m.group(1) + m.group(2)


def test_csv_has_the_jax_tools_header_and_diff_traces_reads_it(
        tmp_path, summary):
    assert st.CSV_HEADER == _jax_tool_header()
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    st.write_csv(summary, str(a))
    # the same trace with the dgrad kernel 1.5 ms longer
    trace = FX.build()
    for e in trace["traceEvents"]:
        if e.get("name") == FX.LIB["dgrad"][0]:
            e["dur"] += 1500.0
    st.write_csv(st.summarize(iter(trace["traceEvents"])), str(b))
    with open(a) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == st.CSV_HEADER.split(",")
    assert sum(float(r["total_ms"]) for r in rows) == \
        pytest.approx(summary.busy_ms, abs=1e-3)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "diff_traces.py"),
         str(a), str(b)], capture_output=True, text=True, check=True).stdout
    assert re.search(r"delta \+1\.5 ms", out), out
    assert re.search(r"\+1\.50\s+0\.31\s+1\.81\s+cuDNN dgrad", out), out
    assert re.search(r"\+1\.50\s+0\.60\s+2\.10\s+aten::convolution_backward",
                     out), out


def test_main_prints_the_tables(tmp_path, capsys):
    out_csv = tmp_path / "o.csv"
    assert st.main([FIXTURE, "--top", "5", "--csv", str(out_csv)]) == 0
    text = capsys.readouterr().out
    for head in ("device kernels: 26 distinct", "by family", "by launching op",
                 "by source", "top 5 kernels", "HEADROOM", "summarized"):
        assert head in text
    assert out_csv.exists()


def _profiled_convs(tmp_path):
    """A real CPU trace of conv2d forward and backward at stride 1 and 2
    and an mm, through utils/profiling.trace, and the same calls' count
    under FlopCounterMode."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 12, 10), generator=g, requires_grad=True)
    ws = [torch.randn((5, 3, 3, 3), generator=g, requires_grad=True),
          torch.randn((4, 3, 5, 5), generator=g, requires_grad=True)]
    b = torch.randn(5, generator=g, requires_grad=True)
    a, m = torch.randn((7, 9), generator=g), torch.randn((9, 6), generator=g)

    def calls():
        y1 = F.conv2d(x, ws[0], b, stride=1, padding=1)
        y2 = F.conv2d(x, ws[1], stride=2, padding=2)
        (y1.square().sum() + y2.sum()).backward()
        return torch.mm(a, m)

    with profiling.trace(str(tmp_path)):
        calls()
    counter = FlopCounterMode(display=False)
    with counter:
        calls()
    path = tmp_path / os.listdir(tmp_path)[0]
    return list(st.load_events(str(path))), counter.get_flop_counts()


def test_library_flops_equal_the_flop_counters(tmp_path):
    events, counts = _profiled_convs(tmp_path)
    got = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in (
                "aten::convolution", "aten::convolution_backward",
                "aten::mm"):
            c = st.op_cost(e["name"], e["args"])
            key = e["name"].removeprefix("aten::")
            got[key] = got.get(key, 0) + c[0]
    want = {str(k).split(".")[-1]: v
            for k, v in counts["Global"].items()}
    assert got == {k: want[k] for k in ("convolution",
                                        "convolution_backward", "mm")}
    assert set(got) == set(want)


def test_library_bytes_model():
    """Each input read once, each output written once: an in-place add
    reads both and writes its first; a reduction reads its input; a bf16
    conv counts two bytes an element and is bounded at the bf16 peak."""
    args = {"Input Dims": [[4, 8], [4, 8], []],
            "Input type": ["float", "float", "Scalar"],
            "Concrete Inputs": ["", "", "1"]}
    assert st.op_cost("aten::add_", args) == (0, 3 * 4 * 32, True)
    assert st.op_cost("aten::add", args) == (0, 3 * 4 * 32, True)
    assert st.op_cost("aten::sum", {
        "Input Dims": [[4, 8], [], [], []],
        "Input type": ["c10::BFloat16", "ScalarList", "Scalar", ""],
        "Concrete Inputs": ["", "[1]", "False", ""]}) == (0, 2 * 32, True)
    assert st.op_cost("aten::ge", {
        "Input Dims": [[4, 8], []], "Input type": ["float", "Scalar"],
        "Concrete Inputs": ["", "0"]}) == (0, 4 * 32 + 32, True)
    fwd = dict(FX.CONV_FWD)
    bf16 = {"Input Dims": fwd["dims"], "Concrete Inputs": fwd["conc"],
            "Input type": ["c10::BFloat16", "c10::BFloat16",
                           *fwd["types"][2:]]}
    flops, nbytes, fp32 = st.op_cost("aten::cudnn_convolution", bf16)
    assert (flops, fp32) == (2 * 4 * 64 * 128 * 128 * 64 * 9, False)
    assert nbytes == 2 * (2 * 4 * 64 * 128 * 128 + 64 * 64 * 9)
    bwd = {"Input Dims": FX.CONV_BWD["dims"],
           "Concrete Inputs": FX.CONV_BWD["conc"],
           "Input type": FX.CONV_BWD["types"]}
    flops, nbytes, _ = st.op_cost("aten::convolution_backward", bwd)
    assert flops == 2 * (2 * 4 * 64 * 128 * 128 * 64 * 9)
    x, w = 4 * 64 * 128 * 128, 64 * 64 * 9
    assert nbytes == 4 * (x + 2 * (x + w))
    assert st.op_cost("aten::upsample_nearest2d", args) is None
    assert st.op_cost("aten::cat", {"Input Dims": [[[2, 2], [2, 2]], []],
                                    "Input type": ["TensorList", "Scalar"],
                                    "Concrete Inputs": ["", "0"]}) is None


# PERF.md §6's bound column at the main path's shapes, (kernel, shape, dtype,
# bound ms to four digits)
PERF_BOUNDS = [
    ("bilinear_conv", dict(n=4, h=64, w=64, c=512, f=128), "float32", 0.4685),
    ("bilinear_conv", dict(n=4, h=64, w=64, c=512, f=128), "bfloat16",
     0.0782),
    ("conv_thin", dict(n=4, h=256, w=256, c=64, f=4), "float32", 0.0213),
    ("conv_thin", dict(n=4, h=256, w=256, c=64, f=4), "bfloat16", 0.0106),
    ("conv_thin_dx", dict(n=4, h=256, w=256, c=64, f=4), "float32", 0.0213),
    ("conv_thin_dx", dict(n=4, h=256, w=256, c=64, f=4), "bfloat16", 0.0106),
    ("conv_thin_dw", dict(n=4, h=256, w=256, c=64, f=4), "float32", 0.0213),
    ("conv_thin_dw", dict(n=4, h=256, w=256, c=64, f=4), "bfloat16", 0.0106),
    ("conv_stem_fwd", dict(n=8, h=512, w=512, f=64), "float32", 0.1628),
    ("conv_stem_fwd", dict(n=4, h=512, w=512, f=64), "float32", 0.0814),
    ("conv_stem_dw", dict(n=8, h=512, w=512, f=64, mask=1), "float32",
     0.3230),
    ("conv_stem_dw", dict(n=8, h=512, w=512, f=64, mask=1), "bfloat16",
     0.1615),
    ("conv_stem_dx", dict(n=4, h=512, w=512, f=64, mask=1), "float32",
     0.1615),
    ("conv_stem_dx", dict(n=4, h=512, w=512, f=64, mask=1), "bfloat16",
     0.0808),
    ("conv_s2_fwd", dict(n=4, h=512, w=512, c=1, f=64), "float32", 0.0213),
    ("conv_s2_fwd", dict(n=8, h=512, w=512, c=4, f=64), "float32", 0.0501),
    ("conv_s2_dw", dict(n=4, h=512, w=512, c=1, f=64, mask=0), "float32",
     0.0213),
    ("conv_s2_dw", dict(n=8, h=512, w=512, c=4, f=64, mask=1), "float32",
     0.0901),
    ("pool2_fwd", dict(n=8, h=512, w=512, c=64), "float32", 0.2003),
    ("pool2_bwd", dict(n=8, h=512, w=512, c=64), "float32", 0.3606),
    ("bilinear", dict(n=4, h=128, w=128, c=256), "float32", 0.1002),
]


@pytest.mark.parametrize("kernel,shape,dtype,want", PERF_BOUNDS)
def test_cost_gives_perfs_bound_column(kernel, shape, dtype, want):
    flops, nbytes, passes = cost(kernel, dtype=dtype, **shape)
    ms, _ = roofline.bound_ms(flops, nbytes, dtype == "float32", passes)
    assert round(ms, 4) == want


def test_every_entry_point_has_a_cost_and_a_bound_row():
    assert {k for k, *_ in PERF_BOUNDS} == set(all_kernels())
    for name, kern in all_kernels().items():
        assert kern.cost_args[-1] == "dtype" or "dtype" in kern.cost_args


def _stub_kernel(monkeypatch):
    k = _build.CudaKernel("conv_thin", "conv_thin_launch", [],
                          name="conv_thin", symbol="thin_fwd_kernel",
                          cost_args=("n", "h", "w", "c", "f", "dtype"))
    monkeypatch.setattr(k, "_fn", lambda *args: 0)  # the C entry point
    return k


def test_launch_labels_its_call_under_a_profiler(monkeypatch, tmp_path):
    k = _stub_kernel(monkeypatch)
    shape = (4, 256, 256, 64, 4, torch.float32)
    with profiling.trace(str(tmp_path)):
        k.launch(1, 2, shape=shape)
    path = tmp_path / os.listdir(tmp_path)[0]
    meta = {}
    names = [e["name"] for e in st.load_events(str(path), meta)
             if e.get("cat") == "user_annotation"]
    assert names == ["terrain::conv_thin(n=4,h=256,w=256,c=64,f=4,"
                     "dtype=float32)"]
    assert st.parse_label(names[0]) == ("conv_thin", dict(
        n=4, h=256, w=256, c=64, f=4, dtype="float32"))
    assert k.launches == 1
    # trace() records shapes and the counters' increase over the block
    assert meta["record_shapes"] == 1
    assert set(meta[profiling.LAUNCHES_KEY]) == set(all_kernels())


def test_launch_opens_nothing_without_a_profiler(monkeypatch):
    k = _stub_kernel(monkeypatch)

    def opened(*a, **kw):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", opened)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", opened)
    k.launch(1, 2, shape=(4, 256, 256, 64, 4, torch.float32))
    assert k.launches == 1


def test_labelled_is_the_profiler_check(monkeypatch):
    k = _stub_kernel(monkeypatch)
    assert not k.labelled()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert k.labelled()
    assert not k.labelled()


def test_trace_writes_the_registered_counts(monkeypatch, tmp_path):
    """trace() reads the counts that other layers register with it (the
    kernels' launches among them) before and after its block."""
    calls = {"n": 0}
    monkeypatch.setattr(profiling, "_COUNTERS", profiling._COUNTERS + [
        lambda: {"probe": calls["n"]}])
    calls["n"] = 5
    with profiling.trace(str(tmp_path)):
        calls["n"] += 3
    meta = {}
    list(st.load_events(str(tmp_path / os.listdir(tmp_path)[0]), meta))
    got = meta[profiling.LAUNCHES_KEY]
    assert got["probe"] == 3
    assert set(got) == set(all_kernels()) | {"probe"}


def test_chip_smokes_device_rows_leave_the_labels_out():
    """A label's device span (gpu_user_annotation) repeats the time of the
    kernels inside it, so the script's device sums leave it out, as
    torch's own table does; CPU rows are left out too."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    class Row:
        def __init__(self, key, dev, label):
            self.key, self.is_user_annotation = key, label
            self.device_type = f"DeviceType.{dev}"

    class Prof:
        def key_averages(self):
            return [Row("thin_fwd_kernel", "CUDA", False),
                    Row("terrain::conv_thin(n=4)", "CUDA", True),
                    Row("terrain::conv_thin(n=4)", "CPU", True),
                    Row("aten::conv2d", "CPU", False)]

    assert [r.key for r in cs.device_rows(Prof())] == ["thin_fwd_kernel"]


@pytest.mark.parametrize("extra, lost_ok, raised", [
    (1, True, "LostEvents"), (1, False, "ran 1 times"),
    (-1, True, "ran 1 times")])
def test_chip_smokes_replay_check_traces_again_only_on_a_shortfall(
        summary, capsys, extra, lost_ok, raised):
    """A traced replay whose hand-written kernels hold fewer events than
    its steps launched, and none more, raises LostEvents where the caller
    may trace it again (the profiler dropped device records); without
    that leave, or with more events than launched, the check fails."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    grid = {n: h["events"] for n, h in summary.hand.items() if h["events"]}
    assert grid["bilinear_conv"] == 1
    grid["bilinear_conv"] += extra
    with pytest.raises((cs.LostEvents, SystemExit)) as e:
        cs.summarize_checked(None, "cpu", "replay", per_step=(1, grid),
                             summary=summary, bounded=False,
                             lost_ok=lost_ok)
    got = (type(e.value).__name__ if isinstance(e.value, cs.LostEvents)
           else capsys.readouterr().out)
    assert raised in got


def _eager_of_the_graph():
    """An eager run of the fixture's replayed step: the same kernels, each
    launched in its label or op."""
    tr = FX._Trace()
    t = FX.T0
    shapes = {k: shape for k, _, shape, _ in FX.HAND}
    fns = {k: fn for k, fn, _, _ in FX.HAND}
    for kind, what, us in FX.GRAPH:
        if kind == "k":
            t = FX._hand(tr, t, what, fns[what], shapes[what], us, FX.HOST)
        elif kind == "lib":
            t = FX._lib(tr, t, "aten::mul", [FX.LIB[what]], FX.HOST,
                        {"dims": [[4, 256, 256, 64], []], "conc": ["", "2"],
                         "types": ["float", "Scalar"]})
    return st.summarize(iter(tr.events))


def test_a_replay_borrows_the_eager_steps_bounds(summary):
    eager = _eager_of_the_graph()
    got = st.borrow_bounds(summary, eager, 1)
    assert got.unmatched == {}
    graph = [r for r in got.sequence if r[4] is not None
             and r[4].source == st.GRAPH_LAUNCH]
    assert [r[4].op for r in graph] == [
        "terrain::conv_thin", "aten::mul", "terrain::conv_thin_dw",
        "terrain::conv_thin_dw", "terrain::conv_stem_dw",
        "terrain::conv_stem_dw"]
    assert all(r[4].bound is not None for r in graph)
    assert got.busy_ms == pytest.approx(summary.busy_ms)
    assert got.families.keys() == summary.families.keys()
    for fam, (ms, n, bounded) in got.families.items():
        assert ms == pytest.approx(summary.families[fam][0]), fam
        if fam in st.LIBRARY_BOUNDED or fam.startswith(st.HAND_PREFIX):
            assert bounded == pytest.approx(ms), fam
    # the eager summary's instances are untouched
    assert sum(i.ms for i in eager.instances) == \
        pytest.approx(eager.busy_ms)
    # a kernel the eager run launched another number of times (here the
    # last sum of partials dropped) borrows nothing; no match at all raises
    fewer = _eager_of_the_graph()
    fewer.sequence = fewer.sequence[:-1]
    part = st.borrow_bounds(summary, fewer, 1)
    assert part.unmatched == {FX.SUM_PARTIALS: (2, 1)}
    sums = [r[4] for r in part.sequence if r[2] == FX.SUM_PARTIALS
            and r[4].op == st.GRAPH_LAUNCH]
    assert len(sums) == 2 and all(i.bound is None for i in sums)
    with pytest.raises(ValueError, match="no kernel of the replay"):
        st.borrow_bounds(eager, summary, 1)
    with pytest.raises(ValueError, match="no kernel of the replay"):
        st.borrow_bounds(summary, eager, 2)

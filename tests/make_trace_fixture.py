"""Write tests/data/trace/: a torch.profiler Chrome trace of a made-up train
step, in the schema and with the field names that torch 2.11's profiler
(CUPTI 26, CUDA runtime 12.8) writes on an NVIDIA H100 80GB HBM3 for the
port's hand-written kernels (a static-cudart ctypes library) and for
PyTorch's and cuDNN's own.

The step: on the host thread, a `train_step` annotation around the
forwards (a cuDNN convolution with its layout transpose, the hand-written
forwards each inside its autograd Function's cpu_op and its
`terrain::<kernel>(<shape>)` label, an mm, an add, a sum, a copy, a zero,
an NCCL all-reduce on a second stream inside an add's kernel, a kernel of an
unknown library); on the autograd thread the backward (a cuDNN
convolution backward with its dgrad and wgrad kernels, the hand-written
gradients, a dW entry point's sum of partials after its kernel).  One
pool2_fwd launch has no runtime event (its kernel can be matched to its
label only by name and order).  Then a `replay` annotation around a
cudaGraphLaunch whose kernels run on the first stream.  Every one of the
twelve hand-written entry points has a label, at its main path's shape.

Each device event's duration is a whole number of microseconds, so the
sums the tests expect are exact.  `EXPECTED` holds them.

Usage: python tests/make_trace_fixture.py   (rewrites the fixture)
"""

import gzip
import json
import os

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "trace", "step.json.gz")
PID, HOST, AUTOGRAD = 118, 118, 343
MAIN, SIDE = 7, 13                     # streams
T0 = 1479113424000.0                   # us, as Kineto writes them

# the hand-written kernels as the profiler names them
KERNELS = {
    "bilinear_conv": "void (anonymous namespace)::bilinear_conv_kernel<float>"
                     "(float const*, float const*, float const*, float*, int,"
                     " int, int, int, int)",
    "conv_thin": "void (anonymous namespace)::thin_fwd_kernel<float, 4>(float"
                 " const*, float const*, float*, int, int, int, int, long "
                 "long, int)",
    "conv_thin_dx": "void (anonymous namespace)::thin_dx_kernel<float, 4>("
                    "float const*, float const*, float*, int, int, int, int, "
                    "long long, int)",
    "conv_thin_dw": "void (anonymous namespace)::thin_dw_kernel<float, 4>("
                    "float const*, float const*, float*, int, int, int, int, "
                    "long long, int)",
    "conv_stem_fwd": "void (anonymous namespace)::stem_fwd_kernel<float, "
                     "true>(float const*, float const*, float const*, float*,"
                     " int, int, int, float, int, int)",
    "conv_stem_dw": "void (anonymous namespace)::stem_dw_kernel<float, true>("
                    "float const*, float const*, float const*, float*, int, "
                    "int, int, float, int, int)",
    "conv_stem_dx": "void (anonymous namespace)::stem_dx_kernel<float, true>("
                    "float const*, float const*, float const*, float*, int, "
                    "int, int, float, int, long long, int)",
    "conv_s2_fwd": "void (anonymous namespace)::s2_fwd_kernel<float, 1, "
                   "false>(float const*, float const*, float const*, float*,"
                   " int, int, int, float)",
    "conv_s2_dw": "void (anonymous namespace)::s2_dw_kernel<float, 1, false>("
                  "float const*, float const*, float const*, float*, int, "
                  "int, int, float, int, int)",
    "pool2_fwd": "void (anonymous namespace)::pool2_fwd_kernel<float>(float "
                 "const*, float*, int, int, int, unsigned long)",
    "pool2_bwd": "void (anonymous namespace)::pool2_bwd_kernel<float>(float "
                 "const*, float const*, float*, int, int, int, unsigned "
                 "long)",
    "bilinear": "(anonymous namespace)::bilinear_2x_kernel(float const*, "
                "float*, int, int, int, unsigned long)",
}
SUM_PARTIALS = "sum_partials_kernel(float const*, float*, int, int)"
# each entry point's autograd Function cpu_op, label shape and duration (us)
HAND = [
    # forwards, host thread
    ("bilinear_conv", "BilinearConvFn",
     "n=4,h=64,w=64,c=512,f=128,dtype=float32", 1162),
    ("conv_thin", "ConvThinFn", "n=4,h=256,w=256,c=64,f=4,dtype=float32", 60),
    ("conv_stem_fwd", "ConvStemFn", "n=8,h=512,w=512,f=64,dtype=float32",
     400),
    ("conv_s2_fwd", "ConvS2Fn", "n=4,h=512,w=512,c=1,f=64,dtype=float32", 55),
    ("pool2_fwd", "Pool2Fn", "n=8,h=512,w=512,c=64,dtype=float32", 241),
    ("bilinear", "Bilinear2xFn", "n=4,h=128,w=128,c=256,dtype=float32", 136),
    # backwards, autograd thread
    ("conv_thin_dx", "ConvThinFnBackward",
     "n=4,h=256,w=256,c=64,f=4,dtype=float32", 65),
    ("conv_thin_dw", "ConvThinFnBackward",
     "n=4,h=256,w=256,c=64,f=4,dtype=float32", 72),
    ("conv_stem_dw", "ConvStemFnBackward",
     "n=8,h=512,w=512,f=64,mask=1,dtype=float32", 407),
    ("conv_stem_dx", "ConvStemFnBackward",
     "n=4,h=512,w=512,f=64,mask=1,dtype=float32", 361),
    ("conv_s2_dw", "ConvS2FnBackward",
     "n=4,h=512,w=512,c=1,f=64,mask=0,dtype=float32", 87),
    ("pool2_bwd", "Pool2FnBackward", "n=8,h=512,w=512,c=64,dtype=float32",
     413),
]
SUM_US = 4           # each sum of partials
UNLINKED = ("pool2_fwd", 240)   # a second launch with no runtime event
CONV_FWD = {"name": "aten::cudnn_convolution",
            "dims": [[4, 64, 128, 128], [64, 64, 3, 3]],
            "conc": ["", "", "[1, 1]", "[1, 1]", "[1, 1]", "1", "False",
                     "True", "False"],
            "types": ["float", "float", "ScalarList", "ScalarList",
                      "ScalarList", "Scalar", "Scalar", "Scalar", "Scalar"]}
CONV_BWD = {"name": "aten::convolution_backward",
            "dims": [[4, 64, 128, 128], [4, 64, 128, 128], [64, 64, 3, 3],
                     [], [], [], [], [], [], [], []],
            "conc": ["", "", "", "[0]", "[1, 1]", "[1, 1]", "[1, 1]",
                     "False", "[0, 0]", "1", "[True, True, False]"],
            "types": ["float", "float", "float", "ScalarList", "ScalarList",
                      "ScalarList", "ScalarList", "Scalar", "ScalarList",
                      "Scalar", "ScalarList"]}
LIB = {
    "layout": ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, "
               "float, float, false, true, (cudnnKernelDataType_t)0>("
               "cudnn::engines_precompiled::nchw2nhwc_params_t<float>, float "
               "const*, float*)", 10),
    "fprop": ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc"
              "_tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_"
              "off_kernel__5x_cudnn", 300),
    "dgrad": ("sm90_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc"
              "_tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_"
              "off_kernel__5x_cudnn", 310),
    "wgrad": ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<false, true, "
              "int, float, float, float>(cudnn::cnn::WgradGroupedDirectParams"
              ", float const*, float const*, float*, float, float)", 290),
    "gemm": ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1"
             ">(cutlass_80_simt_sgemm_64x64_8x5_nn_align1::Params)", 5),
    "splitk": ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float,"
               " float, float, false, float, float, float, true, false, false"
               ">(cublasLt::cublasSplitKParams<float>, float const*, float "
               "const*, float*, float const*, float const*, float const*, "
               "float const*, float*, void*, long, float*, int*, float*, "
               "float*, float const*, float const*, float const*, float "
               "const*, float const*)", 2),
    "add": ("void at::native::vectorized_elementwise_kernel<4, at::native::"
            "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native"
            "::CUDAFunctor_add<float>, std::array<char*, 3ul>)", 50),
    "sum": ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<"
            "float, at::native::func_wrapper_t<float, at::native::sum_functor"
            "<float, float, float>::operator()(at::TensorIterator&)::{lambda("
            "float, float)#1}>, unsigned int, float, 4, 4> >(at::native::"
            "ReduceOp<float, at::native::func_wrapper_t<float, at::native::"
            "sum_functor<float, float, float>::operator()(at::Tensor"
            "Iterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, "
            "4>)", 40),
    "nccl": ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned "
             "long, ncclWork*)", 30),
    "other": ("void my_extension::special_kernel<float>(float*, int)", 7),
    "mul": ("void at::native::vectorized_elementwise_kernel<4, at::native::"
            "AUnaryFunctor<float, float, float, at::native::binary_internal::"
            "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
            "AUnaryFunctor<float, float, float, at::native::binary_internal::"
            "MulFunctor<float> >, std::array<char*, 2ul>)", 20),
}
MEMCPY_US, MEMSET_US = 3, 1
# the NCCL kernel runs on the side stream wholly inside the add's kernel
NCCL_AFTER_ADD_US = 10
# the replayed graph: kernels in order on the first stream
GRAPH = [("k", "conv_thin", 45), ("lib", "mul", 20), ("k", "conv_thin_dw", 50),
         ("sum", None, SUM_US), ("k", "conv_stem_dw", 400),
         ("sum", None, SUM_US)]


class _Trace:
    def __init__(self):
        self.events = []
        self.ext = 1000
        self.corr = 40000
        self.dev_t = {MAIN: T0 + 5000.0, SIDE: T0 + 5000.0}

    def op(self, name, ts, dur, tid=HOST, cat="cpu_op", shapes=None,
           fn=False):
        self.ext += 1
        args = {"External id": self.ext, "Record function id": 0}
        if fn:
            args.update({"Sequence number": self.ext, "Fwd thread id":
                         int(tid == AUTOGRAD)})
        if shapes is not None:
            args.update({"Concrete Inputs": shapes["conc"],
                         "Input type": shapes["types"],
                         "Input Strides": [[] for _ in shapes["dims"]],
                         "Input Dims": shapes["dims"]})
        args["Ev Idx"] = len(self.events)
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": PID,
                            "tid": tid, "ts": ts, "dur": dur, "args": args})
        return self.ext

    def launch(self, ts, tid, ext, name="cudaLaunchKernel", cbid=211):
        self.corr += 1
        args = {"cbid": cbid, "correlation": self.corr}
        if ext is not None:
            args = {"External id": ext, **args}
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                            "pid": PID, "tid": tid, "ts": ts, "dur": 5.0,
                            "args": args})
        self.events.append({"ph": "s", "id": self.corr, "pid": PID,
                            "tid": tid, "ts": ts, "cat": "ac2g",
                            "name": "ac2g"})
        return self.corr

    def device(self, name, dur, corr, ext, stream=MAIN, cat="kernel",
               start=None):
        ts = self.dev_t[stream] if start is None else start
        self.dev_t[stream] = max(self.dev_t[stream], ts + dur) + 2.0
        if cat == "kernel":
            args = {"queued": 0, "device": 0, "context": 1, "stream": stream,
                    "correlation": corr, "registers per thread": 32,
                    "shared memory": 0, "blocks per SM": 2.0,
                    "warps per SM": 16.0, "grid": [264, 1, 1],
                    "block": [256, 1, 1], "est. achieved occupancy %": 0}
        else:
            nbytes = 32768
            args = {"device": 0, "context": 1, "stream": stream,
                    "correlation": corr, "bytes": nbytes,
                    "memory bandwidth (GB/s)": nbytes / dur / 1e3}
        if ext is not None:
            args = {"External id": ext, **args}
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                            "tid": stream, "ts": ts, "dur": float(dur),
                            "args": args})
        self.events.append({"ph": "f", "id": corr, "pid": 0, "tid": stream,
                            "ts": ts, "cat": "ac2g", "name": "ac2g",
                            "bp": "e"})
        return ts


def _lib(tr, t, op, kernels, tid, shapes=None, runtime="cudaLaunchKernel",
         cat="kernel", stream=MAIN, start=None):
    """A library op at host time t launching `kernels` [(name, us)]."""
    ext = tr.op(op, t, 40.0 + 10 * len(kernels), tid, shapes=shapes)
    for i, (name, us) in enumerate(kernels):
        corr = tr.launch(t + 5 + 10 * i, tid, ext, runtime,
                         {"cudaLaunchKernel": 211, "cudaMemcpyAsync": 41,
                          "cudaMemsetAsync": 51}[runtime])
        tr.device(name, us, corr, ext, stream, cat, start)
    return t + 100.0


def _hand(tr, t, kernel, fn, shape, us, tid, linked=True):
    """An entry point inside its Function's cpu_op and its label."""
    ext = tr.op(fn, t, 60.0, tid, fn=True)
    tr.op(f"terrain::{kernel}({shape})", t + 5, 40.0, tid,
          cat="user_annotation")
    corr = tr.launch(t + 10, tid, ext) if linked else tr.corr + 90000
    tr.device(KERNELS[kernel], us, corr, ext)
    if kernel.endswith("_dw"):
        tr.device(SUM_PARTIALS, SUM_US, tr.launch(t + 20, tid, ext), ext)
    return t + 100.0


def build():
    """The fixture's top-level object."""
    tr = _Trace()
    tr.events += [
        {"name": "process_name", "ph": "M", "ts": T0, "pid": PID, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "ts": T0, "pid": PID,
         "tid": 0, "args": {"labels": "CPU"}},
        {"name": "process_name", "ph": "M", "ts": T0, "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "ts": T0, "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        *({"name": "thread_name", "ph": "M", "ts": T0, "pid": 0, "tid": s,
           "args": {"name": f"stream {s} "}} for s in (MAIN, SIDE)),
        {"name": "thread_name", "ph": "M", "ts": T0, "pid": PID,
         "tid": HOST, "args": {"name": f"thread {HOST} (python3)"}},
        {"name": "thread_name", "ph": "M", "ts": T0, "pid": PID,
         "tid": AUTOGRAD, "args": {"name": f"thread {AUTOGRAD} "
                                           "(pt_autograd_0)"}}]
    t = T0 + 100.0
    tr.op("train_step", t, 20000.0, HOST, cat="user_annotation")
    t += 10
    t = _lib(tr, t, CONV_FWD["name"], [LIB["layout"], LIB["fprop"]], HOST,
             CONV_FWD)
    for kernel, fn, shape, us in HAND[:6]:
        t = _hand(tr, t, kernel, fn, shape, us, HOST)
    t = _hand(tr, t, UNLINKED[0], "Pool2Fn", HAND[4][2], UNLINKED[1], HOST,
              linked=False)
    t = _lib(tr, t, "aten::mm", [LIB["gemm"], LIB["splitk"]], HOST,
             {"dims": [[64, 128], [128, 32]], "conc": ["", ""],
              "types": ["float", "float"]})
    add_start = tr.dev_t[MAIN]
    t = _lib(tr, t, "aten::add", [LIB["add"]], HOST,
             {"dims": [[4, 64, 128, 128], [4, 64, 128, 128], []],
              "conc": ["", "", "1"], "types": ["float", "float", "Scalar"]})
    t = _lib(tr, t, "nccl:all_reduce", [LIB["nccl"]], HOST, stream=SIDE,
             start=add_start + NCCL_AFTER_ADD_US)
    t = _lib(tr, t, "aten::sum", [LIB["sum"]], HOST,
             {"dims": [[4, 64, 128, 128], [], [], []],
              "conc": ["", "[0, 2, 3]", "False", ""],
              "types": ["float", "ScalarList", "Scalar", ""]})
    t = _lib(tr, t, "aten::copy_", [("Memcpy DtoD (Device -> Device)",
                                     MEMCPY_US)], HOST,
             {"dims": [[4, 64, 16, 16], [4, 64, 16, 16], []],
              "conc": ["", "", "False"],
              "types": ["float", "float", "Scalar"]},
             runtime="cudaMemcpyAsync", cat="gpu_memcpy")
    t = _lib(tr, t, "aten::zero_", [("Memset (Device)", MEMSET_US)], HOST,
             {"dims": [[8]], "conc": [""], "types": ["float"]},
             runtime="cudaMemsetAsync", cat="gpu_memset")
    t = _lib(tr, t, "my::op", [LIB["other"]], HOST)
    # the backward, on the autograd thread
    t = _lib(tr, t, CONV_BWD["name"], [LIB["dgrad"], LIB["wgrad"]],
             AUTOGRAD, CONV_BWD)
    for kernel, fn, shape, us in HAND[6:]:
        t = _hand(tr, t, kernel, fn, shape, us, AUTOGRAD)
    # one replay of a captured graph
    t = T0 + 30000.0
    tr.op("replay", t, 2000.0, HOST, cat="user_annotation")
    corr = tr.launch(t + 10, HOST, None, "cudaGraphLaunch", 311)
    for kind, what, us in GRAPH:
        name = (KERNELS[what] if kind == "k" else LIB[what][0] if kind ==
                "lib" else SUM_PARTIALS)
        tr.device(name, us, corr, None)
    launched = {k: 1 for k in KERNELS}
    launched[UNLINKED[0]] += 1
    return {"schemaVersion": 1,
            "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3",
                                  "computeMajor": 9, "computeMinor": 0,
                                  "numSms": 132}],
            "record_shapes": 1,
            "terrain_launches": launched,
            "cuda_driver_version": 13000, "cuda_runtime_version": 12080,
            "cupti_version": 26, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": 1790857026000000000,
            "traceEvents": tr.events, "traceName": "step.json"}


def _expected():
    hw = {"bilinear_conv": "bilinear_conv", "conv_thin": "conv_thin",
          "conv_thin_dx": "conv_thin", "conv_thin_dw": "conv_thin",
          "conv_stem_fwd": "conv_stem", "conv_stem_dw": "conv_stem",
          "conv_stem_dx": "conv_stem", "conv_s2_fwd": "conv_s2",
          "conv_s2_dw": "conv_s2", "pool2_fwd": "pool2",
          "pool2_bwd": "pool2", "bilinear": "bilinear"}
    fam = {}

    def add(f, us):
        fam[f] = fam.get(f, 0) + us

    for kernel, _, _, us in HAND:
        add("hand-written " + hw[kernel], us
            + (SUM_US if kernel.endswith("_dw") else 0))
    add("hand-written pool2", UNLINKED[1])
    for key, f in (("layout", "cuDNN other"), ("fprop", "cuDNN fprop"),
                   ("dgrad", "cuDNN dgrad"), ("wgrad", "cuDNN wgrad"),
                   ("gemm", "GEMM"), ("splitk", "GEMM"),
                   ("add", "PyTorch elementwise"), ("sum", "PyTorch reduce"),
                   ("nccl", "NCCL"), ("other", "other")):
        add(f, LIB[key][1])
    add("copies and memsets", MEMCPY_US + MEMSET_US)
    for kind, what, us in GRAPH:
        f = ("hand-written " + hw[what] if kind == "k" else
             "PyTorch elementwise" if kind == "lib" else None)
        if f is None:   # the sum of partials: the dW kernel before it
            f = fam_last
        add(f, us)
        fam_last = f
    return {"families_us": fam, "busy_us": sum(fam.values()),
            "overlap_us": LIB["nccl"][1]}


EXPECTED = _expected()


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    data = json.dumps(build(), indent=1).encode()
    with open(OUT, "wb") as f:
        # mtime 0: the same bytes every run
        with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as g:
            g.write(data)
    print(f"wrote {OUT} ({len(data)} bytes of JSON)")


if __name__ == "__main__":
    main()

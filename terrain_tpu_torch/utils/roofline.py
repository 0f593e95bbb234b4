"""The roofline model of one NVIDIA H100: the least time the card could take
for a piece of work, from its operations and the bytes it must move.

The peaks are NVIDIA's data-sheet figures for the H100 SXM part (dense
rates, no sparsity, at its full 700 W power limit), not measurements: a
card set below 700 W runs slower under load, so a bound is stated with the
card's name and power limit beside it.  `chip_smoke.py` bounds each
hand-written kernel with `bound_ms`, from the kernel module's `cost()`, and
`tools/summarize_trace.py` bounds each op of a profiler trace with it.
"""

F32_PEAK = 67e12     # H100 SXM fp32 CUDA cores, FLOP/s
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor cores, FLOP/s
TF32_PEAK = 495e12   # H100 SXM dense TF32 tensor cores, FLOP/s
HBM_BW = 3.35e12     # H100 SXM HBM3, bytes/s

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
            "int64": 8, "int32": 4, "int16": 2, "uint8": 1, "int8": 1,
            "bool": 1}


def dtype_name(dtype):
    """"float32" for torch.float32 or "float32"."""
    return str(dtype).removeprefix("torch.")


def itemsize(dtype):
    return ITEMSIZE[dtype_name(dtype)]


def bound_ms(flops, nbytes, fp32, tf32_passes=0):
    """The least time the card could take for a kernel's work: its bytes
    (each input read once, each output written once) at HBM_BW, or its
    operations at the peak of their type, whichever is longer.  bf16 work
    goes at the bf16 tensor cores' peak; fp32 work at the CUDA cores', or,
    for a kernel whose fp32-accurate products take `tf32_passes` passes on
    the TF32 tensor cores (bilinear_conv's 3xTF32 split), that many passes
    at their peak.  Returns (ms, "operations" or "bytes")."""
    if not fp32:
        t_ops = flops / BF16_PEAK * 1e3
    elif tf32_passes:
        t_ops = tf32_passes * flops / TF32_PEAK * 1e3
    else:
        t_ops = flops / F32_PEAK * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

"""Hand-written Hopper kernels (csrc/*.cu), each beside its plain PyTorch
version; `_build` compiles them with nvcc at first use."""

import importlib

from terrain_tpu_torch.utils import profiling

# the kernel modules, one a csrc/<module>.cu source
MODULES = ("bilinear_conv", "conv_thin", "conv_stem", "conv_s2", "pool2",
           "bilinear")


def all_kernels():
    """{name: CudaKernel} of every entry point of the six modules, in
    module order; each module's `cost(name, ...)` models its kernels."""
    from terrain_tpu_torch.ops.kernels._build import CudaKernel

    out = {}
    for mod in MODULES:
        m = importlib.import_module(f"{__name__}.{mod}")
        for v in vars(m).values():
            if isinstance(v, CudaKernel):
                out[v.name] = v
    return out


def cost(name, **shape):
    """(flops, bytes, tf32_passes) of one launch of kernel `name` at the
    shape arguments its label carries (CudaKernel.label)."""
    k = all_kernels()[name]
    m = importlib.import_module(f"{__name__}.{k.source}")
    return m.cost(name, **shape)


# a trace (utils/profiling.trace) records each kernel's launches over it
profiling.count_in_traces(
    lambda: {n: k.launches for n, k in all_kernels().items()})

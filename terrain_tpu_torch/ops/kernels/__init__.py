"""Hand-written Hopper kernels (csrc/*.cu), each beside its plain PyTorch
version; `_build` compiles them with nvcc at first use."""

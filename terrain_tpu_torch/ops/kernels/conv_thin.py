"""conv_thin: 3x3 s1 zero-pad conv with cout <= 8, no bias.

Port of terrain_tpu/ops/pallas/conv_thin.py (forward).  On the flagship it
is the DCGAN generator's output conv after phase decomposition
(ops/fused.upsample2x_nearest_conv: 5x5 -> 1 becomes 3x3 64 -> 4 at 256^2).
The CUDA kernel is csrc/conv_thin.cu; `conv_thin_plain` is its plain
PyTorch version, used for CPU tensors and as the card-side reference.
"""

import ctypes

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels._build import CudaKernel

K = 3
TH = 16  # the JAX guard's band height (h % TH == 0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "conv_thin", "conv_thin_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def supported(x_shape, w_shape, stride, padding):
    """Shape rule of the kernel's regime: terrain_tpu's guard
    (conv_thin.py:140-161) without its backend test and without its n <= 4
    gate, which was a TPU timing decision (RESULTS_r4 4c) that would send
    the server's bucket-8 batches around the kernel."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    s = stride if isinstance(stride, tuple) else (stride, stride)
    return (padding == "same" and s == (1, 1)
            and kh == K and kw == K and ci == c
            and 8 <= c <= 64 and c % 8 == 0 and 1 <= f <= 8
            and h % TH == 0 and h >= 64
            and w % 128 == 0 and 128 <= w <= 1024)


def conv_thin_plain(x, w):
    """Plain version: products of x.dtype values summed in fp32, output in
    x.dtype.  x (N,H,W,C), w (3,3,C,F) HWIO."""
    wq = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wq, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_thin(x, w):
    """3x3 s1 'same' conv, cout <= 8, no bias: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv_thin_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv_thin: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv_thin: x {x.dtype}, w {w.dtype}")
    if x.ndim != 4 or tuple(w.shape[:3]) != (K, K, x.shape[3]) \
            or not 1 <= w.shape[3] <= 8 or not 1 <= x.shape[3] <= 64:
        raise ValueError(
            f"conv_thin: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_thin: x and w must be contiguous")
    n, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, f,
                  _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    return y

"""bilinear_conv: fused bilinear x2 upsample + 3x3 zero-pad conv + bias.

Port of terrain_tpu/ops/pallas/bilinear_conv.py (forward).  On the
flagship it runs the U-Net decoder stages (N,64,64,512)->(N,128,128,128)
and (N,128,128,256)->(N,256,256,64).  The CUDA kernel is
csrc/bilinear_conv.cu; `bilinear_conv_plain` is its plain PyTorch version
(the fp32 composite, terrain_tpu's `_xla_composite`), used for CPU tensors
and as the card-side reference.
"""

import ctypes

import torch
import torch.nn.functional as F

from terrain_tpu_torch.ops.kernels._build import CudaKernel

TILE = 32
MIN_SPATIAL = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "bilinear_conv", "bilinear_conv_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _pick_tile(dim, target):
    for t in (target, 64, 32, 16, 8):
        if t <= target and dim % t == 0 and t % 8 == 0:
            return t
    return 0


def supported(x_shape, w_shape):
    """Shape rule of the kernel's regime: terrain_tpu's guard
    (bilinear_conv.py:111-127) without its backend test."""
    n, h, w, c = x_shape
    kh, kw, ci, f = w_shape
    ct = min(c, 128)
    return (kh == 3 and kw == 3 and ci == c
            and h >= MIN_SPATIAL and w >= MIN_SPATIAL
            and bool(_pick_tile(h, TILE)) and bool(_pick_tile(w, TILE))
            and c % ct == 0 and c % 8 == 0 and f % 8 == 0 and f <= 1024
            and c * f <= 512 * 128)


def bilinear_conv_plain(x, w, b):
    """Plain version: upsample and conv in fp32, then cast to x.dtype.
    x (N,H,W,C), w (3,3,C,F) HWIO, b (F,)."""
    up = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    y = F.conv2d(up, w.float().permute(3, 2, 0, 1), padding=1)
    y = y + b.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def bilinear_conv(x, w, b):
    """Fused bilinear x2 + conv3x3 'same' + bias: the kernel for CUDA
    tensors, the plain version for CPU tensors.  w in x.dtype, b fp32."""
    if x.device.type == "cpu":
        return bilinear_conv_plain(x, w, b)
    if x.device.type != "cuda" or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"bilinear_conv: x on {x.device}, w on {w.device}, "
                         f"b on {b.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or b.dtype != torch.float32:
        raise TypeError(
            f"bilinear_conv: x {x.dtype}, w {w.dtype}, b {b.dtype}")
    if x.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or w.shape[3] % 8 != 0 or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"bilinear_conv: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("bilinear_conv: x, w and b must be contiguous")
    n, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((n, 2 * h, 2 * wd, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  n, h, wd, c, f, _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y

"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; they never
quietly go on on the CPU when no card is present.
"""

import os

import torch


def resolve_device(device=None):
    """None or "cuda" -> the card (raises without one); "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def platform_device():
    """The entry points' default device: TERRAIN_PLATFORM=cpu is the caller
    asking for the CPU (terrain_tpu/cli.py:28-34 sets JAX's platform from
    it); unset, the card.  Any other value raises: this package runs on a
    CUDA card or the CPU."""
    platform = os.environ.get("TERRAIN_PLATFORM", "")
    if platform not in ("", "cpu"):
        raise ValueError(f"TERRAIN_PLATFORM={platform!r}: the port runs on "
                         f"the card (unset) or the CPU ('cpu')")
    return platform or "cuda"


def strict_fp32():
    """Turn TF32 off for fp32 matmuls and convolutions.  cuDNN's default
    TF32 convolutions keep ~3 decimal digits, which would make the fp32
    path disagree with the JAX package's numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype_from_env(environ):
    """TERRAIN_DTYPE=bf16 -> torch.bfloat16 compute (fp32 params), else
    None (fp32), as terrain_tpu/experiments.py:_compute_dtype."""
    if environ.get("TERRAIN_DTYPE", "").lower() in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None

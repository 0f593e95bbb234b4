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


# cuDNN engines the frontend must skip (its errata file): the FFT engines
# of forward and data-gradient convolutions.  Engine numbers belong to one
# cuDNN build, so the rules are pinned to the one they were measured on
# (PERF.md §2): torch built against cuDNN 9.19.0, running cuDNN 9.22.0.
# Their version range (start inclusive, end exclusive) holds both numbers,
# whichever of them the frontend compares; chip_smoke.py `ballast` fails
# on any other pair, where the numbers could name other engines.
CUDNN_ERRATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cudnn_errata.json")
CUDNN_MEASURED = {"compiled": 91900, "runtime": 92200}


def strict_fp32():
    """The JAX package's numerics on the card, for every entry point: TF32
    off for fp32 matmuls and convolutions (cuDNN's default TF32
    convolutions keep ~3 decimal digits, which would make the fp32 path
    disagree with the JAX package's numbers), and cuDNN restricted to
    deterministic algorithms (its default choices for some fp32 gradients
    accumulate with atomics, so a step would give other bits from run to
    run; XLA's give the same).

    It also points cuDNN's frontend at CUDNN_ERRATA, which blocks its FFT
    engines.  cuDNN tries the engines of its heuristic list in order and
    takes the first whose workspace the allocator can give; the FFT
    engines it ranks first for the flagship's fp32 convs ask for up to
    9 GiB, so on a card with less free memory than the step's peak it
    took other engines, and the step gave other bits.  With them blocked,
    the flagship's fp32 train step (512px, batch 4, full width) gives the
    same bits with the card whole and with free only 256 MiB less than the
    step's peak reserved, under the cuDNN build of CUDNN_MEASURED
    (chip_smoke.py `ballast`).  Other shapes and other cuDNN builds are
    not measured.  Call it before the process's first convolution: the
    frontend reads the file once.  A different errata file already set
    raises."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    have = os.environ.get("CUDNN_ERRATA_JSON_FILE")
    if have and os.path.abspath(have) != CUDNN_ERRATA:
        raise ValueError(
            f"CUDNN_ERRATA_JSON_FILE={have}: strict_fp32 needs "
            f"{CUDNN_ERRATA} (cuDNN's FFT engines blocked, so the fp32 "
            f"step's bits do not depend on free memory); merge its rules "
            f"into yours and point the variable at it")
    os.environ["CUDNN_ERRATA_JSON_FILE"] = CUDNN_ERRATA


def compute_dtype_from_env(environ):
    """TERRAIN_DTYPE=bf16 -> torch.bfloat16 compute (fp32 params), else
    None (fp32), as terrain_tpu/experiments.py:_compute_dtype."""
    if environ.get("TERRAIN_DTYPE", "").lower() in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None

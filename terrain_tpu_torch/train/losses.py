"""Loss system (terrain_tpu/train/losses.py:17-38).

LSGAN is the squared error against the targets 1/0; the vanilla GAN is
binary cross-entropy on the discriminator's (sigmoid) output, clipped at
1e-7.  The pix2pix generator adds alpha * L1 (or L2) reconstruction.
PatchGAN outputs are patch maps and `.mean()` reduces over the patches.
Every reduction is taken in fp32.  With `rows` (a parallel/spatial.RowShard)
the prediction is this rank's slab of image rows, and the mean is the whole
images': the model group's partial sums added (`spatial.mean`).
"""

import torch

from terrain_tpu_torch.parallel import spatial


def _mean(v, rows):
    return torch.mean(v) if rows is None else spatial.mean(v, rows)

_BCE_EPS = 1e-7

# CSV column order of a training log
TRAIN_KEYS = ("dcgan_gen", "dcgan_disc", "p2p_gen", "p2p_recon", "p2p_disc")


def adv_loss(pred, target, *, lsgan, rows=None):
    """Mean adversarial loss against a constant target (1.0 real, 0.0
    fake)."""
    pred = pred.float()
    if lsgan:
        return _mean(torch.square(pred - target), rows)
    p = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
    return _mean(-(target * torch.log(p)
                   + (1.0 - target) * torch.log(1.0 - p)), rows)


def reconstruction_loss(pred, target, *, kind="l1", rows=None):
    """L1 (default) or L2 mean reconstruction."""
    d = pred.float() - target.float()
    if kind == "l2":
        return _mean(torch.square(d), rows)
    if kind == "l1":
        return _mean(torch.abs(d), rows)
    raise ValueError(f"reconstruction must be 'l1' or 'l2', got {kind!r}")

"""Loss system (terrain_tpu/train/losses.py:17-38).

LSGAN is the squared error against the targets 1/0; the vanilla GAN is
binary cross-entropy on the discriminator's (sigmoid) output, clipped at
1e-7.  The pix2pix generator adds alpha * L1 (or L2) reconstruction.
PatchGAN outputs are patch maps and `.mean()` reduces over the patches.
Every reduction is taken in fp32.
"""

import torch

_BCE_EPS = 1e-7

# CSV column order of a training log
TRAIN_KEYS = ("dcgan_gen", "dcgan_disc", "p2p_gen", "p2p_recon", "p2p_disc")


def adv_loss(pred, target, *, lsgan):
    """Mean adversarial loss against a constant target (1.0 real, 0.0
    fake)."""
    pred = pred.float()
    if lsgan:
        return torch.mean(torch.square(pred - target))
    p = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
    return torch.mean(-(target * torch.log(p)
                        + (1.0 - target) * torch.log(1.0 - p)))


def reconstruction_loss(pred, target, *, kind="l1"):
    """L1 (default) or L2 mean reconstruction."""
    d = pred.float() - target.float()
    if kind == "l2":
        return torch.mean(torch.square(d))
    if kind == "l1":
        return torch.mean(torch.abs(d))
    raise ValueError(f"reconstruction must be 'l1' or 'l2', got {kind!r}")

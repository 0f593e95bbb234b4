"""The simultaneous four-network GAN step (terrain_tpu/train/step.py).

One call updates DCGAN G, DCGAN D, p2p G and p2p D together, from one
shared forward, as the reference does -- not alternating G/D steps.  The
four per-loss gradients come from ONE backward over a partitioned total

    L = L_gen_dcgan(Gd, sg(Dd)) + L_disc_dcgan(sg(Gd(z)), Dd)
      + L_gen_p2p(Gp, sg(Dp)) + alpha*L_recon(Gp) + L_disc_p2p(sg(Gp(X)), Dp)

where sg(params) is a call of the module on detached parameters
(`torch.func.functional_call`) and sg(fake) is `.detach()`, so the
cotangents are partitioned exactly like four independent per-loss
`autograd.grad` calls (tests/test_torch_train.py holds the two together).
The JAX step writes each discriminator forward twice and lets XLA merge
them; here each forward is written once: D on the fake batch with detached
parameters (generator path), and D on concat[real, fake.detach()] with live
ones (discriminator path; two separate passes when D has BatchNorm, whose
batch statistics would couple them).

`train_mode` in {'both','dcgan','p2p'} selects which networks are
differentiated and updated; all five losses are always computed.

BatchNorm running statistics: a generator's come from its single
train-mode forward; a discriminator's come from its fake-batch pass (the
concatenated pass when it has no BN), never from the generator-path pass.
The modules write them only in the pass that is given `update_stats=True`.

The step changes the modules' parameters and buffers and the optimizer
states in place.
"""

import torch
from torch.func import functional_call

from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.train.losses import (
    TRAIN_KEYS, adv_loss, reconstruction_loss)

NET_NAMES = ("dcgan_gen", "dcgan_disc", "p2p_gen", "p2p_disc")

ACTIVE = {
    "both": NET_NAMES,
    "dcgan": ("dcgan_gen", "dcgan_disc"),
    "p2p": ("p2p_gen", "p2p_disc"),
}


def has_bn(module):
    return any(isinstance(m, BatchNorm) for m in module.modules())


def _frozen(module, *args, **kwargs):
    """The module's forward on detached parameters: gradients flow through
    its activations to its inputs, none reaches its parameters."""
    params = {n: p.detach() for n, p in module.named_parameters()}
    return functional_call(module, params, args, kwargs)


def forward_losses(nets, Z, X, Y, rngs=None, *, alpha=100.0, lsgan=False,
                   reconstruction="l1", train=True, update_stats=False):
    """Shared forward of all four networks; returns the losses as a dict
    over TRAIN_KEYS.  `rngs` maps a network name to the `torch.Generator`
    its dropout draws from (missing: no dropout)."""
    rngs = rngs or {}

    def adv(pred, target):
        return adv_loss(pred, target, lsgan=lsgan)

    n = X.shape[0]
    kw = dict(train=train)
    us = dict(update_stats=update_stats)

    def disc_losses(name, real, fake):
        """(generator-path loss, discriminator-path loss) of one stage;
        real and fake are tuples of the discriminator's inputs."""
        d = nets[name]
        dkw = dict(kw, generator=rngs.get(name))
        gpath = _frozen(d, *fake, **dkw)
        fake_sg = tuple(t.detach() for t in fake)
        if has_bn(d):
            d_real = d(*real, **dkw)
            d_fake = d(*fake_sg, **dkw, **us)
        else:
            both = d(*(torch.cat([r, f], 0) for r, f in zip(real, fake_sg)),
                     **dkw, **us)
            d_real, d_fake = both[:n], both[n:]
        return adv(gpath, 1.0), adv(d_real, 1.0) + adv(d_fake, 0.0)

    # stage 1: DCGAN (z -> A)
    a_fake = nets["dcgan_gen"](Z, generator=rngs.get("dcgan_gen"), **kw, **us)
    gen_dcgan, disc_dcgan = disc_losses("dcgan_disc", (X,), (a_fake,))
    # stage 2: pix2pix (A -> B)
    b_fake = nets["p2p_gen"](X, generator=rngs.get("p2p_gen"), **kw, **us)
    gen_p2p, disc_p2p = disc_losses("p2p_disc", (X, Y), (X, b_fake))
    recon = reconstruction_loss(b_fake, Y, kind=reconstruction)
    return {"dcgan_gen": gen_dcgan, "dcgan_disc": disc_dcgan,
            "p2p_gen": gen_p2p, "p2p_recon": recon, "p2p_disc": disc_p2p}


def _total(losses, active, alpha):
    total = 0.0
    if "dcgan_gen" in active:
        total = total + losses["dcgan_gen"]
    if "dcgan_disc" in active:
        total = total + losses["dcgan_disc"]
    if "p2p_gen" in active:
        total = total + losses["p2p_gen"] + alpha * losses["p2p_recon"]
    if "p2p_disc" in active:
        total = total + losses["p2p_disc"]
    return total


def losses_and_grads(nets, Z, X, Y, rngs=None, *, active=NET_NAMES,
                     alpha=100.0, lsgan=False, reconstruction="l1",
                     update_stats=True):
    """One train-mode forward and ONE backward over the partitioned total.
    Returns (losses, {net name: [gradient per parameter]}) for the active
    networks; a parameter the total does not reach gets zeros."""
    losses = forward_losses(nets, Z, X, Y, rngs, alpha=alpha, lsgan=lsgan,
                            reconstruction=reconstruction, train=True,
                            update_stats=update_stats)
    params = {n: list(nets[n].parameters()) for n in active}
    flat = [p for n in active for p in params[n]]
    flat_g = torch.autograd.grad(_total(losses, active, alpha), flat,
                                 allow_unused=True)
    flat_g = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, flat_g)]
    grads, i = {}, 0
    for n in active:
        grads[n] = flat_g[i:i + len(params[n])]
        i += len(params[n])
    return {k: v.detach() for k, v in losses.items()}, grads


def build_train_step(nets, optimizer, *, alpha=100.0, lsgan=False,
                     reconstruction="l1", train_mode="both", prepare=None,
                     lr_mults=None):
    """Returns train_step(opt_states, batch, rngs, lr) -> losses.

    `batch` is whatever `prepare(batch, rngs)` maps to a (Z, X, Y) tuple on
    the device -- the identity by default.  `opt_states` maps a network
    name to its `optimizer.init(list(net.parameters()))`.  `lr_mults`
    (dict net name -> float) scales the runtime lr per network, a TTUR
    knob; the default reproduces the reference's one shared lr.  The
    parameters, the BN statistics and the optimizer states of the active
    networks are updated in place."""
    active = ACTIVE[train_mode]
    lr_mults = dict(lr_mults or {})
    unknown = set(lr_mults) - set(NET_NAMES)
    if unknown:
        raise ValueError(f"lr_mults for unknown networks: {sorted(unknown)}")

    def train_step(opt_states, batch, rngs, lr):
        Z, X, Y = prepare(batch, rngs) if prepare is not None else batch
        losses, grads = losses_and_grads(
            nets, Z, X, Y, rngs, active=active, alpha=alpha, lsgan=lsgan,
            reconstruction=reconstruction)
        for n in active:
            optimizer.update(list(nets[n].parameters()), grads[n],
                             opt_states[n], lr * lr_mults.get(n, 1.0))
        return losses

    return train_step


def build_scan_step(train_step):
    """k sequential train steps as a plain loop (the JAX package scans them
    into one compiled program to amortize its dispatch; eager PyTorch has
    no such program).  `batches` and `rngs` are sequences, one entry per
    step; the losses come back as a dict of (k,) tensors."""

    def scan_step(opt_states, batches, rngs, lr):
        out = [train_step(opt_states, b, r, lr)
               for b, r in zip(batches, rngs)]
        return {k: torch.stack([o[k] for o in out]) for k in TRAIN_KEYS}

    return scan_step


def build_eval_step(nets, *, alpha=100.0, lsgan=False, reconstruction="l1",
                    prepare=None):
    """Returns eval_step(batch, rngs) -> losses: train-mode forwards (batch
    statistics, live dropout), no update of parameters or BN statistics."""

    @torch.no_grad()
    def eval_step(batch, rngs=None):
        Z, X, Y = prepare(batch, rngs) if prepare is not None else batch
        return forward_losses(nets, Z, X, Y, rngs, alpha=alpha, lsgan=lsgan,
                              reconstruction=reconstruction, train=True,
                              update_stats=False)

    return eval_step


def init_opt_states(nets, optimizer):
    return {n: optimizer.init(list(net.parameters()))
            for n, net in nets.items()}


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

`build_scan_step` and `build_scan_eval` run k steps as one chunk
(TERRAIN_SCAN): a plain loop on CPU tensors, one captured CUDA graph on
the card (`CapturedSteps`).
"""

import torch
import torch.distributed as dist
from torch.func import functional_call

from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.train.losses import adv_loss, reconstruction_loss

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


def mean_over(tensors, group):
    """Each tensor replaced by its mean over the ranks of `group`: one
    all-reduce of one flat buffer (the tensors share a dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [v.view_as(t) for t, v in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def _mean_losses(losses, group):
    keys = list(losses)
    vals = mean_over([losses[k].float() for k in keys], group)
    return dict(zip(keys, vals))


def build_train_step(nets, optimizer, *, alpha=100.0, lsgan=False,
                     reconstruction="l1", train_mode="both", prepare=None,
                     lr_mults=None, data_group=None):
    """Returns train_step(opt_states, batch, rngs, lr) -> losses.

    `batch` is whatever `prepare(batch, rngs)` maps to a (Z, X, Y) tuple on
    the device -- the identity by default.  `opt_states` maps a network
    name to its `optimizer.init(list(net.parameters()))`.  `lr_mults`
    (dict net name -> float) scales the runtime lr per network, a TTUR
    knob; the default reproduces the reference's one shared lr.  The
    parameters, the BN statistics and the optimizer states of the active
    networks are updated in place.

    With a `data_group` (data parallelism: this rank holds its slice of
    the global batch, and the BatchNorms take their statistics over the
    group), each network's gradients are all-reduced as their mean over
    the group, one flat buffer per network, before the update, and the
    losses are returned as their means.  Each rank's backward gives
    d(sum of the ranks' losses)/d(its parameters) through its own rows (the
    statistics' all-reduce sums the cotangents), so the mean over ranks is
    the gradient of the global batch's mean loss, terrain_tpu's loss."""
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
        if data_group is not None:
            grads = {n: mean_over(grads[n], data_group) for n in active}
            losses = _mean_losses(losses, data_group)
        for n in active:
            optimizer.update(list(nets[n].parameters()), grads[n],
                             opt_states[n], lr * lr_mults.get(n, 1.0))
        return losses

    # what a CUDA graph of this step needs to know (build_scan_step)
    train_step.nets, train_step.optimizer = nets, optimizer
    return train_step


def step_state(nets, opt_states):
    """Every tensor a train step updates in place: the networks' parameters
    and buffers (the BN statistics) and the optimizer states' tensors."""
    out = [t for net in nets.values()
           for t in (*net.parameters(), *net.buffers())]
    for st in opt_states.values():
        for v in st.values():
            if isinstance(v, list):
                out.extend(v)
            elif torch.is_tensor(v):  # adam's step count
                out.append(v)
    return out


def _on_cpu(batches):
    return batches[0][0].device.type == "cpu"


def _stack_losses(out):
    return {k: torch.stack([o[k] for o in out]) for k in out[0]}


def _generators(rngs):
    """The distinct generators of a chunk's slots, in order."""
    gens = {id(g): g for r in rngs for g in (r or {}).values()}
    return list(gens.values())


def _layout(batches):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in batches[0])


class CapturedSteps:
    """k calls of `step(batch, rngs)`, one per slot, captured once into one
    CUDA graph and replayed at every call.

    The graph reads its inputs from static buffers, one per input with a
    leading k axis (the latent batches (k, bs, latent) and the dataset
    indices (k, bs) of the trainer's chunk), which each call fills.  Its
    random draws come from the generators in `rngs`, registered with the
    graph: a replay draws from each generator's seed and offset at that
    moment, so the caller re-seeds them before each call as before an
    eager step.  Capture follows one warm-up step on the side stream the
    capture uses: it builds every kernel and sets its launch attributes
    (no build, attribute call or device query may first run inside a
    capture) and readies the libraries' handles for that stream.  The
    warm-up step's updates of `state` and its draws are undone before the
    capture.  A failed capture or replay raises."""

    def __init__(self, step, batches, rngs, state=()):
        self.k = len(batches)
        self.static = [torch.stack([b[i] for b in batches])
                       for i in range(len(batches[0]))]
        slots = [tuple(s[t] for s in self.static) for t in range(self.k)]
        dev = self.static[0].device
        saved = [t.detach().clone() for t in state]
        gens = _generators(rngs)
        drawn = [g.get_state() for g in gens]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))  # inputs, saved
        with torch.cuda.stream(side):
            step(slots[0], rngs[0])
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        for g, v in zip(gens, drawn):
            g.set_state(v)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        for g in gens:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, stream=side):
            self.out = _stack_losses([step(slots[t], rngs[t])
                                      for t in range(self.k)])

    def __call__(self, batches):
        for i, s in enumerate(self.static):
            torch.stack([b[i] for b in batches], out=s)
        self.graph.replay()
        return {k: v.clone() for k, v in self.out.items()}


def _replay(slot, key, step, batches, rngs, state=()):
    """The graph in `slot` for `key`, captured anew (the stale one dropped
    first) when the key changed, called on `batches`."""
    if slot.get("key") != key:
        slot.clear()
        slot["graph"] = CapturedSteps(step, batches, rngs, state)
        slot["key"] = key
    return slot["graph"](batches)


def build_scan_step(train_step):
    """k sequential train steps as one chunk (terrain_tpu's lax.scan of k
    steps, terrain_tpu/train/step.py:208-242): scan_step(opt_states,
    batches, rngs, lr) with `batches` and `rngs` sequences of one entry per
    step; the losses come back as a dict of (k,) tensors.

    On CPU tensors the steps run as a plain loop.  On CUDA tensors the k
    steps are one CUDA graph (`CapturedSteps`), captured at the first call
    and replayed at every later one; it is captured anew when lr, the
    batches' shapes, the generators or the addresses of the state it
    updates (a reloaded optimizer state) change.  lr is a constant of the
    graph, so the update is the eager step's own fused kernels, and an lr
    change (ReduceLROnPlateau) takes effect at the next chunk; adam's step
    count and bias correction live on the device, so a replay advances
    them."""
    slot = {}

    def scan_step(opt_states, batches, rngs, lr):
        if _on_cpu(batches):
            return _stack_losses([train_step(opt_states, b, r, lr)
                                  for b, r in zip(batches, rngs)])
        state = step_state(train_step.nets, opt_states)
        key = (float(lr), _layout(batches),
               tuple(map(id, _generators(rngs))),
               tuple(t.data_ptr() for t in state))
        return _replay(slot, key,
                       lambda b, r: train_step(opt_states, b, r, lr),
                       batches, rngs, state)

    return scan_step


def build_scan_eval(eval_step):
    """The eval pass's chunk (terrain_tpu/train/step.py:245-257):
    scan_eval(batches, rngs) -> dict of (k,) losses; a loop on CPU
    tensors, one CUDA graph on the card, as `build_scan_step`."""
    slot = {}

    def scan_eval(batches, rngs):
        if _on_cpu(batches):
            return _stack_losses([eval_step(b, r)
                                  for b, r in zip(batches, rngs)])
        key = (_layout(batches), tuple(map(id, _generators(rngs))))
        return _replay(slot, key, eval_step, batches, rngs)

    return scan_eval


def build_eval_step(nets, *, alpha=100.0, lsgan=False, reconstruction="l1",
                    prepare=None, data_group=None):
    """Returns eval_step(batch, rngs) -> losses: train-mode forwards (batch
    statistics, live dropout), no update of parameters or BN statistics.
    With a `data_group`, the losses are their means over it."""

    @torch.no_grad()
    def eval_step(batch, rngs=None):
        Z, X, Y = prepare(batch, rngs) if prepare is not None else batch
        losses = forward_losses(nets, Z, X, Y, rngs, alpha=alpha,
                                lsgan=lsgan, reconstruction=reconstruction,
                                train=True, update_stats=False)
        if data_group is not None:
            losses = _mean_losses(losses, data_group)
        return losses

    return eval_step


def init_opt_states(nets, optimizer):
    return {n: optimizer.init(list(net.parameters()))
            for n, net in nets.items()}


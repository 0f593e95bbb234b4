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
(TERRAIN_SCAN), by one rule (`captures`): one captured CUDA graph
(`CapturedSteps`) on CUDA tensors when every process group the step runs
a collective on is NCCL's, the collectives inside the graph; a plain loop
on CPU tensors and over a gloo group.  Under a mesh every rank captures
and replays the same collectives: whether to capture anew is agreed by
all of them before each chunk (`_on_any_rank`).

`check_nans` (TERRAIN_CHECK_NANS=2; utils/nan_check.py): each step runs
under NaN checks of every op's output and raises FloatingPointError at
the first NaN, naming the step within its chunk, the network, the layer
and the op.  A chunk's checks are recorded into its graph with the steps
and read once a chunk; under a mesh the flag goes through the all-reduce
of `_on_any_rank`, so every rank raises together.

Spatial parallelism (`spatial_mesh`, the four networks held in slabs of
image rows over the mesh's model group, parallel/spatial.py, in every
`train_mode`): the batch is prepared whole (gathered and augmented as one
process does) and every network takes this rank's rows of its images.
The DCGAN generator returns a slab of its output, which the DCGAN
discriminator takes beside this rank's rows of the real images and
answers with whole (N, 1) scores; the pix2pix networks' losses over
slabs are partial sums made whole.  So every rank returns one process's
losses, and each active network's slab layers' gradients are summed over
'model'.
"""

import contextlib

import torch
import torch.distributed as dist
from torch.func import functional_call

from terrain_tpu_torch.ops.norm import BatchNorm
from terrain_tpu_torch.parallel import spatial
from terrain_tpu_torch.train.losses import adv_loss, reconstruction_loss
from terrain_tpu_torch.utils import nan_check

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
                   reconstruction="l1", train=True, update_stats=False,
                   rows=None):
    """Shared forward of all four networks; returns the losses as a dict
    over TRAIN_KEYS.  `rngs` maps a network name to the `torch.Generator`
    its dropout draws from (missing: no dropout).  `rows`: the networks'
    row shard (parallel/spatial.RowShard); X and Y are whole images and
    both stages take this rank's rows of them."""
    rngs = rngs or {}
    n = X.shape[0]
    kw = dict(train=train)
    us = dict(update_stats=update_stats)

    def disc_losses(name, real, fake):
        """(generator-path loss, discriminator-path loss) of one stage;
        real and fake are tuples of the discriminator's inputs."""
        d = nets[name]
        d_rows = getattr(d, "rows", None)
        if d_rows is not None and not d_rows.slab(d.out_rows):
            d_rows = None  # its patch map is held whole

        def adv(pred, target):
            return adv_loss(pred, target, lsgan=lsgan, rows=d_rows)

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

    if rows is not None:
        X, Y = rows.take(X), rows.take(Y)
    # stage 1: DCGAN (z -> A)
    a_fake = nets["dcgan_gen"](Z, generator=rngs.get("dcgan_gen"), **kw, **us)
    gen_dcgan, disc_dcgan = disc_losses("dcgan_disc", (X,), (a_fake,))
    # stage 2: pix2pix (A -> B)
    b_fake = nets["p2p_gen"](X, generator=rngs.get("p2p_gen"), **kw, **us)
    gen_p2p, disc_p2p = disc_losses("p2p_disc", (X, Y), (X, b_fake))
    recon = reconstruction_loss(b_fake, Y, kind=reconstruction, rows=rows)
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
                     update_stats=True, rows=None):
    """One train-mode forward and ONE backward over the partitioned total.
    Returns (losses, {net name: [gradient per parameter]}) for the active
    networks; a parameter the total does not reach gets zeros.  With
    `rows` (forward_losses') each rank's gradients are those of its own
    path: a slab layer's the part of its rows."""
    losses = forward_losses(nets, Z, X, Y, rngs, alpha=alpha, lsgan=lsgan,
                            reconstruction=reconstruction, train=True,
                            update_stats=update_stats, rows=rows)
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


def _spatial_rows(nets, spatial_mesh, data_group):
    """(the networks' row shard, the data group) of a step over
    `spatial_mesh`; (None, data_group) without one.  Every mode runs all
    four networks forward, so all four must be held in slabs."""
    if spatial_mesh is None:
        return None, data_group
    unsharded = [n for n in NET_NAMES if getattr(nets[n], "rows", None)
                 is None]
    if unsharded:
        raise ValueError(f"a spatial step needs every network held in "
                         f"slabs (parallel.shard_rows(net, mesh) each), "
                         f"not {unsharded}")
    rows = nets["dcgan_gen"].rows
    if data_group is None and spatial_mesh.shape["data"] > 1:
        data_group = spatial_mesh.data_group
    return rows, data_group


def build_train_step(nets, optimizer, *, alpha=100.0, lsgan=False,
                     reconstruction="l1", train_mode="both", prepare=None,
                     lr_mults=None, data_group=None, spatial_mesh=None,
                     check_nans=False):
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
    the gradient of the global batch's mean loss, terrain_tpu's loss.

    Tensor parallelism needs nothing more here.  A sharded layer's input
    passes parallel/tp.enter_sharded, whose backward sums the model
    group's partial dX, and everything after its gather is computed alike
    on every rank of the group, so a replicated parameter's gradient is
    the same on each of them and a sharded weight's is its own slice's.
    The data group (one model index) then averages like with like.

    Spatial parallelism (`spatial_mesh`, the four networks held in slabs
    by parallel.shard_rows, any train_mode): `batch` is this rank's data
    block, as with a data group; `prepare` runs on its whole images and
    each network takes its rows.  An active network's slab layers'
    gradients are summed over the model group, its whole-row layers' are
    whole already (parallel/spatial.py); then the data group averages.

    `check_nans`: the step carries NaN checks (`.checks`); an eager call
    runs as a chunk of one (`_loop`), which reads them."""
    active = ACTIVE[train_mode]
    lr_mults = dict(lr_mults or {})
    unknown = set(lr_mults) - set(NET_NAMES)
    if unknown:
        raise ValueError(f"lr_mults for unknown networks: {sorted(unknown)}")
    rows, data_group = _spatial_rows(nets, spatial_mesh, data_group)

    def train_step(opt_states, batch, rngs, lr):
        if _eager(train_step):
            return _loop(lambda b, r: train_step(opt_states, b, r, lr),
                         [batch], [rngs], train_step)[0]
        Z, X, Y = prepare(batch, rngs) if prepare is not None else batch
        losses, grads = losses_and_grads(
            nets, Z, X, Y, rngs, active=active, alpha=alpha, lsgan=lsgan,
            reconstruction=reconstruction, rows=rows)
        if rows is not None:
            grads = {n: spatial.sum_slab_grads(nets[n], grads[n])
                     for n in active}
        if data_group is not None:
            grads = {n: mean_over(grads[n], data_group) for n in active}
            losses = _mean_losses(losses, data_group)
        for n in active:
            with nan_check.scope(n, "optimizer update"):
                optimizer.update(list(nets[n].parameters()), grads[n],
                                 opt_states[n], lr * lr_mults.get(n, 1.0))
        return losses

    # what a chunk of this step needs to know (build_scan_step)
    train_step.nets, train_step.optimizer = nets, optimizer
    train_step.groups = step_groups(nets, data_group)
    train_step.checks = _checks(nets, check_nans)
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


def step_groups(nets, data_group=None):
    """Every process group a step over `nets` runs a collective on, each
    once, in one order on every rank: the data group, then as the
    networks' modules hold them (a network's or a layer's row shard, a
    BatchNorm's statistics, a sharded layer's model group)."""
    found = {} if data_group is None else {id(data_group): data_group}
    for net in nets.values():
        for m in net.modules():
            for g in (getattr(getattr(m, "rows", None), "group", None),
                      getattr(m, "process_group", None),
                      getattr(getattr(m, "shard", None), "group", None)):
                if g is not None:
                    found.setdefault(id(g), g)
    return tuple(found.values())


def captures(device_type, backends):
    """The rule of a chunk of k steps: one captured CUDA graph (True) or a
    plain loop (False), from the tensors' device type and the backends of
    the process groups the step runs collectives on.  A graph on CUDA
    tensors when every group is NCCL's (or there is none): NCCL's
    collectives are kernels on the device, captured with the step.  A loop
    on CPU tensors, and over any gloo group: gloo stages a CUDA tensor
    through the host, which no capture can hold."""
    return device_type == "cuda" and all(b == "nccl" for b in backends)


def _captured(batches, groups):
    return captures(batches[0][0].device.type,
                    [dist.get_backend(g) for g in groups])


# one capture stream a device, as torch.cuda.graph keeps one default
# capture stream (_capture_stream)
_CAPTURE_STREAMS = {}


def _capture_stream(dev):
    """The stream every capture on `dev` warms up and captures on, made
    once a process.  cuBLAS keeps a workspace for each handle (one a
    thread) and stream as long as the process lives; a new stream's first
    matmuls would make theirs inside the warm-up step's activations and
    hold that whole segment of the cache (gigabytes at the flagship's
    step), a new one for every capture.  So the stream is made once, and
    a small linear layer's forward and backward (the autograd thread's
    handle) make its workspaces first, each in a segment of its own."""
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            x = torch.ones(4, 8, device=dev, requires_grad=True)
            torch.nn.functional.linear(x, x).sum().backward()
        torch.cuda.current_stream(dev).wait_stream(stream)
    return stream


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
    eager step.  Capture follows one warm-up step on the stream the
    capture uses: it builds every kernel and sets its launch attributes
    (no build, attribute call or device query may first run inside a
    capture) and readies the libraries' handles for that stream.  The
    warm-up step's updates of `state` and its draws are undone before the
    capture.  A failed capture or replay raises.

    The step's collectives (NCCL's: `captures`) are captured with it.  The
    warm-up step runs each group's first collective, which makes its
    communicator, outside the capture; inside it each collective is forked
    from the capturing stream to the group's own stream and joined back,
    and its buffers come from the graph's private pool.  A captured
    collective is not watched by the process group's timeout: a replay
    waits for the other ranks' replays as long as it takes.

    `checks` (utils/nan_check.NanChecks): the steps' NaN checks are
    captured with them, into its flag buffer; a replay rewrites every
    slot, and the caller reads them."""

    def __init__(self, step, batches, rngs, state=(), checks=None):
        self.k = len(batches)
        self.static = [torch.stack([b[i] for b in batches])
                       for i in range(len(batches[0]))]
        slots = [tuple(s[t] for s in self.static) for t in range(self.k)]
        dev = self.static[0].device
        saved = [t.detach().clone() for t in state]
        # held while the graph lives: its key names them by id
        self.gens = gens = _generators(rngs)
        drawn = [g.get_state() for g in gens]
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))  # inputs, saved
        with torch.cuda.stream(side):
            with _checking(checks, 0, self.k):
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
        if checks is not None:
            checks.reset()  # the warm-up step's checks are not read
        with torch.cuda.graph(self.graph, stream=side):
            out = []
            for t in range(self.k):
                with _checking(checks, t, self.k):
                    out.append(step(slots[t], rngs[t]))
            self.out = _stack_losses(out)

    def __call__(self, batches):
        for i, s in enumerate(self.static):
            torch.stack([b[i] for b in batches], out=s)
        self.graph.replay()
        return {k: v.clone() for k, v in self.out.items()}


def _on_any_rank(flag, groups, device):
    """Whether `flag` (a bool, or a device int32 of shape (1,)) holds on
    any rank that shares a group of `groups` with this one: one all-reduce
    (MAX) of one int over each group, in `groups`' order, which is the
    same on every rank (`step_groups`).  One pass reaches every rank of a
    mesh: its columns (data groups) then its rows (model groups), or the
    group of the whole mesh."""
    t = (flag if torch.is_tensor(flag) else
         torch.tensor([int(flag)], dtype=torch.int32, device=device))
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return bool(t.item())


def _checking(checks, t, k):
    """NaN checks recording step t of a chunk of k, or nothing."""
    if checks is None:
        return contextlib.nullcontext()
    return checks.step(t, k)


def _raise_if_nan(checks, groups, device):
    """One host read of the checks' flag, over `groups` as `_on_any_rank`
    makes it: every rank raises when any rank saw a NaN."""
    if _on_any_rank(checks.hit(), groups, device):
        checks.raise_first()


def _checks(nets, check_nans):
    """A step's NaN checks (utils/nan_check.NanChecks) for its eager calls
    and plain-loop chunks, or None."""
    if not check_nans:
        return None
    dev = next(p.device for net in nets.values() for p in net.parameters())
    return nan_check.NanChecks(nets, dev)


def _eager(step):
    """Whether a call of `step` is an eager one that its NaN checks must
    wrap: it has checks, and no chunk is recording them already."""
    return step.checks is not None and nan_check.ACTIVE is None


def _loop(call, batches, rngs, step):
    """A chunk of `step` as a plain loop of `call(batch, rngs)`: the list of
    the k outputs.  Under the step's NaN checks each step's are recorded
    and all are read once after the chunk (an eager call: a chunk of
    one)."""
    checks = step.checks
    if checks is None:
        return [call(b, r) for b, r in zip(batches, rngs)]
    checks.reset()
    out = []
    for t, (b, r) in enumerate(zip(batches, rngs)):
        with checks.step(t, len(batches)):
            out.append(call(b, r))
    _raise_if_nan(checks, step.groups, checks.flags.device)
    return out


def _replay(slot, key, step, call, batches, rngs, state=()):
    """The graph in `slot` for `key`, captured anew (the stale one dropped
    first) when the key changed, called on `batches`.  Over the step's
    process groups the graph is captured anew when the key changed on any
    of their ranks (`_on_any_rank`, at every call): a rank that captured
    while another replayed would pair its warm-up step's collectives with
    the other's replay, and hang or sum the wrong tensors.  A step with
    NaN checks gets a graph of its own checks, read after each replay."""
    groups = step.groups
    dev = batches[0][0].device
    stale = slot.get("key") != key
    if groups:
        stale = _on_any_rank(stale, groups, dev)
    if stale:
        slot.clear()
        slot["checks"] = (None if step.checks is None
                          else nan_check.NanChecks(step.nets, dev))
        slot["graph"] = CapturedSteps(call, batches, rngs, state,
                                      checks=slot["checks"])
        slot["key"] = key
    out = slot["graph"](batches)
    if slot["checks"] is not None:
        _raise_if_nan(slot["checks"], groups, dev)
    return out


def build_scan_step(train_step):
    """k sequential train steps as one chunk (terrain_tpu's lax.scan of k
    steps, terrain_tpu/train/step.py:208-242): scan_step(opt_states,
    batches, rngs, lr) with `batches` and `rngs` sequences of one entry per
    step; the losses come back as a dict of (k,) tensors.

    The steps run as a plain loop or as one CUDA graph (`CapturedSteps`),
    by `captures` over the step's process groups (`train_step.groups`).
    The graph is captured at the first call and replayed at every later
    one; it is captured anew when lr, the batches' shapes, the generators
    or the addresses of the state it updates (a reloaded optimizer state)
    change, on this rank or on any rank it shares a group with.  A step
    with NaN checks (`check_nans`) has them recorded step by step and read
    once a chunk.  lr is a
    constant of the graph, so the update is the eager step's own fused
    kernels, and an lr change (ReduceLROnPlateau) takes effect at the next
    chunk; adam's step count and bias correction live on the device, so a
    replay advances them."""
    slot = {}

    def scan_step(opt_states, batches, rngs, lr):
        def call(b, r):
            return train_step(opt_states, b, r, lr)

        if not _captured(batches, train_step.groups):
            return _stack_losses(_loop(call, batches, rngs, train_step))
        state = step_state(train_step.nets, opt_states)
        key = (float(lr), _layout(batches),
               tuple(map(id, _generators(rngs))),
               tuple(t.data_ptr() for t in state))
        return _replay(slot, key, train_step, call, batches, rngs, state)

    return scan_step


def build_scan_eval(eval_step):
    """The eval pass's chunk (terrain_tpu/train/step.py:245-257):
    scan_eval(batches, rngs) -> dict of (k,) losses; a loop or one CUDA
    graph by the rule of `build_scan_step`."""
    slot = {}

    def scan_eval(batches, rngs):
        if not _captured(batches, eval_step.groups):
            return _stack_losses(_loop(eval_step, batches, rngs, eval_step))
        key = (_layout(batches), tuple(map(id, _generators(rngs))))
        return _replay(slot, key, eval_step, eval_step, batches, rngs)

    return scan_eval


def build_eval_step(nets, *, alpha=100.0, lsgan=False, reconstruction="l1",
                    prepare=None, data_group=None, spatial_mesh=None,
                    check_nans=False):
    """Returns eval_step(batch, rngs) -> losses: train-mode forwards (batch
    statistics, live dropout), no update of parameters or BN statistics.
    With a `data_group`, the losses are their means over it;
    `spatial_mesh` and `check_nans` as build_train_step's."""
    rows, data_group = _spatial_rows(nets, spatial_mesh, data_group)

    @torch.no_grad()
    def eval_step(batch, rngs=None):
        if _eager(eval_step):
            return _loop(eval_step, [batch], [rngs], eval_step)[0]
        Z, X, Y = prepare(batch, rngs) if prepare is not None else batch
        losses = forward_losses(nets, Z, X, Y, rngs, alpha=alpha,
                                lsgan=lsgan, reconstruction=reconstruction,
                                train=True, update_stats=False, rows=rows)
        if data_group is not None:
            losses = _mean_losses(losses, data_group)
        return losses

    eval_step.nets = nets
    eval_step.groups = step_groups(nets, data_group)
    eval_step.checks = _checks(nets, check_nans)
    return eval_step


def init_opt_states(nets, optimizer):
    return {n: optimizer.init(list(net.parameters()))
            for n, net in nets.items()}


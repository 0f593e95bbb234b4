"""terrain_tpu_torch's discriminators, losses, optimizers and four-network
train step against terrain_tpu's on the CPU, fp32, at the tiny configuration
of tests/test_train_step.py.  Weights are carried across by models/convert,
and Z, X, Y come from numpy with a seed and go to both packages (the tiny
configuration has no dropout, so no random draw is left inside the step).

Tolerances: 1e-5 relative on losses and optimizer arithmetic (same formulas,
fp32); 2e-4 on network outputs (sums in another order through a few
layers); gradients 1e-4 relative to each tensor's largest entry (floored
at 1% of its network's largest, see _grad_close); weights
after a step 2e-5 absolute at lr 1e-3 (an rmsprop step divides the gradient
difference by at least sqrt(1e-6))."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import unet as junet
from terrain_tpu.train import losses as jlosses
from terrain_tpu.train import optim as joptim
from terrain_tpu.train import step as jstep
from terrain_tpu_torch import experiments
from terrain_tpu_torch.models import convert, dcgan, param_count, unet
from terrain_tpu_torch.train import losses, optim, step

IN_SHP, LATENT, BS, LR = 16, 8, 2, 1e-3
KW = dict(alpha=100.0, lsgan=True, reconstruction="l1")
OUT_TOL = dict(rtol=0, atol=2e-4)


def _perturb(tree, rng):
    """BN gamma/beta/mean/inv_std -> random values in sane ranges."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("gamma", "inv_std"):
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k in ("beta", "mean"):
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = _perturb(v, rng)
        return out
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return np.asarray(tree)


def _tree_close(got, want, rtol, atol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=rtol, atol=atol), got, want)


def _grad_close(got, want, rel=1e-4):
    """Each gradient tensor against its largest entry.  A conv bias in
    front of a train-mode BN has a zero gradient that both packages compute
    as rounding noise, so a tensor's scale is floored at 1% of the largest
    gradient of its network."""
    top = max(float(np.abs(b).max()) for b in jax.tree.leaves(want))

    def chk(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(
            a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-2 * top, 1e-12))
    jax.tree.map(chk, got, want)


# ------------------------------------------------------- discriminators
def _disc_pair(kind, rng):
    g = torch.Generator().manual_seed(1)
    if kind in ("dcgan", "dcgan_bn", "dcgan_avg"):
        kw = dict(nch=IN_SHP, h=3, div=[4, 2], bn=kind == "dcgan_bn",
                  pool_mode="avg" if kind == "dcgan_avg" else "max",
                  nonlinearity="linear")
        jnet = jdcgan.default_discriminator(IN_SHP, True, **kw)
        tnet = dcgan.default_discriminator(IN_SHP, True, generator=g, **kw)
        inputs = [rng.rand(3, IN_SHP, IN_SHP, 1).astype(np.float32)]
    else:
        jf, tf = {"p2p": (junet.discriminator, unet.discriminator),
                  "p2p_bn": (junet.discriminator, unet.discriminator),
                  "p2p_2": (junet.discriminator2, unet.discriminator2)}[kind]
        kw = dict(nf=4, act="sigmoid", num_repeats=1)
        if kind == "p2p_bn":
            kw["bn"] = True
        jnet = jf(IN_SHP, True, False, **kw)
        tnet = tf(IN_SHP, True, False, generator=g, **kw)
        inputs = [rng.rand(3, IN_SHP, IN_SHP, 1).astype(np.float32),
                  (rng.rand(3, IN_SHP, IN_SHP, 3) * 2 - 1).astype(np.float32)]
    p, s = convert.to_jax(tnet)
    p, s = _perturb(p, rng), _perturb(s, rng)
    # the tree the port dumps is the tree terrain_tpu's init makes
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    assert jax.tree.structure((p, s)) == jax.tree.structure(shapes)
    convert.load_jax(tnet, p, s)
    return jnet, tnet, p, s, inputs


@pytest.mark.parametrize("kind", ["dcgan", "dcgan_bn", "dcgan_avg", "p2p",
                                  "p2p_bn", "p2p_2"])
def test_discriminator_matches_jax(kind, rng):
    jnet, tnet, p, s, inputs = _disc_pair(kind, rng)
    jin = list(map(jnp.asarray, inputs))
    tin = list(map(torch.from_numpy, inputs))
    for train in (False, True):
        want, new_state = jnet.apply(p, s, *jin, train=train)
        with torch.no_grad():
            got = tnet(*tin, train=train, update_stats=train)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    # the train-mode pass with update_stats left the new statistics behind
    _tree_close(convert.to_jax(tnet)[1], new_state, 1e-5, 1e-6)
    q, _ = convert.to_jax(tnet)
    jax.tree.map(np.testing.assert_array_equal, q, p)


def test_dcgan_discriminator_quirks():
    # the avg-pool window comes from nch, so nch must equal in_shp
    with pytest.raises(ValueError, match="avg-pool window"):
        dcgan.default_discriminator(256, True)
    d = dcgan.default_discriminator(512, True, num_repeats=0, bn=False,
                                    nonlinearity="linear",
                                    div=[8, 4, 4, 4, 2, 2, 2])
    assert param_count(d) == 5_129_217
    # the hidden ReLU on the last conv: all-negative pre-pool maps give 0
    t = dcgan.default_discriminator(IN_SHP, True, nch=IN_SHP, h=3, div=[4, 2],
                                    nonlinearity="linear")
    with torch.no_grad():
        t.conv_out.b.fill_(-100.0)
        assert float(t(torch.rand(2, IN_SHP, IN_SHP, 1)).abs().max()) == 0.0
    lin = dcgan.default_discriminator(IN_SHP, True, nch=IN_SHP, h=3,
                                      div=[4, 2], nonlinearity="linear",
                                      conv_out_nonlinearity="linear")
    with torch.no_grad():
        lin.conv_out.b.fill_(-100.0)
        assert float(lin(torch.rand(2, IN_SHP, IN_SHP, 1)).max()) < -50


def test_fake_nets_match_jax(rng):
    a = rng.rand(2, 8, 8, 1).astype(np.float32)
    b = rng.rand(2, 8, 8, 3).astype(np.float32)
    tg, td = unet.fake_generator(True, False), unet.fake_discriminator(
        True, False)
    jg, jd = junet.fake_generator(True, False), junet.fake_discriminator(
        True, False)
    pg, sg = convert.to_jax(tg)
    pd, sd = convert.to_jax(td)
    want_g, _ = jg.apply(pg, sg, jnp.asarray(a))
    want_d, _ = jd.apply(pd, sd, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(tg(torch.from_numpy(a)).detach().numpy(),
                               np.asarray(want_g), **OUT_TOL)
    np.testing.assert_allclose(
        td(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(),
        np.asarray(want_d), **OUT_TOL)


# ------------------------------------------------- losses and optimizers
def test_losses_golden_and_match_jax(rng):
    pred = torch.tensor([[0.2], [0.8]])
    assert float(losses.adv_loss(pred, 1.0, lsgan=True)) == pytest.approx(
        (0.64 + 0.04) / 2, rel=1e-6)
    assert float(losses.adv_loss(pred, 0.0, lsgan=False)) == pytest.approx(
        -(np.log(0.8) + np.log(0.2)) / 2, rel=1e-6)
    a, b = torch.tensor([1.0, -2.0]), torch.zeros(2)
    assert float(losses.reconstruction_loss(a, b, kind="l1")) == 1.5
    assert float(losses.reconstruction_loss(a, b, kind="l2")) == 2.5
    with pytest.raises(ValueError):
        losses.reconstruction_loss(a, b, kind="l3")
    assert losses.TRAIN_KEYS == jlosses.TRAIN_KEYS
    # the BCE clip at 1e-7 and the fp32 reduction of a bf16 prediction
    p = np.concatenate([rng.rand(30), [0.0, 1.0]]).astype(np.float32)
    for target in (0.0, 1.0):
        for lsgan in (False, True):
            want = jlosses.adv_loss(jnp.asarray(p), target, lsgan=lsgan)
            got = losses.adv_loss(torch.from_numpy(p), target, lsgan=lsgan)
            assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert losses.adv_loss(torch.from_numpy(p).bfloat16(), 1.0,
                           lsgan=True).dtype == torch.float32


@pytest.mark.parametrize("name,lr", [("rmsprop", 1e-2), ("adam", 1e-3)])
def test_optimizer_three_steps_match_jax(name, lr, rng):
    shapes = [(3, 4), (5,), (2, 3, 3, 2)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-4, 1)
              for s in shapes] for _ in range(3)]
    jopt = joptim.get_optimizer(name)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(p0)}
    jstate = jopt.init(jp)
    topt = optim.get_optimizer(name)
    assert topt.default_lr == jopt.default_lr
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = topt.init(tp)
    for g in grads:
        jp, jstate = jopt.update({str(i): jnp.asarray(a)
                                  for i, a in enumerate(g)}, jstate, jp, lr)
        topt.update(tp, [torch.from_numpy(a) for a in g], tstate, lr)
        for i, t in enumerate(tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[str(i)]),
                                       rtol=1e-5, atol=1e-6)
    key = "accu" if name == "rmsprop" else "v"
    for i, t in enumerate(tstate[key]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jstate[key][str(i)]),
                                   rtol=1e-5, atol=1e-12)


# ------------------------------------------------------ the slice as a whole
def _jax_nets():
    return {
        "dcgan_gen": jdcgan.default_generator(
            LATENT, True, nch=8, h=3, initial_size=4, final_size=IN_SHP,
            div=[2, 2]),
        "dcgan_disc": jdcgan.default_discriminator(
            IN_SHP, True, nch=IN_SHP, h=3, div=[4, 2], bn=False,
            nonlinearity="linear"),
        "p2p_gen": junet.g_unet(IN_SHP, True, False, nf=4),
        "p2p_disc": junet.discriminator(IN_SHP, True, False, nf=4,
                                        act="linear"),
    }


def _torch_nets():
    return {
        "dcgan_gen": dcgan.default_generator(
            LATENT, True, nch=8, h=3, initial_size=4, final_size=IN_SHP,
            div=[2, 2]),
        "dcgan_disc": dcgan.default_discriminator(
            IN_SHP, True, nch=IN_SHP, h=3, div=[4, 2], bn=False,
            nonlinearity="linear"),
        "p2p_gen": unet.g_unet(IN_SHP, True, False, nf=4),
        "p2p_disc": unet.discriminator(IN_SHP, True, False, nf=4,
                                       act="linear"),
    }


@pytest.fixture(scope="module")
def world():
    """terrain_tpu's tiny nets with their initial trees, and the batch."""
    jnets = _jax_nets()
    params, states = {}, {}
    for i, (n, net) in enumerate(jnets.items()):
        params[n], states[n] = net.init(
            jax.random.fold_in(jax.random.PRNGKey(0), i))
    # the DCGAN disc's hidden ReLU can be fully dead at a tiny random init,
    # which would zero every DCGAN gradient: bias it positive
    params["dcgan_disc"]["conv_out"]["b"] = (
        params["dcgan_disc"]["conv_out"]["b"] + 0.5)
    params = jax.tree.map(np.asarray, params)
    states = jax.tree.map(np.asarray, states)
    r = np.random.RandomState(0)
    batch = (r.rand(BS, LATENT).astype(np.float32),
             r.rand(BS, IN_SHP, IN_SHP, 1).astype(np.float32),
             (r.rand(BS, IN_SHP, IN_SHP, 3) * 2 - 1).astype(np.float32))
    return jnets, params, states, batch


def _carried(world):
    """Fresh port networks holding the world's weights."""
    _, params, states, batch = world
    tnets = _torch_nets()
    for n, net in tnets.items():
        convert.load_jax(net, params[n], states[n])
    return tnets, tuple(torch.from_numpy(a) for a in batch)


def _dump(tnets):
    return ({n: convert.to_jax(m)[0] for n, m in tnets.items()},
            {n: convert.to_jax(m)[1] for n, m in tnets.items()})


def test_two_consecutive_train_steps_match_jax(world):
    jnets, params, states, batch = world
    jopt = joptim.rmsprop()
    jtrain = jax.jit(jstep.build_train_step(jnets, jopt, train_mode="both",
                                            **KW))
    jbatch = tuple(map(jnp.asarray, batch))
    key = jax.random.PRNGKey(42)

    # the four gradient trees of the first step: jax.grad over the
    # stop-gradient-partitioned total, as build_train_step takes it
    def total(diff):
        ls, _ = jstep.forward_losses(jnets, diff, states, *jbatch, key,
                                     train=True, **KW)
        return jstep._total(ls, jstep.NET_NAMES, KW["alpha"])

    jgrads = jax.jit(jax.grad(total))(params)

    tnets, tbatch = _carried(world)
    topt = optim.rmsprop()
    tstates = step.init_opt_states(tnets, topt)
    _, tgrads = step.losses_and_grads(
        {n: copy.deepcopy(m) for n, m in tnets.items()}, *tbatch, **KW)
    ttrain = step.build_train_step(tnets, topt, train_mode="both", **KW)

    jp, js = params, states
    jo = {n: jopt.init(params[n]) for n in jnets}
    for i in range(2):  # the second step exercises accu
        jp, js, jo, jl = jtrain(jp, js, jo, jbatch, key, LR)
        tl = ttrain(tstates, tbatch, None, LR)
        assert tuple(tl) == losses.TRAIN_KEYS
        for k in losses.TRAIN_KEYS:
            assert float(tl[k]) == pytest.approx(float(jl[k]), rel=2e-5), \
                (i, k)
        tp, ts = _dump(tnets)
        _tree_close(tp, jp, 0, 2e-5)
        _tree_close(ts, js, 1e-5, 1e-6)
        for n in tnets:
            accu = convert.params_to_jax(tnets[n], tstates[n]["accu"])
            _grad_close(accu, jo[n]["accu"], rel=2e-4)
    assert sorted(tgrads) == sorted(jgrads)
    for n in tnets:
        _grad_close(convert.params_to_jax(tnets[n], tgrads[n]), jgrads[n])
        # and the inverse carries a terrain_tpu gradient tree into the port
        back = convert.params_from_jax(tnets[n], jgrads[n])
        for a, b in zip(back, tgrads[n]):
            assert a.shape == b.shape
    # every network moved
    for n in tnets:
        moved = jax.tree.map(lambda a, b: not np.array_equal(a, b), tp[n],
                             params[n])
        assert any(jax.tree.leaves(moved)), n


def test_one_backward_equals_four_independent_grads(world):
    tnets, tbatch = _carried(world)
    _, grads = step.losses_and_grads(tnets, *tbatch, update_stats=False, **KW)
    own = {"dcgan_gen": lambda ls: ls["dcgan_gen"],
           "dcgan_disc": lambda ls: ls["dcgan_disc"],
           "p2p_gen": lambda ls: ls["p2p_gen"] + 100.0 * ls["p2p_recon"],
           "p2p_disc": lambda ls: ls["p2p_disc"]}
    for n, pick in own.items():
        # an unpartitioned forward of everything, differentiated for one
        # network's own loss only
        ls = _plain_forward(tnets, *tbatch)
        want = torch.autograd.grad(pick(ls), list(tnets[n].parameters()),
                                   allow_unused=True)
        for g, w in zip(grads[n], want):
            w = torch.zeros_like(g) if w is None else w
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=0,
                atol=1e-5 * max(float(w.abs().max()), 1e-6))
        assert any(float(g.abs().max()) > 0 for g in grads[n]), n


def _plain_forward(nets, Z, X, Y):
    """The five losses with no detach anywhere (the reference semantics:
    each loss is later differentiated w.r.t. its own network only)."""
    adv = lambda p, t: losses.adv_loss(p, t, lsgan=True)  # noqa: E731
    a_fake = nets["dcgan_gen"](Z, train=True)
    b_fake = nets["p2p_gen"](X, train=True)
    dd, dp = nets["dcgan_disc"], nets["p2p_disc"]
    return {
        "dcgan_gen": adv(dd(a_fake, train=True), 1.0),
        "dcgan_disc": adv(dd(X, train=True), 1.0)
        + adv(dd(a_fake.detach(), train=True), 0.0),
        "p2p_gen": adv(dp(X, b_fake, train=True), 1.0),
        "p2p_recon": losses.reconstruction_loss(b_fake, Y),
        "p2p_disc": adv(dp(X, Y, train=True), 1.0)
        + adv(dp(X, b_fake.detach(), train=True), 0.0)}


@pytest.mark.parametrize("mode", ["dcgan", "p2p"])
def test_train_mode_updates_only_its_networks(mode, world):
    tnets, tbatch = _carried(world)
    before_p, before_s = _dump(tnets)
    opt = optim.rmsprop()
    tl = step.build_train_step(tnets, opt, train_mode=mode, **KW)(
        step.init_opt_states(tnets, opt), tbatch, None, LR)
    assert tuple(tl) == losses.TRAIN_KEYS  # all five, whatever the mode
    assert all(np.isfinite(float(v)) for v in tl.values())
    after_p, after_s = _dump(tnets)
    for n in tnets:
        same = all(jax.tree.leaves(jax.tree.map(
            np.array_equal, after_p[n], before_p[n])))
        assert same == (n not in step.ACTIVE[mode]), n
    # the running statistics follow the forward, which every mode runs
    assert not np.array_equal(after_s["p2p_gen"]["bottleneck"]["bn"]["mean"],
                              before_s["p2p_gen"]["bottleneck"]["bn"]["mean"])


def test_lr_mults_scale_one_network(world):
    opt = optim.rmsprop()
    deltas = {}
    for label, mults in (("base", None), ("half", {"dcgan_disc": 0.5})):
        tnets, tbatch = _carried(world)
        before, _ = _dump(tnets)
        step.build_train_step(tnets, opt, lr_mults=mults, **KW)(
            step.init_opt_states(tnets, opt), tbatch, None, LR)
        after, _ = _dump(tnets)
        deltas[label] = jax.tree.map(lambda a, b: a - b, after, before)
    for n in deltas["base"]:
        k = 0.5 if n == "dcgan_disc" else 1.0
        _tree_close(deltas["half"][n],
                    jax.tree.map(lambda d: k * d, deltas["base"][n]),
                    1e-3, 1e-7)
    with pytest.raises(ValueError, match="unknown networks"):
        step.build_train_step(tnets, opt, lr_mults={"nope": 2.0})


def test_eval_step_changes_nothing_and_scan_loops(world):
    tnets, tbatch = _carried(world)
    before = _dump(tnets)
    ev = step.build_eval_step(tnets, **KW)(tbatch)
    after = _dump(tnets)
    jax.tree.map(np.testing.assert_array_equal, after, before)
    opt = optim.rmsprop()
    scan = step.build_scan_step(step.build_train_step(tnets, opt, **KW))
    out = scan(step.init_opt_states(tnets, opt), [tbatch, tbatch],
               [None, None], LR)
    for k in losses.TRAIN_KEYS:
        assert tuple(out[k].shape) == (2,)
        # the eval losses are the first train step's (the same forward)
        assert float(ev[k]) == pytest.approx(float(out[k][0]), rel=1e-6)
    assert float(out["p2p_recon"][1]) != float(out["p2p_recon"][0])


def test_bn_discriminator_statistics_come_from_the_fake_pass(world):
    """With BN in a discriminator its three passes must not overwrite each
    other: the statistics left behind are the fake-batch pass's
    (terrain_tpu train/step.py:87-94)."""
    jnets, params, states, batch = world
    jd = junet.discriminator(IN_SHP, True, False, nf=4, act="linear",
                             bn=True)
    td = unet.discriminator(IN_SHP, True, False, nf=4, act="linear", bn=True,
                            generator=torch.Generator().manual_seed(5))
    pd, sd = convert.to_jax(td)
    jn = dict(jnets, p2p_disc=jd)
    jp = dict(params, p2p_disc=pd)
    jst = dict(states, p2p_disc=sd)
    jl, jnew = jstep.forward_losses(
        jn, jp, jst, *map(jnp.asarray, batch), jax.random.PRNGKey(0),
        train=True, **KW)
    tnets, tbatch = _carried(world)
    tnets["p2p_disc"] = td
    tl = step.forward_losses(tnets, *tbatch, train=True, update_stats=True,
                             **KW)
    for k in losses.TRAIN_KEYS:
        assert float(tl[k].detach()) == pytest.approx(float(jl[k]),
                                                     rel=2e-5)
    _tree_close(convert.to_jax(td)[1], jnew["p2p_disc"], 1e-5, 1e-6)


# ----------------------------------------------------------- experiments
def test_build_train_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            experiments.build_train("smoke_synthetic")
    with pytest.raises(KeyError):
        experiments.build_train("nope", "cpu")
    ts = experiments.build_train("smoke_synthetic", "cpu", seed=3)
    assert ts.lr == 1e-4 and ts.train_mode == "both"
    assert ts.optimizer.name == "rmsprop" and ts.in_shp == 64
    # the generators are the ones build_model gives for the same seed
    pipe, name = experiments.build_model("smoke_synthetic", "cpu", seed=3)
    assert name == ts.name
    for a, b in zip(pipe.dcgan_gen.parameters(),
                    ts.nets["dcgan_gen"].parameters()):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    batch = (torch.rand(2, 32, generator=g),
             torch.rand(2, 64, 64, 1, generator=g),
             torch.rand(2, 64, 64, 3, generator=g) * 2 - 1)
    before = [p.clone() for n in ts.nets.values() for p in n.parameters()]
    ls = ts.train_step(ts.opt_states, batch, None, ts.lr)
    assert all(np.isfinite(float(v)) for v in ls.values())
    after = [p for n in ts.nets.values() for p in n.parameters()]
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert set(ts.eval_step(batch)) == set(losses.TRAIN_KEYS)


def test_registry_training_half(monkeypatch):
    modes = {n: c["train_mode"] for n, (c, _) in experiments._CONFIGS.items()}
    assert modes["test1_nobn_finetunep2p_bilin"] == "p2p"
    assert modes["earth256_finetunep2p"] == "p2p"
    assert sum(m == "both" for m in modes.values()) == 7
    assert len(experiments.EXPERIMENTS) == 9
    stable = experiments.build_train("earth256_stable", "cpu")
    plain = experiments.build_train("earth256", "cpu")
    x = torch.zeros(1, 2, 2, 1) - 1
    assert float(stable.nets["dcgan_disc"].conv_out_act(x).max()) == -1.0
    assert float(plain.nets["dcgan_disc"].conv_out_act(x).max()) == 0.0
    assert param_count(plain.nets["p2p_disc"]) == 1_556_161
    # the environment overrides
    monkeypatch.setenv("TERRAIN_DISC_OUT", "linear")
    monkeypatch.setenv("TERRAIN_LR_MULTS", "dcgan_disc=0.5, p2p_disc=2")
    import os
    kw, mults = experiments.stability_overrides(os.environ)
    assert kw == {"conv_out_nonlinearity": "linear"}
    assert mults == {"dcgan_disc": 0.5, "p2p_disc": 2.0}
    monkeypatch.setenv("TERRAIN_LR_MULTS", "dcgan_disc")
    with pytest.raises(ValueError, match="name=float"):
        experiments.stability_overrides(os.environ)

"""Import the reference's Theano/Lasagne checkpoints into the port's
networks (tools/import_reference_weights.py's port: the same conversions,
the same payload format, no JAX).

The reference saves gzip-pickles (written by Python 2) of
{'dcgan': {'gen': [...], 'disc': [...]}, 'p2p': {'gen': [...], 'disc': [...]}}
where each list is lasagne.layers.get_all_param_values(net): every
parameter (trainable and BN running statistics) in topological layer
order.  Per layer, lasagne's order and the conversion to terrain_tpu's
NHWC trees, which `models/convert.load_jax` then carries into the port's
modules:
  DenseLayer        [W (din, dout), b]          as it is (but see below)
  Conv2DLayer       [W (cout, cin, kh, kw), b]  transposed (2, 3, 1, 0) and
      flipped on both spatial axes: lasagne's flip_filters=True is a true
      convolution, terrain_tpu's a correlation;
  TransposedConv2D  [W (cin, cout, kh, kw), b]  transposed (2, 3, 0, 1) and
      flipped: lasagne's deconvolution scatters the unflipped kernel,
      terrain_tpu's the flipped one;
  BatchNormLayer    [beta, gamma, mean, inv_std] -> params {gamma, beta},
      state {mean, inv_std}.
The DCGAN generator reshapes its dense output to (N, nch, s, s) in the
reference and to (N, s, s, nch) here, so the dense W's columns, b and the
following BatchNorm's vectors are permuted from (nch, s, s) to (s, s, nch).

Usage: python -m terrain_tpu_torch.tools.import_reference_weights \\
           ref.model out.model [--experiment test1_nobn_bilin_both]
           [--device cpu]
writes a terrain_tpu/v1 checkpoint (train/checkpoint.py) that either
package loads.
"""

import argparse
import gzip
import pickle
import sys

import numpy as np


# ------------------------------------------------------------- conversions
def conv_w_from_ref(W):
    """(cout, cin, kh, kw) true convolution -> (kh, kw, cin, cout)
    correlation."""
    return np.ascontiguousarray(np.transpose(W, (2, 3, 1, 0))[::-1, ::-1])


def conv_w_to_ref(w):
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (3, 2, 0, 1)))


def deconv_w_from_ref(W):
    """(cin, cout, kh, kw) unflipped scatter -> (kh, kw, cin, cout) flipped
    scatter."""
    return np.ascontiguousarray(np.transpose(W, (2, 3, 0, 1))[::-1, ::-1])


def deconv_w_to_ref(w):
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))


def dense_feats_from_ref(v, nch, s):
    """A per-feature vector (or W's columns) from (nch, s, s) C order to
    (s, s, nch) C order."""
    v = np.asarray(v)
    if v.ndim == 1:
        return v.reshape(nch, s, s).transpose(1, 2, 0).reshape(-1)
    return v.reshape(v.shape[0], nch, s, s).transpose(0, 2, 3, 1).reshape(
        v.shape[0], -1)


def dense_feats_to_ref(v, nch, s):
    v = np.asarray(v)
    if v.ndim == 1:
        return v.reshape(s, s, nch).transpose(2, 0, 1).reshape(-1)
    return v.reshape(v.shape[0], s, s, nch).transpose(0, 3, 1, 2).reshape(
        v.shape[0], -1)


class _Reader:
    def __init__(self, vals):
        self.vals = list(vals)
        self.i = 0

    def take(self, n=1):
        out = self.vals[self.i:self.i + n]
        if len(out) != n:
            raise ValueError(f"reference list exhausted at {self.i} (+{n} "
                             f"of {len(self.vals)})")
        self.i += n
        return out if n > 1 else out[0]

    def done(self):
        if self.i != len(self.vals):
            raise ValueError(f"unconsumed reference params: "
                             f"{self.i}/{len(self.vals)}")


class _Writer:
    def __init__(self):
        self.vals = []

    def put(self, *arrs):
        self.vals.extend(np.asarray(a, np.float32) for a in arrs)


def _bn_from(r, p, s, perm=lambda v: v):
    beta, gamma, mean, inv_std = r.take(4)
    p["beta"] = np.asarray(perm(beta), np.float32)
    p["gamma"] = np.asarray(perm(gamma), np.float32)
    s["mean"] = np.asarray(perm(mean), np.float32)
    s["inv_std"] = np.asarray(perm(inv_std), np.float32)


def _bn_to(w, p, s, perm=lambda v: v):
    w.put(perm(p["beta"]), perm(p["gamma"]), perm(s["mean"]),
          perm(s["inv_std"]))


def _conv_from(r, p, deconv=False):
    W, b = r.take(2)
    p["w"] = (deconv_w_from_ref if deconv else conv_w_from_ref)(W).astype(
        np.float32)
    p["b"] = np.asarray(b, np.float32)


def _conv_to(w, p, deconv=False):
    w.put((deconv_w_to_ref if deconv else conv_w_to_ref)(np.asarray(p["w"])),
          p["b"])


# ------------------------------------------------------ per-network walks
# Each walks a network's layers in the reference's order; `conv(p)`,
# `deconv(p)`, `bn(p, s, perm)` and `dense(p, perm)` read from or write to
# the reference list.
def _dcgan_gen(io, params, state, cfg):
    nch, s = cfg["nch"], cfg["initial_size"]
    io.dense(params["dense"], nch, s)
    io.bn(params["bn_in"], state["bn_in"],
          lambda v: io.perm(v, nch, s))
    for si in range(len(cfg["div"])):
        for ri in range(cfg["num_repeats"] + 1):
            io.conv(params["stages"][si][ri]["conv"])
            io.bn(params["stages"][si][ri]["bn"],
                  state["stages"][si][ri]["bn"])
    io.conv(params["conv_out"])


def _dcgan_disc(io, params, state, cfg):
    for si in range(len(cfg["div"])):
        for ri in range(cfg["num_repeats"] + 1):
            io.conv(params["stages"][si][ri]["conv"])
            if cfg["bn"]:
                io.bn(params["stages"][si][ri]["bn"],
                      state["stages"][si][ri]["bn"])
    io.conv(params["conv_out"])


def _unet(io, params, state, cfg):
    for i in range(cfg["n_down"]):
        io.conv(params["enc"][i]["conv"])
        io.bn(params["enc"][i]["bn"], state["enc"][i]["bn"])
        for rep in range(cfg["num_repeats"]):
            io.conv(params["enc"][i]["repeats"][rep]["conv"])
            io.bn(params["enc"][i]["repeats"][rep]["bn"],
                  state["enc"][i]["repeats"][rep]["bn"])
    io.conv(params["bottleneck"]["conv"])
    io.bn(params["bottleneck"]["bn"], state["bottleneck"]["bn"])
    for j in range(cfg["n_down"]):
        blk = params["dec"][j]
        if "deconv" in blk:
            io.conv(blk["deconv"], deconv=True)
        else:  # bilinear upsampling (no parameters) and a conv
            io.conv(blk["conv"])
        io.bn(blk["bn"], state["dec"][j]["bn"])
    io.conv(params["deconv_out"], deconv=True)


def _patchgan(io, params, state, cfg, bn_rule):
    for idx in range(len(cfg["mul_factor"])):
        for rep in range(cfg["num_repeats"] + 1):
            io.conv(params["blocks"][idx][rep]["conv"])
            if bn_rule(idx):
                io.bn(params["blocks"][idx][rep]["bn"],
                      state["blocks"][idx][rep]["bn"])
    io.conv(params["conv_out"])


class _From:
    """The walks' operations reading a reference list into trees."""

    def __init__(self, vals):
        self.r = _Reader(vals)

    @staticmethod
    def perm(v, nch, s):
        return dense_feats_from_ref(v, nch, s)

    def dense(self, p, nch, s):
        W, b = self.r.take(2)
        p["w"] = dense_feats_from_ref(W, nch, s).astype(np.float32)
        p["b"] = dense_feats_from_ref(b, nch, s).astype(np.float32)

    def bn(self, p, s, perm=lambda v: v):
        _bn_from(self.r, p, s, perm)

    def conv(self, p, deconv=False):
        _conv_from(self.r, p, deconv)


class _To:
    """The walks' operations writing trees as a reference list."""

    def __init__(self):
        self.w = _Writer()

    @staticmethod
    def perm(v, nch, s):
        return dense_feats_to_ref(np.asarray(v), nch, s)

    def dense(self, p, nch, s):
        self.w.put(dense_feats_to_ref(np.asarray(p["w"]), nch, s),
                   dense_feats_to_ref(np.asarray(p["b"]), nch, s))

    def bn(self, p, s, perm=lambda v: v):
        _bn_to(self.w, p, s, perm)

    def conv(self, p, deconv=False):
        _conv_to(self.w, p, deconv)


_WALKS = (("dcgan", "gen", "dcgan_gen", _dcgan_gen),
          ("dcgan", "disc", "dcgan_disc", _dcgan_disc),
          ("p2p", "gen", "p2p_gen", _unet),
          ("p2p", "disc", "p2p_disc", _patchgan))


def _trees(model):
    from terrain_tpu_torch.models import convert

    return {n: convert.to_jax(model.nets[n]) for _, _, n, _ in _WALKS}


def _bn_rule(trees, patchgan_bn_rule):
    """The PatchGAN's BatchNorm rule: the p2p discriminator's `bn` on every
    block unless given (the reference's `discriminator`)."""
    if patchgan_bn_rule is not None:
        return patchgan_bn_rule
    has_bn = "bn" in trees["p2p_disc"][0]["blocks"][0][0]
    return lambda idx: has_bn


def _walk(fn, io, trees, net, model, rule):
    params, state = trees[net]
    cfg = model.nets[net].config
    if fn is _patchgan:
        fn(io, params, state, cfg, rule)
    else:
        fn(io, params, state, cfg)


def import_into_model(ref_payload, model, patchgan_bn_rule=None):
    """Load a reference pickle's payload into a TwoStageGAN's four networks
    (`model.nets`), in place.  `patchgan_bn_rule(idx) -> bool` defaults to
    the p2p discriminator's own BatchNorms on every block."""
    from terrain_tpu_torch.models import convert

    trees = _trees(model)
    rule = _bn_rule(trees, patchgan_bn_rule)
    for stage, role, net, fn in _WALKS:
        io = _From(ref_payload[stage][role])
        _walk(fn, io, trees, net, model, rule)
        io.r.done()
    for _, _, net, _ in _WALKS:
        convert.load_jax(model.nets[net], *trees[net])
    return model


def export_from_model(model, patchgan_bn_rule=None):
    """The inverse of `import_into_model`: a reference-format payload of
    float32 arrays."""
    trees = _trees(model)
    rule = _bn_rule(trees, patchgan_bn_rule)
    out = {"dcgan": {}, "p2p": {}}
    for stage, role, net, fn in _WALKS:
        io = _To()
        _walk(fn, io, trees, net, model, rule)
        out[stage][role] = io.w.vals
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ref_model", help="reference gzip-pickle checkpoint")
    ap.add_argument("out_model", help="terrain_tpu/v1 checkpoint to write")
    ap.add_argument("--experiment", default="test1_nobn_bilin_both")
    ap.add_argument("--device", default=None,
                    help="where the networks are built (default: the card)")
    args = ap.parse_args(argv)
    from terrain_tpu_torch.experiments import build_gan
    from terrain_tpu_torch.train import checkpoint

    model, _ = build_gan(args.experiment, args.device, verbose=False)
    with gzip.open(args.ref_model, "rb") as f:
        payload = pickle.load(f, encoding="latin1")  # a Python 2 pickle
    import_into_model(payload, model)
    trees = _trees(model)
    checkpoint.save_model(args.out_model, {n: t[0] for n, t in trees.items()},
                          {n: t[1] for n, t in trees.items()})
    print(f"imported {args.ref_model} -> {args.out_model}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

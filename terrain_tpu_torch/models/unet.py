"""pix2pix U-Net generator and PatchGAN discriminators, stage 2:
heightmap -> texture (terrain_tpu/models/unet.py:56-320).

For n_down = log2(in_shp) - 1 stride-2 stages:
  encoder: Conv k3 s2 'same' -> BN (skip taps the BN output) -> leaky 0.01,
           channels nf*[1,2,4,8,8,...], optional stride-1 repeats;
  bottleneck: Conv k2 s1 VALID -> BN -> leaky (1x1);
  decoder: Deconv k2 s1 (1->2), then per stage Deconv k2 s2 or, with
           bilinear_upsample, bilinear x2 + Conv k3 (ops/fused.py, the
           bilinear_conv kernel in its regime); BN, optional dropout on the
           first 3 blocks, concat with the mirror skip, leaky 0.01;
  output: Deconv k2 s2 -> out_ch -> act (tanh), in [-1,1].

PatchGAN over concat(A, B): per block in mul_factor (num_repeats+1) x
[Conv k3 'same' (stride 2 on the first repeat) -> leaky 0.01 -> optional
BN, *after* the activation as in the reference], then Conv k3 s2 -> 1 ->
act.  `discriminator2` has BN on every block but the first.

Spatial parallelism (parallel/spatial.shard_rows): both networks give each
layer and BatchNorm the whole heights it works at (`io_rows`), so a
network whose images are held in slabs of rows runs each on the slab or
on whole rows by the one rule of parallel/spatial.py; the U-Net's skips
then have the layout of the decoder tensors they join.  Such a network
takes its input as slabs and returns its output as slabs when the
output's height is held in slabs (`out_rows`, its whole height), else
whole.
"""

import math

import torch
from torch import nn

from terrain_tpu_torch.models.core import Conv, Deconv, dropout as _drop
from terrain_tpu_torch.ops import (
    BatchNorm, bilinear2x_conv3x3, conv2d, conv2d_leaky, conv2d_transpose,
    get_activation, leaky_relu)


def _enc_mults(n_down):
    return [min(2 ** i, 8) for i in range(n_down)]


class UNetGenerator(nn.Module):
    """Parameter tree as terrain_tpu's: enc[i] {conv, bn, repeats[r]
    {conv, bn}}, bottleneck {conv, bn}, dec[j] {deconv|conv, bn},
    deconv_out."""

    def __init__(self, in_shp, is_a_grayscale, is_b_grayscale, nf=64,
                 act="tanh", dropout_p=0.0, num_repeats=0,
                 bilinear_upsample=False, compute_dtype=None, generator=None):
        super().__init__()
        if isinstance(dropout_p, bool):
            dropout_p = 0.5 if dropout_p else 0.0
        n_down = int(math.log2(in_shp)) - 1
        if 2 ** (n_down + 1) != in_shp or n_down < 2:
            raise ValueError(f"in_shp {in_shp} must be a power of two >= 8")
        g = generator if generator is not None else torch.Generator()
        self.in_shp, self.n_down = in_shp, n_down
        self.out_rows = in_shp
        self.name = "unet_generator"
        self.config = dict(
            in_shp=in_shp, in_ch=1 if is_a_grayscale else 3,
            out_ch=1 if is_b_grayscale else 3, nf=nf, act=act,
            dropout_p=dropout_p, num_repeats=num_repeats,
            bilinear_upsample=bilinear_upsample, n_down=n_down)
        self.dropout_p, self.num_repeats = float(dropout_p), num_repeats
        self.bilinear_upsample = bilinear_upsample
        self.compute_dtype = compute_dtype
        self.data_shard = None  # (index, count) under data parallelism
        self.act = get_activation(act)
        mults = _enc_mults(n_down)
        in_ch = 1 if is_a_grayscale else 3
        out_ch = 1 if is_b_grayscale else 3
        enc, cin = [], in_ch
        for m in mults:
            cout = nf * m
            blk = {"conv": Conv(3, cin, cout, g), "bn": BatchNorm(cout)}
            blk["repeats"] = nn.ModuleList(
                nn.ModuleDict({"conv": Conv(3, cout, cout, g),
                               "bn": BatchNorm(cout)})
                for _ in range(num_repeats))
            enc.append(nn.ModuleDict(blk))
            cin = cout
        self.enc = nn.ModuleList(enc)
        cb = nf * mults[-1]
        self.bottleneck = nn.ModuleDict(
            {"conv": Conv(2, cin, cb, g), "bn": BatchNorm(cb)})
        dec, cin = [], cb
        for j in range(n_down):
            cout = nf * mults[n_down - 1 - j]
            if j == 0 or not bilinear_upsample:
                blk = {"deconv": Deconv(2, cin, cout, g)}
            else:
                blk = {"conv": Conv(3, cin, cout, g)}
            blk["bn"] = BatchNorm(cout)
            dec.append(nn.ModuleDict(blk))
            cin = cout + nf * mults[n_down - 1 - j]
        self.dec = nn.ModuleList(dec)
        self.deconv_out = Deconv(2, cin, out_ch, g)
        self._set_heights()

    rows = None  # parallel/spatial.RowShard when held in slabs of rows

    def _set_heights(self):
        """Each layer's and BatchNorm's whole (input, output) heights."""
        h = self.in_shp
        for blk in self.enc:
            blk["conv"].io_rows = (h, h // 2)
            h //= 2
            blk["bn"].io_rows = (h, h)
            for rep in blk["repeats"]:
                rep["conv"].io_rows = rep["bn"].io_rows = (h, h)
        self.bottleneck["conv"].io_rows = (h, h - 1)
        h -= 1
        self.bottleneck["bn"].io_rows = (h, h)
        for blk in self.dec:
            layer = blk["deconv"] if "deconv" in blk else blk["conv"]
            layer.io_rows = (h, 2 * h)
            h *= 2
            blk["bn"].io_rows = (h, h)
        self.deconv_out.io_rows = (h, 2 * h)

    def forward(self, x, train=False, generator=None, update_stats=False):
        """x (N, in_shp, in_shp, in_ch) -> (N, in_shp, in_shp, out_ch) fp32.
        train=True uses batch statistics and live dropout drawn from
        `generator`; the running statistics are written only with
        update_stats=True (a train step)."""
        us = update_stats
        cd = self.compute_dtype or torch.float32
        x = x.to(cd)
        skips = []
        for blk in self.enc:
            x = blk["conv"](conv2d, x, stride=2, padding="same",
                            compute_dtype=cd)
            x = blk["bn"](x, train, us)
            skips.append(x)  # skip = BN output, pre-activation
            x = leaky_relu(x, 0.01)
            for rep in blk["repeats"]:
                x = rep["conv"](conv2d, x, stride=1, padding="same",
                                compute_dtype=cd)
                x = leaky_relu(rep["bn"](x, train, us), 0.01)
        bt = self.bottleneck
        x = bt["conv"](conv2d, x, stride=1, padding="valid",
                       compute_dtype=cd)
        x = leaky_relu(bt["bn"](x, train, us), 0.01)
        for j, blk in enumerate(self.dec):
            if j == 0:
                x = blk["deconv"](conv2d_transpose, x, stride=1,
                                  compute_dtype=cd)
            elif self.bilinear_upsample:
                x = blk["conv"](bilinear2x_conv3x3, x, compute_dtype=cd)
            else:
                x = blk["deconv"](conv2d_transpose, x, stride=2,
                                  compute_dtype=cd)
            x = blk["bn"](x, train, us)
            if self.dropout_p > 0.0 and j < 3:
                x = _drop(x, self.dropout_p, generator, train,
                          self.data_shard, self.rows and self.rows.part(
                              blk["bn"].io_rows[0]))
            x = leaky_relu(torch.cat([x, skips[self.n_down - 1 - j]], -1),
                           0.01)
        x = self.deconv_out(conv2d_transpose, x, stride=2, compute_dtype=cd)
        return self.act(x.float())


def g_unet(in_shp, is_a_grayscale, is_b_grayscale, nf=64, act="tanh",
           dropout_p=False, num_repeats=0, bilinear_upsample=False,
           compute_dtype=None, dropout=None, generator=None):
    """U-Net generator factory with terrain_tpu's config keys (`dropout`
    is the reference's alias of dropout_p)."""
    if dropout is not None:
        dropout_p = dropout
    return UNetGenerator(in_shp, is_a_grayscale, is_b_grayscale, nf=nf,
                         act=act, dropout_p=dropout_p,
                         num_repeats=num_repeats,
                         bilinear_upsample=bilinear_upsample,
                         compute_dtype=compute_dtype, generator=generator)


def g_unet_256(in_shp, is_a_grayscale, is_b_grayscale, nf=64, act="tanh",
               dropout=0.0, compute_dtype=None, generator=None):
    """256px variant: same topology, deconv-only decoder, float dropout on
    the first 3 decoder blocks."""
    if in_shp != 256:
        raise ValueError("g_unet_256 requires in_shp == 256")
    return g_unet(in_shp, is_a_grayscale, is_b_grayscale, nf=nf, act=act,
                  dropout_p=float(dropout), num_repeats=0,
                  bilinear_upsample=False, compute_dtype=compute_dtype,
                  generator=generator)


class PatchGAN(nn.Module):
    """Parameter tree as terrain_tpu's: blocks[idx][r] {conv, [bn]},
    conv_out.  `bn_rule(idx)` says which blocks carry BN."""

    def __init__(self, in_shp, is_a_grayscale, is_b_grayscale, nf, act,
                 mul_factor, num_repeats, bn_rule, compute_dtype, generator,
                 name="patchgan_discriminator"):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.in_shp = in_shp
        self.name = name
        self.config = dict(
            in_shp=in_shp, a_ch=1 if is_a_grayscale else 3,
            b_ch=1 if is_b_grayscale else 3, nf=nf, act=act,
            mul_factor=tuple(mul_factor), num_repeats=num_repeats)
        self.act = get_activation(act)
        self.compute_dtype = compute_dtype
        cin = (1 if is_a_grayscale else 3) + (1 if is_b_grayscale else 3)
        blocks, h = [], in_shp
        for idx, m in enumerate(tuple(mul_factor)):
            reps = []
            for r in range(num_repeats + 1):
                blk = {"conv": Conv(3, cin, nf * m, g)}
                blk["conv"].io_rows = (h, h // 2 if r == 0 else h)
                h = blk["conv"].io_rows[1]
                if bn_rule(idx):
                    blk["bn"] = BatchNorm(nf * m)
                    blk["bn"].io_rows = (h, h)
                reps.append(nn.ModuleDict(blk))
                cin = nf * m
            blocks.append(nn.ModuleList(reps))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv(3, cin, 1, g)
        self.conv_out.io_rows = (h, h // 2)
        self.out_rows = h // 2

    rows = None  # parallel/spatial.RowShard when held in slabs of rows

    def forward(self, a, b, train=False, generator=None, update_stats=False):
        """a (N,S,S,a_ch), b (N,S,S,b_ch) -> patch map (N,s,s,1) fp32."""
        cd = self.compute_dtype or torch.float32
        x = torch.cat([a.to(cd), b.to(cd)], -1)
        for reps in self.blocks:
            for r, rep in enumerate(reps):
                x = rep["conv"](conv2d_leaky, x, slope=0.01,
                                stride=2 if r == 0 else 1, padding="same",
                                compute_dtype=cd)
                if "bn" in rep:
                    x = rep["bn"](x, train, update_stats)
        # the final conv keeps the reference wrapper's default stride 2
        x = self.conv_out(conv2d, x, stride=2, padding="same",
                          compute_dtype=cd)
        return self.act(x.float())


def discriminator(in_shp, is_a_grayscale, is_b_grayscale, nf=32,
                  act="sigmoid", mul_factor=(1, 2, 4, 8), num_repeats=0,
                  bn=False, compute_dtype=None, generator=None):
    """PatchGAN over concat(A, B)."""
    return PatchGAN(in_shp, is_a_grayscale, is_b_grayscale, nf, act,
                    mul_factor, num_repeats, lambda idx: bn, compute_dtype,
                    generator)


def discriminator2(in_shp, is_a_grayscale, is_b_grayscale, nf=32,
                   act="sigmoid", mul_factor=(1, 2, 4, 8), num_repeats=0,
                   compute_dtype=None, generator=None):
    """PatchGAN variant with BN on every block except the first."""
    return PatchGAN(in_shp, is_a_grayscale, is_b_grayscale, nf, act,
                    mul_factor, num_repeats, lambda idx: idx != 0,
                    compute_dtype, generator, name="patchgan_discriminator2")


class FakeGenerator(nn.Module):
    """One-conv debug generator; tree {conv}."""

    def __init__(self, is_a_grayscale, is_b_grayscale, act="tanh",
                 in_shp=512, compute_dtype=None, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.in_shp, self.compute_dtype = in_shp, compute_dtype
        self.name, self.config = "fake_generator", dict(in_shp=in_shp)
        self.act = get_activation(act)
        self.conv = Conv(3, 1 if is_a_grayscale else 3,
                         1 if is_b_grayscale else 3, g)

    def forward(self, x, train=False, generator=None, update_stats=False):
        cd = self.compute_dtype or torch.float32
        x = self.conv(conv2d, x.to(cd), stride=1, padding="same",
                      compute_dtype=cd)
        return self.act(x.float())


class FakeDiscriminator(nn.Module):
    """One-conv debug discriminator (stride 2, linear output); tree
    {conv}."""

    def __init__(self, is_a_grayscale, is_b_grayscale, in_shp=512,
                 compute_dtype=None, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.in_shp, self.compute_dtype = in_shp, compute_dtype
        self.name, self.config = "fake_discriminator", dict(in_shp=in_shp)
        cin = (1 if is_a_grayscale else 3) + (1 if is_b_grayscale else 3)
        self.conv = Conv(3, cin, 1, g)

    def forward(self, a, b, train=False, generator=None, update_stats=False):
        cd = self.compute_dtype or torch.float32
        x = torch.cat([a.to(cd), b.to(cd)], -1)
        x = self.conv(conv2d, x, stride=2, padding="same", compute_dtype=cd)
        return x.float()


def fake_generator(is_a_grayscale, is_b_grayscale, **kwargs):
    return FakeGenerator(is_a_grayscale, is_b_grayscale, **kwargs)


def fake_discriminator(is_a_grayscale, is_b_grayscale, **kwargs):
    return FakeDiscriminator(is_a_grayscale, is_b_grayscale, **kwargs)

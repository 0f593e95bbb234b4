"""DCGAN generator and discriminator, stage 1: z -> heightmap
(terrain_tpu/models/dcgan.py:54-250).

    z(latent_dim) -> Dense(nch*s0*s0) -> BN -> reshape (s0,s0,nch)
    -> per stage in div: (num_repeats+1) x [Conv(h) 'same' -> BN ->
       LeakyReLU(0.2) -> optional dropout], then x2 upsample
    -> Conv(h) -> out_ch -> sigmoid.   Output (N,512,512,1) in [0,1].

With the nearest upsample and an odd h, each upsample and the conv after it
run as one phase-decomposed low-resolution conv (ops/fused.py); the output
conv then lands in the conv_thin kernel's regime.

Discriminator:
    image -> per stage in div: (num_repeats+1) x [Conv(h) 'same' ->
       optional BN -> LeakyReLU(0.2)], then 2x2 pool (max or average)
    -> Conv(h) -> 1 channel with ReLU (lasagne's Conv2DLayer default, kept
       from the reference) -> AvgPool(nch // 2^len(div)) -> (N,1) ->
       output nonlinearity.
Without BN each conv + LeakyReLU is one `conv2d_leaky`, so that the first
layer lands in the conv_stem kernel's regime with its fused activation.
"""

import torch
from torch import nn

from terrain_tpu_torch.models.core import Conv, Dense, dropout
from terrain_tpu_torch.ops import (
    BatchNorm, avg_pool2d, conv2d, conv2d_leaky, dense, get_activation,
    leaky_relu, max_pool2d, upsample2x_nearest_conv, upsample_bilinear_2x,
    upsample_nearest_2x)


class DCGANGenerator(nn.Module):
    """Parameter tree as terrain_tpu's: dense, bn_in, stages[si][ri]
    {conv, bn}, conv_out."""

    def __init__(self, latent_dim, is_a_grayscale, nch=512, h=5,
                 initial_size=4, final_size=512, div=(2, 2, 4, 4, 8, 8, 16),
                 num_repeats=0, dropout_p=0.0, bilinear_upsample=False,
                 compute_dtype=None, generator=None):
        super().__init__()
        div = tuple(div)
        if initial_size * 2 ** len(div) != final_size:
            raise ValueError(f"initial_size {initial_size} x 2^{len(div)} "
                             f"!= final_size {final_size}")
        g = generator if generator is not None else torch.Generator()
        self.latent_dim = latent_dim
        self.out_ch = 1 if is_a_grayscale else 3
        self.nch, self.h, self.initial_size = nch, h, initial_size
        self.num_repeats, self.dropout_p = num_repeats, dropout_p
        self.bilinear_upsample = bilinear_upsample
        self.compute_dtype = compute_dtype
        self.data_shard = None  # (index, count) under data parallelism
        self.dense = Dense(latent_dim, nch * initial_size ** 2, g)
        self.bn_in = BatchNorm(nch * initial_size ** 2)
        stages, cin = [], nch
        for n in (nch // d for d in div):
            reps = []
            for _ in range(num_repeats + 1):
                reps.append(nn.ModuleDict(
                    {"conv": Conv(h, cin, n, g), "bn": BatchNorm(n)}))
                cin = n
            stages.append(nn.ModuleList(reps))
        self.stages = nn.ModuleList(stages)
        self.conv_out = Conv(h, cin, self.out_ch, g)

    def _conv(self, x, conv, pending_up):
        cd = self.compute_dtype
        if pending_up:
            if not self.bilinear_upsample and self.h % 2 == 1:
                return upsample2x_nearest_conv(x, conv.w, conv.b,
                                               compute_dtype=cd)
            x = (upsample_bilinear_2x(x) if self.bilinear_upsample
                 else upsample_nearest_2x(x))
        return conv2d(x, conv.w, conv.b, stride=1, padding="same",
                      compute_dtype=cd)

    def forward(self, z, train=False, generator=None, update_stats=False):
        """z (N, latent_dim) -> (N, final, final, out_ch) fp32 in [0,1].
        train=True uses batch statistics and live dropout drawn from
        `generator`; the running statistics are written only with
        update_stats=True (a train step)."""
        cd = self.compute_dtype or torch.float32
        x = dense(z.to(cd), self.dense.w, self.dense.b, compute_dtype=cd)
        x = self.bn_in(x, train, update_stats)
        s0 = self.initial_size
        x = x.reshape(x.shape[0], s0, s0, self.nch)
        pending_up = False
        for stage in self.stages:
            for rep in stage:
                x = self._conv(x, rep["conv"], pending_up)
                pending_up = False
                x = leaky_relu(rep["bn"](x, train, update_stats), 0.2)
                if self.dropout_p > 0.0:
                    x = dropout(x, self.dropout_p, generator, train,
                                self.data_shard)
            pending_up = True
        x = self._conv(x, self.conv_out, pending_up)
        return torch.sigmoid(x.float())


def default_generator(latent_dim, is_a_grayscale, **kwargs):
    """DCGAN generator factory with terrain_tpu's config keys."""
    return DCGANGenerator(latent_dim, is_a_grayscale, **kwargs)


class DCGANDiscriminator(nn.Module):
    """Parameter tree as terrain_tpu's: stages[si][ri] {conv, [bn]},
    conv_out."""

    def __init__(self, in_shp, is_a_grayscale, nch=512, h=5,
                 div=(8, 4, 4, 2, 2, 1, 1), num_repeats=0, bn=False,
                 pool_mode="max", nonlinearity="sigmoid",
                 conv_out_nonlinearity="relu", compute_dtype=None,
                 generator=None):
        super().__init__()
        div = tuple(div)
        self.reduction = nch // 2 ** len(div)
        final_spatial = in_shp // 2 ** len(div)
        if self.reduction != final_spatial:
            # the reference derives the last pool's window from nch, not
            # from the spatial size: it only fits when nch == in_shp
            raise ValueError(
                f"avg-pool window nch//2^len(div)={self.reduction} must "
                f"equal the remaining extent in_shp//2^len(div)="
                f"{final_spatial}")
        g = generator if generator is not None else torch.Generator()
        self.bn, self.pool_mode = bn, pool_mode
        self.act = get_activation(nonlinearity)
        self.conv_out_act = get_activation(conv_out_nonlinearity)
        self.compute_dtype = compute_dtype
        stages, cin = [], 1 if is_a_grayscale else 3
        for n in (nch // d for d in div):
            reps = []
            for _ in range(num_repeats + 1):
                blk = {"conv": Conv(h, cin, n, g)}
                if bn:
                    blk["bn"] = BatchNorm(n)
                reps.append(nn.ModuleDict(blk))
                cin = n
            stages.append(nn.ModuleList(reps))
        self.stages = nn.ModuleList(stages)
        self.conv_out = Conv(h, cin, 1, g)

    def forward(self, x, train=False, generator=None, update_stats=False):
        """x (N, in_shp, in_shp, in_ch) -> (N, 1) fp32."""
        cd = self.compute_dtype or torch.float32
        x = x.to(cd)
        for stage in self.stages:
            for rep in stage:
                c = rep["conv"]
                if self.bn:
                    x = conv2d(x, c.w, c.b, stride=1, padding="same",
                               compute_dtype=cd)
                    x = leaky_relu(rep["bn"](x, train, update_stats), 0.2)
                else:
                    x = conv2d_leaky(x, c.w, c.b, slope=0.2, stride=1,
                                     padding="same", compute_dtype=cd)
            x = max_pool2d(x, 2) if self.pool_mode == "max" \
                else avg_pool2d(x, 2)
        x = conv2d(x, self.conv_out.w, self.conv_out.b, stride=1,
                   padding="same", compute_dtype=cd)
        x = avg_pool2d(self.conv_out_act(x), self.reduction)
        return self.act(x.reshape(x.shape[0], 1).float())


def default_discriminator(in_shp, is_a_grayscale, **kwargs):
    """DCGAN discriminator factory with terrain_tpu's config keys."""
    return DCGANDiscriminator(in_shp, is_a_grayscale, **kwargs)

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

Spatial parallelism (parallel/spatial.shard_rows): both networks give
each conv and BatchNorm the whole heights it works at (`io_rows`), as
models/unet.py does, so a network held in slabs of rows runs each on the
slab or on whole rows by the one rule of parallel/spatial.py.  The
generator starts from a vector: its Dense layer and `bn_in` carry no
rows, its small stages run on whole rows, the first stage whose output
the rule holds in slabs scatters it (or the reshape, when the rule holds
the first map in slabs), and its output is a slab (`out_rows`, the final
height).  A stage's upsample and the conv after it run as one op on the
slab with a halo: the nearest x2 fused with an odd-h conv
(ops/fused.upsample2x_nearest_conv, one low-resolution row a side), or
with bilinear_upsample the bilinear x2 and the conv unfused, as
terrain_tpu runs them (ops/fused.bilinear2x_conv, two rows a side for the
default h = 5).  An even h under row sharding raises: 'same' pads
(h-1)//2 rows on each side, as in terrain_tpu (ops/conv.py:105-106), so
each conv's output is one row shorter than its input and the heights are
no equal slabs (on one device the port gives terrain_tpu's shrunken
output).  The discriminator takes its input as
slabs, pools a slab between stages (`spatial.pool`, gathering where the
rule ends slabs) and returns its (N, 1) output whole (`out_rows` 1,
never a slab).
"""

import torch
from torch import nn

from terrain_tpu_torch.models.core import Conv, Dense, dropout
from terrain_tpu_torch.ops import (
    BatchNorm, avg_pool2d, bilinear2x_conv, conv2d, conv2d_leaky, dense,
    get_activation, leaky_relu, max_pool2d, upsample2x_nearest_conv,
    upsample_nearest_2x)
from terrain_tpu_torch.parallel import spatial


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
        self.out_rows = final_size
        self.out_ch = 1 if is_a_grayscale else 3
        # terrain_tpu's Network name and factory config (models/core.describe)
        self.name = "dcgan_generator"
        self.config = dict(
            latent_dim=latent_dim, out_ch=self.out_ch, nch=nch, h=h,
            initial_size=initial_size, final_size=final_size, div=div,
            num_repeats=num_repeats, dropout_p=dropout_p,
            bilinear_upsample=bilinear_upsample)
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
        self._set_heights()

    rows = None  # parallel/spatial.RowShard when held in slabs of rows

    def _set_heights(self):
        """Each conv's and BatchNorm's whole (input, output) heights: a
        stage's first conv doubles them (after the upsample), the rest
        keep them."""
        h = self.initial_size
        for si, stage in enumerate(self.stages):
            for ri, rep in enumerate(stage):
                up = si > 0 and ri == 0
                rep["conv"].io_rows = (h, 2 * h if up else h)
                h = rep["conv"].io_rows[1]
                rep["bn"].io_rows = (h, h)
        self.conv_out.io_rows = (h, 2 * h if len(self.stages) else h)

    def _conv(self, x, conv, pending_up):
        cd = self.compute_dtype
        if pending_up:
            if self.bilinear_upsample:
                return conv(bilinear2x_conv, x, compute_dtype=cd)
            if self.h % 2 == 1:
                return conv(upsample2x_nearest_conv, x, compute_dtype=cd)
            x = upsample_nearest_2x(x)
        return conv(conv2d, x, stride=1, padding="same", compute_dtype=cd)

    def forward(self, z, train=False, generator=None, update_stats=False):
        """z (N, latent_dim) -> (N, final, final, out_ch) fp32 in [0,1].
        train=True uses batch statistics and live dropout drawn from
        `generator`; the running statistics are written only with
        update_stats=True (a train step)."""
        if self.rows is not None and self.h % 2 == 0:
            raise ValueError(
                f"a DCGAN generator of even h ({self.h}) in slabs of rows: "
                f"'same' pads (h-1)//2 rows on each side, so each conv's "
                f"output is one row shorter than its input and the heights "
                f"do not stay equal slabs; take an odd h")
        cd = self.compute_dtype or torch.float32
        x = self.dense(dense, z.to(cd), compute_dtype=cd)
        x = self.bn_in(x, train, update_stats)
        s0 = self.initial_size
        x = x.reshape(x.shape[0], s0, s0, self.nch)
        if self.rows is not None and self.rows.slab(s0):
            x = spatial.scatter_rows(x, self.rows)
        pending_up = False
        for stage in self.stages:
            for rep in stage:
                x = self._conv(x, rep["conv"], pending_up)
                pending_up = False
                x = leaky_relu(rep["bn"](x, train, update_stats), 0.2)
                if self.dropout_p > 0.0:
                    x = dropout(x, self.dropout_p, generator, train,
                                self.data_shard, self.rows and self.rows.part(
                                    rep["bn"].io_rows[0]))
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
        self.in_shp = in_shp
        self.out_rows = 1  # (N, 1): whole on every rank
        self.name = "dcgan_discriminator"
        self.config = dict(
            in_shp=in_shp, in_ch=1 if is_a_grayscale else 3, nch=nch, h=h,
            div=div, num_repeats=num_repeats, bn=bn, pool_mode=pool_mode,
            nonlinearity=nonlinearity,
            conv_out_nonlinearity=conv_out_nonlinearity)
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
        h = in_shp
        for stage in self.stages:
            for rep in stage:
                for m in rep.values():
                    m.io_rows = (h, h)
            h //= 2
        self.conv_out.io_rows = (h, h)

    rows = None  # parallel/spatial.RowShard when held in slabs of rows

    def forward(self, x, train=False, generator=None, update_stats=False):
        """x (N, in_shp, in_shp, in_ch) -> (N, 1) fp32; held in slabs of
        rows, x is this rank's slab and the output is whole."""
        cd = self.compute_dtype or torch.float32
        pool = max_pool2d if self.pool_mode == "max" else avg_pool2d
        x = x.to(cd)
        h = self.in_shp
        for stage in self.stages:
            for rep in stage:
                c = rep["conv"]
                if self.bn:
                    x = c(conv2d, x, stride=1, padding="same",
                          compute_dtype=cd)
                    x = leaky_relu(rep["bn"](x, train, update_stats), 0.2)
                else:
                    x = c(conv2d_leaky, x, slope=0.2, stride=1,
                          padding="same", compute_dtype=cd)
            x = spatial.pool(pool, x, self.rows, h, 2)
            h //= 2
        x = self.conv_out(conv2d, x, stride=1, padding="same",
                          compute_dtype=cd)
        x = spatial.pool(avg_pool2d, self.conv_out_act(x), self.rows, h,
                         self.reduction)
        return self.act(x.reshape(x.shape[0], 1).float())


def default_discriminator(in_shp, is_a_grayscale, **kwargs):
    """DCGAN discriminator factory with terrain_tpu's config keys."""
    return DCGANDiscriminator(in_shp, is_a_grayscale, **kwargs)

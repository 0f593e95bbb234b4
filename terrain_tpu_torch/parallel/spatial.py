"""Spatial parallelism: image rows over 'model' (terrain_tpu's
`spatial_batch_sharding`, parallel/mesh.py:41-49), with the halo
exchanges that XLA inserts there written out.

A network whose row shard is set (`shard_rows`) holds each image as
slabs: rank `index` of the model group holds rows index*H/count ..
(index+1)*H/count - 1 of every image of its data block.  The rule for
where a network leaves slabs for whole rows and comes back is one, by
height: a tensor of whole height H is held in slabs when H divides over
the model group and each slab has at least MIN_ROWS (8) rows, else every
rank of the model group holds it whole.  A layer runs on slabs when its
input and its output are both held in slabs; a
layer whose input is in slabs and whose output is not (an encoder stage
going below the rule's height) gathers its input first, one whose output
is in slabs and whose input is not (the mirrored decoder stage) scatters
its output.  Since the layout follows the height alone, every skip of
the U-Net has the layout of the decoder tensor it joins.

A layer on slabs runs its op through `on_slab`, which gives the op the
whole image's shape (`route_shape`, ops/conv.py, ops/resize.py,
ops/fused.py), so it takes the route, kernel or library, that the whole
image would take, and runs it on the slab with a halo of neighbours' rows:
a 'same' k x k conv at stride 1 reads (k-1)//2 rows on each side, the
3x3 stride-2 conv one row above (Lasagne pads symmetrically, so output
row y reads input rows 2y-1 .. 2y+1), the bilinear x2, the fused
bilinear x2 + 3x3 conv and the fused nearest x2 + k x k conv (the DCGAN
generator's stages, k = 3 or 5) one low-resolution row on each side, the
bilinear x2 + 5x5 conv (the DCGAN generator's stages with
bilinear_upsample) two (`upsample_halo`).
The op runs on the slab
with its halo as if that were the image and keeps the rows of the slab:
rows next to a halo are exact, because the halo holds the true
neighbours, and at the image's top and bottom the ranks there get no
halo, so the op's own zero padding or edge clamp applies, as on the
whole image.  The k2 s2 deconv needs no halo, and neither does a pool
whose windows lie inside the slabs (`pool`: the 2x2 pools of the DCGAN
discriminator on slabs of an even number of rows); where the rule ends
slabs after such a pool the pooled rows are gathered, half the bytes of
gathering the input first.

Gradients.  A whole tensor is the same on every rank of the model group,
and so is its cotangent: everything after it is computed alike, with the
whole loss.  A slab's cotangent is that of its rows.  So:
  * `gather_rows` (slab -> whole) keeps this rank's rows of the cotangent,
    with no communication;
  * `scatter_rows` (whole -> slab) sums the padded slab cotangents over
    the model group;
  * `halo_exchange` sends each halo row's cotangent back to the rank
    that owns the row, where it is added;
  * a slab layer's weight gradient is the part of its rows and is summed
    over 'model' (`sum_slab_grads`); a whole-row layer's is already whole
    on every rank and is not;
  * a slab BatchNorm takes its statistics over every row of every rank of
    the mesh, data x model (its process group, set by `shard_rows`), whose
    all-reduce sums the statistics' cotangents; a whole-row BatchNorm over
    the data group;
  * a loss over a slab is a partial sum made whole by `whole_sum`, whose
    backward is the identity: each rank's cotangent of the whole loss is
    the whole one.
The BatchNorms' sums and the losses' are added in rank order
(parallel/distributed.ordered_sum): the step's numbers do not depend on
the backend's ring, and a one-process model of the ranks can add them
alike.
This is parallel/tp.py's pattern turned on its side.  Every collective is
an all_reduce (SUM): gloo runs no other on CUDA tensors, and the card's
check runs two gloo ranks on one card.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from terrain_tpu_torch.parallel.distributed import ordered_sum

MIN_ROWS = 8


class RowShard:
    """A network's place on the model group under spatial parallelism:
    this rank's `index` of `count` slabs and the model `group`.  A copy of
    a module shares it (process groups cannot be copied)."""

    __slots__ = ("index", "count", "group")

    def __init__(self, index, count, group):
        self.index, self.count, self.group = index, count, group

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return f"RowShard({self.index} of {self.count})"

    @property
    def first(self):
        return self.index == 0

    @property
    def last(self):
        return self.index == self.count - 1

    def slab(self, h):
        """Whether a tensor of whole height h is held in slabs (the
        rule)."""
        return h % self.count == 0 and h // self.count >= MIN_ROWS

    def part(self, h):
        """(index, count) of a tensor of whole height h held in slabs,
        None when it is held whole."""
        return (self.index, self.count) if self.slab(h) else None

    def take(self, x):
        """This rank's rows of a whole NHWC tensor (a plain slice: for
        data, which needs no gradient back over the group)."""
        r = x.shape[1] // self.count
        return x.narrow(1, self.index * r, r)

    def whole_shape(self, x):
        """The whole image's shape of this rank's slab x."""
        n, r, *rest = x.shape
        return (n, r * self.count, *rest)

    def halo(self, x, top, bottom):
        return halo_exchange(x, top, bottom, self)

    def same_conv(self, fn, x, k, s):
        """fn, a k x k 'same' op of stride s (1, or 2 with k = 3), on this
        rank's slab x: run on the slab with its halo, the slab's rows of
        the output kept."""
        r = x.shape[1]
        if s == 1 and k % 2 == 1:
            p = (k - 1) // 2
            top = 0 if self.first else p
            return fn(self.halo(x, p, p)).narrow(1, top, r)
        if s == 2 and k == 3 and r % 2 == 0:
            ext = self.halo(x, 1, 0)
            if self.first:
                return fn(ext)
            # a zero row above the halo row keeps the stride's phase: the
            # op's output row 0 (which reads it) is dropped
            return fn(F.pad(ext, (0, 0, 0, 0, 1, 0))).narrow(1, 1, r // 2)
        raise NotImplementedError(
            f"a {k}x{k} stride-{s} 'same' op on a slab of {r} rows")

    def upsampled(self, fn, x, halo=1):
        """fn, a 2x upsample of rows, alone or with a 'same' conv after it,
        on this rank's slab x: run on the slab with `halo` low-resolution
        rows on each side (`upsample_halo`; one for the bilinear x2 alone),
        the slab's 2r output rows kept."""
        top = 0 if self.first else halo
        return fn(self.halo(x, halo, halo)).narrow(1, 2 * top,
                                                   2 * x.shape[1])


def upsample_halo(k, taps):
    """The low-resolution rows on each side of a slab that a 2x upsample
    then a k x k 'same' conv (k odd, p = (k-1)/2) reads, with `taps` 2 for
    the bilinear x2 and 1 for the nearest.  Output row Y of the conv reads
    upsampled rows Y-p .. Y+p.  The bilinear's upsampled row 2j reads
    low-resolution rows j-1 and j, row 2j+1 rows j and j+1 (half-pixel
    centres); the nearest's both read row j.  A slab of low-resolution rows
    a .. a+r-1 keeps output rows 2a .. 2a+2r-1, so its first reads
    upsampled row 2a-p, which reads low-resolution row a - ceil((p+1)/2)
    (bilinear) or a - ceil(p/2) (nearest), and its last alike below: the
    bilinear takes ceil((p+1)/2) rows a side, 1 for k = 3 and 2 for k = 5;
    the nearest ceil(p/2), 1 for both.  On the slab with that halo the
    upsample's edge clamp (and the conv's zero padding) falls only on
    upsampled rows that no kept row reads, except at the image's edges,
    where the rank gets no halo and the clamp is the image's own."""
    p = (k - 1) // 2
    return -(-(p + taps - 1) // 2)


def _buffer(shape, like):
    """A zero buffer for a collective of `like`'s rows: fp32 for 16-bit
    types, whose sums of one value and zeros are exact either way."""
    dt = like.dtype if like.dtype in (torch.float32, torch.float64) \
        else torch.float32
    return torch.zeros(shape, dtype=dt, device=like.device)


def _all_reduce(t, rows):
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=rows.group)
    return t


class HaloExchange(torch.autograd.Function):
    """This rank's slab x (N, r, W, C) with `top` rows of the rank above
    on top and `bottom` rows of the rank below beneath; the image's edge
    ranks get no rows there.  One all-reduce of a zero buffer with a slot
    per rank, into which each rank writes its last `top` and first
    `bottom` rows.  The backward writes each halo row's cotangent into
    its owner's slot, all-reduces, and adds what lands in its own slot to
    its edge rows."""

    @staticmethod
    def forward(ctx, x, top, bottom, rows):
        n, r = x.shape[0], x.shape[1]
        if top > r or bottom > r:
            raise ValueError(f"a halo of {top}/{bottom} rows over slabs of "
                             f"{r}")
        ctx.rows, ctx.top, ctx.bottom = rows, top, bottom
        ctx.got = (0 if rows.first else top, 0 if rows.last else bottom)
        if top + bottom == 0:
            return x.view_as(x)
        i = rows.index
        buf = _buffer((rows.count, n, top + bottom) + tuple(x.shape[2:]), x)
        buf[i, :, :top] = x[:, r - top:]
        buf[i, :, top:] = x[:, :bottom]
        _all_reduce(buf, rows)
        parts = [x]
        if ctx.got[0]:
            parts.insert(0, buf[i - 1, :, :top].to(x.dtype))
        if ctx.got[1]:
            parts.append(buf[i + 1, :, top:].to(x.dtype))
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        rows, top, bottom = ctx.rows, ctx.top, ctx.bottom
        t, b = ctx.got
        r = g.shape[1] - t - b
        dx = g.narrow(1, t, r).clone(memory_format=torch.contiguous_format)
        if top + bottom == 0:
            return dx, None, None, None
        i = rows.index
        buf = _buffer((rows.count, g.shape[0], top + bottom)
                      + tuple(g.shape[2:]), g)
        if t:
            buf[i - 1, :, :top] = g[:, :top]
        if b:
            buf[i + 1, :, top:] = g[:, t + r:]
        _all_reduce(buf, rows)
        if top:
            dx[:, r - top:] += buf[i, :, :top].to(dx.dtype)
        if bottom:
            dx[:, :bottom] += buf[i, :, top:].to(dx.dtype)
        return dx, None, None, None


class GatherRows(torch.autograd.Function):
    """The whole tensor from every rank's slab: one all-reduce of a zero
    buffer holding this rank's rows; the backward keeps this rank's rows
    of the (whole, same on every rank) cotangent."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        r = x.shape[1]
        buf = _buffer(rows.whole_shape(x), x)
        buf[:, rows.index * r:(rows.index + 1) * r] = x
        return _all_reduce(buf, rows).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.rows.take(g).contiguous(), None


class ScatterRows(torch.autograd.Function):
    """This rank's slab of a whole tensor; the backward sums the ranks'
    slab cotangents, each in its rows, over the model group."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return rows.take(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        rows = ctx.rows
        r = g.shape[1]
        buf = _buffer(rows.whole_shape(g), g)
        buf[:, rows.index * r:(rows.index + 1) * r] = g
        return _all_reduce(buf, rows).to(g.dtype), None


class WholeSum(torch.autograd.Function):
    """The sum over the model group of a partial value (a slab's part of
    a loss), added in rank order (`ordered_sum`); the backward is
    the identity."""

    @staticmethod
    def forward(ctx, t, rows):
        return ordered_sum(t.detach(), rows.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def halo_exchange(x, top, bottom, rows):
    return HaloExchange.apply(x, top, bottom, rows)


def gather_rows(x, rows):
    return GatherRows.apply(x, rows)


def scatter_rows(x, rows):
    return ScatterRows.apply(x, rows)


def whole_sum(t, rows):
    return WholeSum.apply(t, rows)


def mean(t, rows):
    """The mean of every element of a tensor held in slabs (t), in fp32,
    over the whole image: the model group's partial sums added."""
    return whole_sum(t.float().sum(), rows) / (t.numel() * rows.count)


def call(op, x, w, b, rows, io_rows, **kw):
    """op(x, w, b, **kw) of a layer whose input and output have the whole
    heights `io_rows` = (h_in, h_out): on the slab (`on_slab`) when both
    are held in slabs, else on whole rows, the input gathered before and
    the output scattered after as the rule has them."""
    slab_in, slab_out = rows.slab(io_rows[0]), rows.slab(io_rows[1])
    if slab_in and slab_out:
        return on_slab(op, x, w, b, rows, io_rows, **kw)
    if slab_in:
        x = gather_rows(x, rows)
    y = op(x, w, b, **kw)
    return scatter_rows(y, rows) if slab_out else y


def on_slab(op, x, w, b, rows, io_rows, **kw):
    """op(x, w, b, **kw) of a layer of whole heights `io_rows` on this
    rank's slab x, by the route of the whole image (`route_shape`).  The
    heights and the kernel's size name the halo: a k2 s2 deconv (h_out =
    2 h_in, k = 2) needs none, a 2x upsample then k x k conv (h_out = 2
    h_in) the rows `upsample_halo` counts from k and the op's
    `upsample_taps` on each side (`RowShard.upsampled`), a 'same' conv of
    stride h_in / h_out its k's (`RowShard.same_conv`)."""
    (h_in, h_out), k = io_rows, w.shape[2]
    if h_out == 2 * h_in and k == 2:
        return op(x, w, b, **kw)
    if kw.get("padding", "same") != "same":
        raise ValueError(f"a conv on a slab of rows takes 'same' padding, "
                         f"not {kw['padding']!r}")
    whole = rows.whole_shape(x)

    def fn(ext):
        return op(ext, w, b, route_shape=whole, **kw)

    if h_out == 2 * h_in:
        return rows.upsampled(fn, x, upsample_halo(k, op.upsample_taps))
    return rows.same_conv(fn, x, k, h_in // h_out)


def pool(fn, x, rows, h, size):
    """fn(x, size), a size x size pool of stride size (VALID), of x whose
    whole height is h, under the rule: on whole rows when x is held whole;
    on the slab when each slab holds whole windows (its rows a multiple of
    size), the whole image's shape routing it (`route_shape`), and the
    pooled rows gathered when the rule holds them whole; else (a window
    across slabs, as the discriminator's last pool over the whole extent)
    on the gathered rows.  Pooling has no weights and no halo."""
    if rows is None or not rows.slab(h):
        return fn(x, size)
    if x.shape[1] % size:
        return fn(gather_rows(x, rows), size)
    y = fn(x, size, route_shape=rows.whole_shape(x))
    return y if rows.slab(h // size) else gather_rows(y, rows)


def on_slabs(module):
    """Whether a layer (or BatchNorm) with a row shard runs on slabs."""
    rows = getattr(module, "rows", None)
    io = getattr(module, "io_rows", None)
    return rows is not None and io is not None and rows.slab(min(io))


def slab_parameters(net):
    """Flags in net.parameters() order: True for the parameters of the
    layers that run on slabs, whose gradients are partial."""
    mine = {id(p) for m in net.modules() if on_slabs(m)
            for p in m.parameters(recurse=False)}
    return [id(p) in mine for p in net.parameters()]


def sum_slab_grads(net, grads):
    """`grads` (in net.parameters() order) with those of the slab layers
    summed over the model group: one all-reduce of one flat buffer."""
    rows = net.rows
    flags = slab_parameters(net)
    part = [g for g, f in zip(grads, flags) if f]
    if not part:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in part])
    _all_reduce(flat, rows)
    it = iter(flat.split([g.numel() for g in part]))
    return [next(it).view_as(g) if f else g for g, f in zip(grads, flags)]


def shard_rows(module, mesh):
    """Hold `module`'s images in slabs of rows over the mesh's model group
    (the counterpart of parallel/tp.shard_module): every layer and
    BatchNorm of it carries the row shard and decides by its heights.  A
    BatchNorm (a module with a `process_group`) on slabs takes the group
    of the whole mesh, one on whole rows the mesh's data group.  The
    caller feeds it slabs (`RowShard.take` or parallel.place with
    spatial_batch_sharding).  Returns the names of the modules that run
    on slabs.  The networks of models/unet.py and models/dcgan.py carry
    row heights (`rows`): another raises.  A network's input must be held
    in slabs (`in_shp` rows), the DCGAN generator's output (`out_rows`:
    its input is a vector)."""
    if not hasattr(module, "rows"):
        raise NotImplementedError(
            f"{type(module).__name__} under row sharding is not ported: "
            f"only the U-Net, PatchGAN and the DCGAN generator and "
            f"discriminator carry row heights")
    if mesh.shape["model"] == 1:
        return []
    if mesh.model_group is None:
        raise ValueError("a mesh with n_model > 1 needs a process group: "
                         "call parallel.initialize() before make_mesh()")
    rows = RowShard(mesh.model_index, mesh.shape["model"], mesh.model_group)
    h = getattr(module, "in_shp", None) or module.out_rows
    if not rows.slab(h):
        raise ValueError(f"{h} rows over {rows.count} model ranks are no "
                         f"slabs of {MIN_ROWS} or more")
    data = mesh.data_group if mesh.shape["data"] > 1 else None
    module.rows = rows
    for m in module.modules():
        if getattr(m, "io_rows", None) is None:
            continue
        m.rows = rows
        if hasattr(m, "process_group"):
            m.process_group = mesh.group if on_slabs(m) else data
    return [n for n, m in module.named_modules() if on_slabs(m)]

"""The ('data', 'model') grid of ranks and its sharding helpers
(terrain_tpu/parallel/mesh.py), on `torch.distributed`.

JAX's mesh is an array of devices that one program is compiled over; here
it is an array of ranks, one process and one device each, with one process
group per data column and per model row.  The single-process path is the
1x1 mesh of the same code.

  * 'data' -- batch dimension (DP): each rank holds global_batch / n_data
    rows; BatchNorm's batch statistics are all-reduced over the data group
    (ops/norm.py), so they are global-batch statistics, as JAX's mean over
    a sharded axis is a psum; the gradients and the losses are all-reduced
    as means (train/step.py).
  * 'model' -- channel dimension (TP): the wide weights `tp_shardings`
    selects (JAX's rule) are split on their output features over the model
    group, one contiguous slice a rank; `place` keeps this rank's slice and
    `gather` puts the whole tensor back; parallel/tp.py holds the
    collectives around a sharded layer.  Image rows over 'model' (spatial
    parallelism, `spatial_batch_sharding`): `place` keeps this rank's rows
    of its data block's images and `gather` puts whole images back;
    parallel/spatial.py holds the halo exchanges and the layout rule of a
    network whose images are held in slabs (`spatial.shard_rows`), and
    the group of the whole mesh (`Mesh.group`) takes a slab BatchNorm's
    statistics.

Every collective is an all_reduce or a broadcast: gloo supports only
those two on CUDA tensors, and the card's check runs two gloo ranks on one
card (NCCL refuses two ranks on one device).
"""

import numpy as np
import torch
import torch.distributed as dist

from terrain_tpu_torch.parallel.tp import Shard, gather_axis, slice_axis

AXES = ("data", "model")


class Mesh:
    """`ranks`: (n_data, n_model) array of global ranks.  `data_group` is
    the process group of this rank's data column (the ranks that share its
    model index), `model_group` that of its model row (made only when
    n_model > 1), `group` that of the whole mesh; all None without a
    process group (a mesh laid out for inspection only) or outside the
    mesh.  `data_index` is this rank's
    row, the slice of each global batch it holds; `model_index` its
    column, the slice of each sharded weight it holds."""

    def __init__(self, ranks, data_group=None, model_group=None,
                 data_index=0, model_index=0, group=None):
        self.ranks = ranks
        self.shape = dict(zip(AXES, ranks.shape))
        self.data_group = data_group
        self.model_group = model_group
        self.group = group
        self.data_index = data_index
        self.model_index = model_index

    @property
    def data_root(self):
        """The global rank that broadcasts to this rank's data group."""
        return int(self.ranks[0, self.model_index])

    @property
    def model_root(self):
        """The global rank that broadcasts to this rank's model group."""
        return int(self.ranks[self.data_index, 0])

    def __repr__(self):
        return f"Mesh({self.shape})"


def _group(members):
    """A process group of `members`, made by every rank (new_group is a
    collective call); the world's own group when they are all of it."""
    if list(members) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group([int(r) for r in members])


def make_mesh(n_data=None, n_model=1, ranks=None):
    """Build a ('data', 'model') mesh over `ranks` (default: every rank of
    the process group, or the one process).  Defaults to all ranks on
    'data'.  Every rank must call it, in the same order, with the same
    arguments: it makes the groups."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    use = n_data * n_model
    if use > len(ranks) or use < 1:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {use} ranks, "
                         f"got {len(ranks)}")
    arr = np.array(ranks[:use]).reshape(n_data, n_model)
    if not dist.is_initialized():
        return Mesh(arr)
    me = dist.get_rank()
    data_group = model_group = None
    data_index = model_index = 0
    for j in range(n_model):
        g = _group(arr[:, j])
        if me in arr[:, j]:
            data_group = g
            data_index = int(np.argwhere(arr[:, j] == me)[0][0])
            model_index = j
    for i in range(n_data if n_model > 1 else 0):
        g = _group(arr[i, :])
        if me in arr[i, :]:
            model_group = g
    group = _group(arr.reshape(-1))
    return Mesh(arr, data_group, model_group, data_index, model_index,
                group if me in arr else None)


class Sharding:
    """What JAX's NamedSharding names: a mesh and, per tensor axis, the
    mesh axis it is split over (None: replicated), as a tuple."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"Sharding({self.mesh!r}, {self.spec})"


def batch_sharding(mesh):
    """Shard the leading (batch) dimension over 'data'."""
    return Sharding(mesh, ("data",))


def spatial_batch_sharding(mesh):
    """Shard batch over 'data' and image rows (H) over 'model', spatial
    parallelism (parallel/spatial.py)."""
    return Sharding(mesh, ("data", "model"))


def replicated(mesh):
    return Sharding(mesh, ())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tp_shardings(params, mesh, min_features=256):
    """Per-leaf Shardings: shard wide weights' output features over
    'model', everything else replicated (terrain_tpu's rule,
    mesh.py:56-72): a 4-D or 2-D leaf whose output features, its last
    axis, number at least `min_features` and divide by n_model.  The
    leaves are in terrain_tpu's layout (HWIO convs, (in, out) dense
    layers), the trees models/convert.py gives."""
    n_model = mesh.shape["model"]

    def spec(leaf):
        nd = getattr(leaf, "ndim", None)
        if n_model > 1 and nd in (2, 4):
            f = leaf.shape[-1]
            if f >= min_features and f % n_model == 0:
                return Sharding(mesh, (None,) * (nd - 1) + ("model",))
        return replicated(mesh)

    return _tree_map(spec, params)


def _broadcast(tensors, group, src):
    """Broadcast `tensors` in place from global rank `src` over `group`,
    one broadcast per dtype: each dtype's tensors are flattened into one
    buffer."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        with torch.no_grad():
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def _split_axes(sharding):
    """[(tensor axis, mesh axis)] of the axes a Sharding splits."""
    return [(a, name) for a, name in enumerate(sharding.spec)
            if name is not None]


def _shard(mesh, axis="model"):
    """This rank's place on a mesh axis, as a tp.Shard of its group."""
    if axis == "data":
        return Shard(mesh.data_index, mesh.shape["data"], mesh.data_group)
    return Shard(mesh.model_index, mesh.shape["model"], mesh.model_group)


def place(tree, shardings_or_mesh):
    """Make every tensor of `tree` what its data group's first rank holds
    (the counterpart of device_put): one broadcast over the data group per
    dtype, in place.  With a Mesh every tensor is replicated (and a slice
    a rank already holds stays its slice: a data group shares one model
    index).  With shardings (a tree like `tree` of Shardings), the tensors
    are the full ones: each is broadcast over the model group from its
    first rank as well, and each axis a Sharding splits is replaced by
    this rank's contiguous slice of it: output features over 'model'
    (tp_shardings), or a batch of images under spatial_batch_sharding,
    this rank's data block of the batch and its rows model_index * H /
    n_model .. of each image.  Returns the tree.  Without a process group
    nothing is broadcast."""
    if isinstance(shardings_or_mesh, Mesh):
        mesh, splits = shardings_or_mesh, None
    else:
        shards = _leaves(shardings_or_mesh)
        splits = [_split_axes(s) for s in shards]
        mesh = shards[0].mesh if shards else None
    tensors = [t for t in _leaves(tree) if torch.is_tensor(t)]
    if mesh is None or not tensors:
        return tree
    if mesh.data_group is not None:
        _broadcast(tensors, mesh.data_group, mesh.data_root)
    if splits is None:
        return tree
    if mesh.model_group is not None:
        _broadcast(tensors, mesh.model_group, mesh.model_root)
    it = iter(splits)

    def keep(t):
        for a, name in next(it):
            t = slice_axis(t, a, _shard(mesh, name))
        return t.contiguous()

    return _tree_map(keep, tree)


def gather(tree, shardings):
    """The inverse of `place` with shardings: each split axis gathered
    whole over its group (a collective: every rank of the group calls
    it), the other tensors as they are."""
    shards = _leaves(shardings)
    if not shards:
        return tree
    it = iter([_split_axes(s) for s in shards])
    mesh = shards[0].mesh

    def whole(t):
        for a, name in next(it):
            if mesh.shape[name] == 1:
                continue
            shard = _shard(mesh, name)
            if shard.group is None:
                raise ValueError(f"gathering over {name!r} needs the mesh's "
                                 f"process group")
            t = gather_axis(t, a, shard)
        return t

    return _tree_map(whole, tree)

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
  * 'model' -- channel or row dimension (TP, spatial): not ported yet
    (ROADMAP A.5b).  `tp_shardings` keeps JAX's selection rule; placing a
    tensor sharded on 'model' raises.

Every collective is an all_reduce or a broadcast: gloo supports only
those two on CUDA tensors, and the card's check runs two gloo ranks on one
card (NCCL refuses two ranks on one device).
"""

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
A5B = ("is not ported yet: tensor and spatial parallelism on 'model' are "
       "ROADMAP A.5b")


class Mesh:
    """`ranks`: (n_data, n_model) array of global ranks.  `data_group` is
    the process group of this rank's data column (the ranks that share its
    model index), `model_group` that of its model row (made only when
    n_model > 1); both None without a process group (a mesh laid out for
    inspection only) or outside the mesh.  `data_index` is this rank's
    row, the slice of each global batch it holds."""

    def __init__(self, ranks, data_group=None, model_group=None,
                 data_index=0):
        self.ranks = ranks
        self.shape = dict(zip(AXES, ranks.shape))
        self.data_group = data_group
        self.model_group = model_group
        self.data_index = data_index

    @property
    def data_root(self):
        """The global rank that broadcasts to this rank's data group."""
        col = int(np.argwhere(self.ranks == dist.get_rank())[0][1])
        return int(self.ranks[0, col])

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
    data_index = 0
    for j in range(n_model):
        g = _group(arr[:, j])
        if me in arr[:, j]:
            data_group = g
            data_index = int(np.argwhere(arr[:, j] == me)[0][0])
    for i in range(n_data if n_model > 1 else 0):
        g = _group(arr[i, :])
        if me in arr[i, :]:
            model_group = g
    return Mesh(arr, data_group, model_group, data_index)


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
    parallelism; `place` refuses it (ROADMAP A.5b)."""
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


def place(tree, shardings_or_mesh):
    """Make every tensor of `tree` what the data group's first rank holds:
    one broadcast over the data group per dtype, in place (the counterpart
    of device_put onto replicated shardings).  Shardings that split a
    tensor over 'model' raise (ROADMAP A.5b).  Without a process group,
    the tree is returned as it is."""
    if isinstance(shardings_or_mesh, Mesh):
        mesh = shardings_or_mesh
    else:
        shards = _leaves(shardings_or_mesh)
        if any("model" in s.spec for s in shards):
            raise NotImplementedError(f"placing a tensor sharded on 'model' "
                                      f"{A5B}")
        mesh = shards[0].mesh if shards else None
    tensors = [t for t in _leaves(tree) if torch.is_tensor(t)]
    if mesh is not None and mesh.data_group is not None and tensors:
        _broadcast(tensors, mesh.data_group, mesh.data_root)
    return tree

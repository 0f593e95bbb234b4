"""Process-group initialization and per-process data sharding
(terrain_tpu/parallel/distributed.py), on `torch.distributed`.

JAX runs one process per host driving all of its devices; PyTorch's idiom
is one process per device, so a rank here is one card (or, on the CPU, one
gloo process).  `initialize()` with no arguments reads the environment
`torchrun` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
elsewhere pass the coordinator's address, the world size and the rank.
After init, `parallel.make_mesh()` lays the ranks out on ('data', 'model').
Per-process data loading:

  * wrap each host iterator in `HostShardIterator`: every process yields
    its own disjoint slice of each global batch (experiments.py does this
    when the world has more than one process);
  * the trainer feeds each rank's slice to its step; the step all-reduces
    the BN statistics, the gradients and the losses over 'data'.
"""

import datetime
import gc
import os

import torch
import torch.distributed as dist

from terrain_tpu_torch.device import platform_device

# torchrun's environment; initialize() with no arguments needs all of it
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# a spawned rank's wait in one collective before it fails (`run_rank`): a
# rank whose peer died stops, where torch.distributed's default would hold
# it for 30 minutes
COLLECTIVE_TIMEOUT_S = 300


def process_index():
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


# the keyword arguments below shadow the two names
_index, _count = process_index, process_count


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, timeout=None):
    """Idempotent process-group init; returns (rank, world size).

    The backend is NCCL when the process's device (`device`, else
    TERRAIN_PLATFORM's: the card unless it says cpu) is a CUDA device, gloo
    on the CPU; `backend` overrides it.  With explicit arguments every
    failure propagates: a misconfigured coordinator must not silently
    degrade to one process.  `coordinator_address` is "host:port" (TCP) or
    an init-method URL ("tcp://...", "file://...").  With no arguments the
    torchrun environment is read; only when none of it is set does the
    process go on alone, and a partial environment or a failed
    initialization raises.  `timeout` (a timedelta) bounds each
    collective's wait, torch.distributed's default otherwise."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device(device or platform_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if None in explicit:
            raise ValueError(
                "initialize: pass coordinator_address, num_processes and "
                "process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
        local = rank
    else:
        if not any(k in os.environ for k in _TORCHRUN_ENV):
            return 0, 1  # no cluster environment: one process
        url, rank, world = "env://", None, None
        local = int(os.environ.get("LOCAL_RANK", "0"))
    if backend == "nccl":
        # one card per rank: torchrun's LOCAL_RANK, else the rank
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if rank is None else {"rank": rank, "world_size": world}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, init_method=url, **kw)
    return dist.get_rank(), dist.get_world_size()


def finish(barrier=True):
    """This process's end of its process group.  Every Python object that
    still holds one of the groups is collected first, the ranks meet at a
    barrier (`barrier`: leave it out when this rank failed, since its peers
    may wait in another collective), the groups are destroyed, and
    collected again: no gloo worker thread outlives its group into the
    interpreter's exit, where C++ objects are torn down in no set order.
    A spawned rank calls it last, after the function that did its work has
    returned, so that function's locals are gone."""
    gc.collect()
    if dist.is_initialized():
        if barrier:
            nccl = dist.get_backend() == "nccl"
            dist.barrier(device_ids=[torch.cuda.current_device()] if nccl
                         else None)
        dist.destroy_process_group()
    gc.collect()


def run_rank(init_method, world, rank, work, *args, backend="gloo"):
    """A spawned rank's life: join the process group (`init_method`, an
    init URL such as "file://..." or "tcp://localhost:<port>", each
    collective's wait bounded by COLLECTIVE_TIMEOUT_S), run work(*args),
    and end the group with `finish` once work has returned, so its locals
    (which hold the groups) are gone; a rank whose work raised skips the
    barrier and raises."""
    initialize(init_method, world, rank, backend=backend,
               timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        work(*args)
    except BaseException:
        finish(barrier=False)
        raise
    finish()


def ordered_sum(x, group):
    """The sum of x over the ranks of `group`, added in the group's rank
    order: one all-reduce of a zero buffer with a slot a rank (each
    element of it one value and zeros, exact in any order), then the
    slots added left to right.  The same bits under any backend and ring,
    and the order a one-process model of the ranks adds them in."""
    buf = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = buf[0]
    for part in buf[1:]:
        out = out + part
    return out


def host_batch_slice(global_batch, *, process_index=None, process_count=None):
    """The slice of a global batch this process should load."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    per_host = global_batch // pc
    return slice(pi * per_host, (pi + 1) * per_host)


class HostShardIterator:
    """Per-process view of a global-batch host iterator.

    Wraps an iterator of array tuples (e.g. Hdf5Iterator's (X, Y) batches)
    and yields only this process's `host_batch_slice` of every batch, so
    each process reads a disjoint shard of the global batch.  Requires all
    processes to construct identically-seeded iterators so the global batch
    order agrees everywhere (Hdf5Iterator's slice-shuffle uses a fixed
    RandomState(0), so this holds by construction).

    Exposes the wrapped iterator's `.N` (global dataset size): step counts
    derived from it stay consistent across processes.
    """

    def __init__(self, it, *, process_index=None, process_count=None):
        self._it = it
        self._pi = _index() if process_index is None else process_index
        self._pc = _count() if process_count is None else process_count
        N = getattr(it, "N", None)
        if N is not None:
            self.N = N

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        return tuple(
            x[host_batch_slice(x.shape[0], process_index=self._pi,
                               process_count=self._pc)]
            for x in item)

    next = __next__

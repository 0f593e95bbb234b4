"""Spawned gloo ranks for the port's multi-process tests (torch only).

A module spawns its ranks once (`spawn`); each rank joins through a
file:// rendezvous (`run_rank`), does its work, and saves what it found
phase by phase (`save`), so a rank that fails leaves the phases it
finished: the tests of those pass or fail on their own readings, the
tests of the rest fail naming the spawn's failure (`load`), and each
module's `test_every_rank_ran_to_its_end` fails.  A rank runs through
parallel.distributed.run_rank, which ends its process group with
`finish` once its work function has returned, so no group (and no gloo
thread) outlives it into the interpreter's exit.
"""

import os
import pickle

import torch

def spawn(fn, world, out_dir):
    """fn(rank, world, rendezvous, out_dir) in `world` spawned processes;
    returns the failure (None when every rank ran to its end)."""
    try:
        torch.multiprocessing.spawn(
            fn, args=(world, os.path.join(out_dir, "rendezvous"), out_dir),
            nprocs=world, join=True)
    except Exception as e:  # the phases the ranks finished stand
        return e
    return None


def save(out_dir, phase, rank, value):
    with open(os.path.join(out_dir, f"{phase}.{rank}.pkl"), "wb") as f:
        pickle.dump(value, f)


def load(out_dir, phase, ranks, failure):
    """Each rank's saved `phase`, in rank order; a test that reads a phase
    some rank did not finish fails, naming the spawn's failure."""
    import pytest

    res = []
    for r in ranks:
        path = os.path.join(out_dir, f"{phase}.{r}.pkl")
        if not os.path.exists(path):
            pytest.fail(f"rank {r} left no {phase!r} results: {failure!r}")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    return res


def run_rank(rank, world, rendezvous, work, *args):
    """Join the process group, run work(*args), end the group
    (parallel.distributed.run_rank)."""
    from terrain_tpu_torch.parallel.distributed import run_rank

    torch.set_num_threads(1)
    run_rank(f"file://{rendezvous}", world, rank, work, *args)


class Results:
    """The ranks' saved phases, read when a test asks: results[r][phase]
    is rank r's `phase` (`load`'s failure when it left none)."""

    def __init__(self, out_dir, world, failure):
        self.out_dir, self.world, self.failure = out_dir, world, failure

    def __getitem__(self, rank):
        if not 0 <= rank < self.world:
            raise IndexError(rank)
        return _Rank(self, rank)

    def __iter__(self):
        return (_Rank(self, r) for r in range(self.world))

    def __len__(self):
        return self.world


class _Rank:
    def __init__(self, results, rank):
        self.results, self.rank = results, rank

    def __getitem__(self, phase):
        r = self.results
        return load(r.out_dir, phase, [self.rank], r.failure)[0]

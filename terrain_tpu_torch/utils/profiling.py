"""Tracing and step timing (terrain_tpu/utils/profiling.py).

  * `trace(dir, device)` -- a context manager around torch.profiler: CPU
    activities, plus the card's kernels when `device` is a CUDA device,
    with each op's input shapes; writes a Chrome trace (chrome://tracing,
    Perfetto) into `dir` when the block ends.  The trainer traces its
    second epoch under TERRAIN_PROFILE=<dir>;
    `python -m terrain_tpu_torch.tools.summarize_trace <trace>` ranks it.
  * `StepTimer` -- host-side steps per second with a device fence.
"""

import contextlib
import json
import os
import time

import torch


def _is_cuda(device):
    return device is not None and torch.device(device).type == "cuda"


LAUNCHES_KEY = "terrain_launches"
# callables that return {name: count}; trace() writes each count's
# increase over its block under LAUNCHES_KEY (ops/kernels registers its
# kernels' CudaKernel.launches)
_COUNTERS = []


def count_in_traces(read):
    """Registers `read`, a callable that returns {name: count}: each
    trace() writes the counts' increase over its block under
    LAUNCHES_KEY."""
    _COUNTERS.append(read)


def _counts():
    out = {}
    for read in _COUNTERS:
        out.update(read())
    return out


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Profile the enclosed block; yields the profiler.  The trace is
    `<log_dir>/trace_<pid>_<ns>.json`, written also when the block
    raises.  Its `cpu_op` events carry `Input Dims`, `Input type` and
    `Concrete Inputs` (record_shapes); each hand-written kernel launch sits
    in a `terrain::<name>(<shape>)` annotation (CudaKernel.launch); and
    the top-level key `terrain_launches` holds, as a JSON object, the
    increase over the block of each count registered by `count_in_traces`
    (each kernel's `CudaKernel.launches` once ops/kernels is imported)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if _is_cuda(device):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = _counts()
    prof = profile(activities=acts, record_shapes=True)
    try:
        with prof:
            try:
                yield prof
            finally:
                if _is_cuda(device):  # the block's kernels end inside it
                    torch.cuda.synchronize(device)
                prof.add_metadata_json(LAUNCHES_KEY, json.dumps(
                    {n: v - before[n] for n, v in _counts().items()}))
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock steps per second, fenced on the device."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n=1):
        self.steps += n

    def stop(self, fence=None):
        """Steps per second since `start`.  `fence` (a tensor or a device):
        its CUDA device is synchronized first, so queued work counts."""
        if fence is not None:
            dev = fence.device if isinstance(fence, torch.Tensor) else fence
            if _is_cuda(dev):
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")

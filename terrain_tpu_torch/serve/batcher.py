"""Micro-batcher: coalesce concurrent sampling requests into one device batch.

A copy of terrain_tpu/serve/batcher.py (the port imports nothing of the JAX
package), unchanged in behaviour:

* **Buckets.**  Items are coalesced, then the executor pads to a power-of-
  two *bucket* size up to ``max_batch``, so the device sees a handful of
  fixed batch shapes (the CUDA kernels and cuDNN's algorithm choices are
  then warm after `TerrainServer.warmup`).
* **One queue per op.**  Different ops (z->pair vs heightmap->texture) run
  different networks; within an op, requests from any number of
  connections merge into one forward.
* **Latency knob.**  The worker waits at most ``wait_ms`` after the first
  queued item for stragglers; 0 disables coalescing beyond what is already
  queued.

The executor callable owns the device work; the batcher is host-side
threading only.
"""

import queue
import threading
import time
from concurrent.futures import Future


def bucket_size(n, max_batch):
    """Smallest power-of-two >= n, capped at max_batch (n <= max_batch)."""
    if n > max_batch:
        raise ValueError(f"batch {n} exceeds max_batch {max_batch}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Item:
    __slots__ = ("request", "n", "future")

    def __init__(self, request, n):
        self.request = request
        self.n = n  # number of batch rows this request contributes
        self.future = Future()


class MicroBatcher:
    """Routes requests to per-op worker threads that execute coalesced
    batches via ``run_batch(op, [requests]) -> [results]``.

    ``submit(op, request, n)`` returns a Future; ``n`` is the request's
    batch-row count so the worker can respect ``max_batch`` when packing.
    """

    def __init__(self, run_batch, *, max_batch=8, wait_ms=2.0):
        self.run_batch = run_batch
        self.max_batch = int(max_batch)
        self.wait_ms = float(wait_ms)
        self._queues = {}
        self._workers = {}
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()  # per-op workers share counters
        self._stop = threading.Event()
        self.stats = {"batches": 0, "requests": 0, "rows": 0}

    def snapshot(self):
        """Consistent copy of the counters (per-op workers mutate them)."""
        with self._stats_lock:
            return dict(self.stats)

    def submit(self, op, request, n=1):
        if n > self.max_batch:
            raise ValueError(
                f"request of {n} rows exceeds max_batch={self.max_batch}; "
                "split it client-side (the client helper does this)")
        item = _Item(request, n)
        q = self._queue_for(op)
        q.put(item)
        return item.future

    def _queue_for(self, op):
        with self._lock:
            q = self._queues.get(op)
            if q is None:
                q = self._queues[op] = queue.Queue()
                t = threading.Thread(
                    target=self._worker, args=(op, q),
                    name=f"batcher-{op}", daemon=True)
                self._workers[op] = t
                t.start()
            return q

    def _collect(self, q):
        """Block for one item, then coalesce stragglers for up to wait_ms
        without exceeding max_batch rows."""
        try:
            first = q.get(timeout=0.1)
        except queue.Empty:
            return []
        items, rows = [first], first.n
        deadline = time.monotonic() + self.wait_ms / 1000.0
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = q.get(timeout=timeout)
            except queue.Empty:
                break
            if rows + nxt.n > self.max_batch:
                # would overflow the bucket: run what we have, requeue
                q.put(nxt)
                break
            items.append(nxt)
            rows += nxt.n
        return items

    def _worker(self, op, q):
        while not self._stop.is_set():
            items = self._collect(q)
            if not items:
                continue
            try:
                results = self.run_batch(op, [it.request for it in items])
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(items)} requests")
            except Exception as e:  # noqa: BLE001 — fault isolation per batch
                for it in items:
                    it.future.set_exception(e)
                continue
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["requests"] += len(items)
                self.stats["rows"] += sum(it.n for it in items)
            for it, res in zip(items, results):
                it.future.set_result(res)

    def shutdown(self):
        """Stop the workers and fail any queued-but-unexecuted requests, so
        no client blocks forever in future.result()."""
        self._stop.set()
        with self._lock:
            queues = list(self._queues.values())
            workers = list(self._workers.values())
        for t in workers:  # workers poll the stop event every <=100 ms
            t.join(timeout=2.0)
        err = RuntimeError("server shutting down")
        for q in queues:
            try:
                while True:
                    item = q.get_nowait()
                    if not item.future.done():
                        item.future.set_exception(err)
            except queue.Empty:
                pass

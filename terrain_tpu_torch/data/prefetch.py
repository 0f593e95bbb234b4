"""Background host-to-device prefetch for host-side iterators
(terrain_tpu/data/prefetch.py).

A worker thread reads the next batches of a host iterator (h5 slices,
normalization) while the card computes, and copies them to the device: on
the card from pinned memory, non-blocking, on a side stream, with an event
that the consumer's stream waits on before it uses the batch, and
`record_stream` so the allocator does not reuse the batch's memory while
the consumer's stream may still read it.  For a CPU device it only turns
the arrays into tensors.  The device-resident dataset (device_cache.py)
needs none of this; the trainer wraps every host iterator in a Prefetcher
unless TERRAIN_PREFETCH=0.
"""

import queue
import threading

import torch


class Prefetcher:
    """Wraps an iterator of host array tuples; yields tuples of tensors on
    `device`.

    * Finite iterators end cleanly: exhaustion enqueues a sentinel and
      `__next__` raises StopIteration (again on every later call).
    * An exception in the wrapped iterator is raised on the consumer's side.
    * `close()` ends the worker even when it is blocked on a full queue
      (its puts poll the stop event), and joins it.

    Exposes the wrapped iterator's `.N` (dataset length) when present, so it
    stands in for an Hdf5Iterator in the trainer.
    """

    def __init__(self, it, size=2, device="cuda"):
        self._it = it
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        N = getattr(it, "N", None)
        if N is not None:
            self.N = N
        self._q = queue.Queue(maxsize=size)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item):
        """Bounded put that observes close(); returns False if closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, item):
        """(tensors on the device, the copy's event or None)."""
        if self._stream is None:
            return tuple(torch.as_tensor(x) for x in item), None
        with torch.cuda.stream(self._stream):
            out = tuple(torch.as_tensor(x).pin_memory().to(
                self._device, non_blocking=True) for x in item)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if not self._put(self._to_device(item)):
                    return
            self._put(None)  # clean exhaustion -> StopIteration downstream
        except Exception as e:  # raised again on the consumer's side
            self._err = e
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._q.put(None)  # keep raising on further next() calls
            if self._err is not None:
                raise self._err
            raise StopIteration
        tensors, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    next = __next__

    def close(self):
        self._stop.set()
        # drain, so that a worker blocked on a put sees the stop event
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

"""Asynchronous artifact writer (terrain_tpu/utils/async_writer.py).

The train loop dumps a few dozen PNGs and a grid per epoch.  Encoding and
file IO run on a worker thread so the card keeps stepping; `close()` waits
for the queued jobs before a checkpoint or exit, ends the thread and
re-raises the first failure of a job.
"""

import queue
import threading


class AsyncWriter:
    def __init__(self, maxsize=256):
        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 -- surfaced on close
                if self._err is None:
                    self._err = e

    def submit(self, fn, *args, **kwargs):
        self._q.put((fn, args, kwargs))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err

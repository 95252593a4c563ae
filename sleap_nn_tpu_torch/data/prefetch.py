"""Bounded background-thread prefetch for host-side data generators.

Port of ``sleap_nn_tpu/data/prefetch.py``: host decode / collate of the
next batch overlaps device work on the current one.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Optional


class PrefetchIterator:
    """Wrap a generator with a bounded background-thread prefetch queue.

    Abandonment-safe: the worker's puts poll a stop flag, raised by
    :meth:`close`, garbage collection of the iterator or generator
    exhaustion, so no thread or buffered batch outlives its consumer.
    """

    def __init__(self, gen, prefetch: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        # The worker closure holds no reference to self, so the GC
        # finalizer below can fire while the thread runs.
        self._err_cell: list = []
        self._stop = threading.Event()
        stop, q, done, err_cell = self._stop, self.q, self._done, self._err_cell

        def put(item) -> bool:
            """Bounded put that gives up when the consumer went away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in gen:
                    if not put(item):
                        return  # abandoned: drop everything, exit
            except BaseException as e:  # re-raised in the consumer
                err_cell.append(e)
            finally:
                put(done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()
        self._finalizer = weakref.finalize(self, stop.set)

    @property
    def _err(self) -> Optional[BaseException]:
        return self._err_cell[0] if self._err_cell else None

    def close(self):
        """Release the worker thread (safe to call multiple times)."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self.q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

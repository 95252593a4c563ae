"""Bounded background-thread prefetch for host-side data generators.

Port of ``sleap_nn_tpu/data/prefetch.py``: host decode / collate of the
next batch overlaps device work on the current one.
"""

from __future__ import annotations

import itertools
import queue
import threading
import weakref
from typing import Optional

from sleap_nn_tpu_torch import profiling


class PrefetchIterator:
    """Wrap a generator with a bounded background-thread prefetch queue.

    Abandonment-safe: the worker's puts poll a stop flag, raised by
    :meth:`close`, garbage collection of the iterator or generator
    exhaustion, so no thread or buffered batch outlives its consumer.

    While a profiler runs it records, under ``owner`` and keyed by the
    item's ordinal: ``<owner>.make`` (the worker producing an item),
    ``<owner>.queued`` (from the worker's put to the consumer's take),
    ``<owner>.wait`` (the consumer blocked on the queue) and the counter
    ``<owner>.ready`` (the items already waiting when the consumer takes
    one).
    """

    def __init__(self, gen, prefetch: int = 2, owner: str = "prefetch"):
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._taken = 0
        self._wait, self._queued, self._ready = (f"{owner}.{what}"
                                                 for what in ("wait", "queued", "ready"))
        make = f"{owner}.make"
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
                items = iter(gen)
                for key in itertools.count():
                    with profiling.span(make, key):
                        item = next(items, done)
                    if item is done:
                        break
                    if not put((item, profiling.stamp())):
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
        key = self._taken
        with profiling.span(self._wait, key):
            if profiling.recording():
                profiling.count(self._ready, self.q.qsize(), key)
            item = self.q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._taken += 1
        item, put_ns = item
        profiling.mark(self._queued, key, put_ns)
        return item

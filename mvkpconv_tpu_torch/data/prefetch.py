"""Background-thread batch prefetch: a copy of ``mvkpconv_tpu/data/prefetch.py``.

Replaces the reference's host-side pipeline parallelism — the 10-worker
torch DataLoader with shared-memory coordination that feeds the GPU
(ScanNet_sphere_color.py DataLoader init, SURVEY §2.5) — with a single
producer thread and a bounded queue: the next host batch is assembled while
the device runs the current step. One thread suffices because everything
per-batch-expensive moved on device (ops/pyramid.py, ops/unproject.py); the
remaining host work is potential sampling + frame selection + padding.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


class PrefetchIterator(Iterator):
    """Iterate ``source`` on a daemon thread, ``depth`` batches ahead.

    Exceptions raised by the producer are re-raised at the consuming
    ``next()`` call; the thread stops when the source is exhausted or the
    iterator is closed/garbage-collected.
    """

    def __init__(self, source: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

        def produce():
            try:
                for item in source:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(_DONE)
            except BaseException as e:  # surfaced on the consumer side
                self._q.put(e)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()


def prefetch(source: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(source, depth)

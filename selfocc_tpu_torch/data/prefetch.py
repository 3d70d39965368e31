"""Background batch prefetching — the port's copy of
``selfocc_tpu/data/prefetch.py``, the analog of the reference DataLoader's
worker processes (``dataset/__init__.py:82-106``, ``num_workers``):
host-side batch assembly (JPEG decode, augmentation, matrix stacking) runs
in a worker thread and overlaps the device's train step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Sequence


class BatchPrefetcher:
    """Iterates ``build(item)`` results, computed ``depth`` items ahead in a
    worker thread. Exceptions in the worker re-raise at the consuming
    ``__next__``; the worker exits promptly when the consumer stops
    (``close``) or the items run out."""

    _END = object()

    def __init__(self, build: Callable, items: Sequence, depth: int = 2):
        self._build = build
        self._items = list(items)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for it in self._items:
                if self._stop.is_set():
                    return
                out = self._build(it)
                while not self._stop.is_set():
                    try:
                        self._q.put(out, timeout=0.5)
                        break
                    except queue.Full:
                        continue
            self._q.put(self._END)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        out = self._q.get()
        if out is self._END:
            raise StopIteration
        if isinstance(out, BaseException):
            self.close()
            raise out
        return out

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

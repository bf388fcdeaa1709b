"""Host-side loaders: per-host sharding + background prefetch (twin of
`repro/data/loader.py`).

ShardedLoader slices each global batch to this host's row range (process
index over the data-parallel axis); PrefetchLoader overlaps host data
generation with device compute via a single background thread. Both hand
numpy batches on; the training step moves them to the model's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class ShardedLoader:
    def __init__(self, dataset, *, n_hosts: int = 1, host_index: int = 0,
                 start_batch: int = 0):
        self.dataset = dataset
        self.n_hosts = n_hosts
        self.host_index = host_index
        self.index = start_batch   # resumable: checkpoint stores this

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.dataset.global_batch
        per = b // self.n_hosts
        lo = self.host_index * per
        batch = self.dataset.batch(self.index, lo=lo, hi=lo + per)
        self.index += 1
        return batch

    def state(self) -> dict:
        return {"index": self.index}

    def restore(self, state: dict):
        self.index = int(state["index"])


class PrefetchLoader:
    """Wraps an iterator with a depth-k background prefetch queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self.it:
                self.q.put(item)
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        return item

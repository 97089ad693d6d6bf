"""Data loader: threaded prefetch + numpy collation to stacked arrays.

Torch-free replacement for the reference's torch DataLoader glue
(spann3r/datasets/__init__.py:16-50).  Items are lists of T view dicts; the
collated batch is a dict of (T, B, ...) arrays ready for the jitted train
step, plus per-view metadata lists.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

ARRAY_KEYS = ("img", "pts3d", "valid_mask", "camera_pose",
              "camera_intrinsics", "depthmap", "true_shape")


def collate_views(samples: List[List[dict]]) -> Dict[str, np.ndarray]:
    """samples: B items, each a list of T views -> {key: (T, B, ...)}."""
    t = len(samples[0])
    assert all(len(s) == t for s in samples), "ragged frame counts in batch"
    out: Dict[str, np.ndarray] = {}
    for key in ARRAY_KEYS:
        if key not in samples[0][0]:
            continue
        out[key] = np.stack([
            np.stack([np.asarray(s[v][key]) for s in samples])  # (B, ...)
            for v in range(t)])                                 # (T, B, ...)
    out["valid_mask"] = out["valid_mask"].astype(bool)
    return out


class DataLoader:
    """Iterates a dataset through a sampler with background-thread prefetch."""

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 2, prefetch: int = 2,
                 collate=collate_views):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate

    def __len__(self):
        if self.sampler is not None:
            return len(self.sampler) // self.batch_size
        return len(self.dataset) // self.batch_size

    def _index_batches(self) -> Iterator[List]:
        if self.sampler is not None:
            idxs = list(self.sampler)
        else:
            idxs = list(range(len(self.dataset)))
        for i in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
            yield idxs[i:i + self.batch_size]

    def __iter__(self):
        batches = self._index_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for batch_idx in batches:
                    items = [self.dataset[i] for i in batch_idx]
                    q.put(self.collate(items))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item

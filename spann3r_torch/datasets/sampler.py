"""Batched random sampler with per-batch aspect-ratio constraint and
process sharding (ref dust3r/datasets/base/batched_sampler.py:11-74).

Torch-free; `rank` maps to jax.process_index() for multi-host training.
"""
from __future__ import annotations

import numpy as np


def round_by(total: int, multiple: int, up: bool = False) -> int:
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple


class BatchedRandomSampler:
    """Yields (sample_idx, feat_idx) tuples; every `batch_size` consecutive
    indices share the same feat_idx (aspect-ratio pool index)."""

    def __init__(self, dataset_len: int, batch_size: int, pool_size: int,
                 world_size: int = 1, rank: int = 0, drop_last: bool = True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = n = dataset_len
        self.total_size = round_by(n, batch_size * world_size) if drop_last else n
        assert world_size == 1 or drop_last, \
            "must drop the last batch in distributed mode"
        self.world_size = world_size
        self.rank = rank
        self.epoch = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, \
                "use set_epoch() in distributed mode"
            seed = int(np.random.SeedSequence().entropy % (1 << 63))
        else:
            seed = self.epoch + 777
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)
        feat_idxs = np.broadcast_to(feat_idxs[:, None],
                                    (n_batches, self.batch_size))
        feat_idxs = feat_idxs.ravel()[:self.total_size]
        idxs = np.c_[sample_idxs, feat_idxs]

        size_per_proc = self.batch_size * (
            (self.total_size + self.world_size * self.batch_size - 1)
            // (self.world_size * self.batch_size))
        idxs = idxs[self.rank * size_per_proc:(self.rank + 1) * size_per_proc]
        yield from (tuple(int(v) for v in idx) for idx in idxs)

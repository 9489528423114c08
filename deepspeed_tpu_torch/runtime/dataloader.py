"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

Works over numpy-array datasets, dicts of arrays, or any indexable dataset
of dicts or arrays; batches are host numpy, and the engine moves them to
its device. Over dp data ranks the loader walks global batches of
`batch_size * dp` rows and yields part r of each, cut into dp parts
(`np.array_split`: `batch_size` rows of a whole batch), the rows the JAX
engine's batch sharded over ("repl", "data") gives the rank at flat index
r of those axes (the engine passes dp = repl x data and that index); a
rank reads only its own rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


class RepeatingLoader:
    """Wrap an iterable to restart it on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    def __init__(self, dataset: Any, batch_size: int,
                 collate_fn: Optional[Callable] = None, drop_last: bool = True,
                 shuffle: bool = True, seed: int = 0, data_parallel_size: int = 1,
                 data_parallel_rank: int = 0):
        if not 0 <= data_parallel_rank < data_parallel_size:
            raise ValueError(f"data_parallel_rank {data_parallel_rank} outside "
                             f"data_parallel_size {data_parallel_size}")
        self.dataset = dataset
        self.data_parallel_size, self.data_parallel_rank = data_parallel_size, data_parallel_rank
        self.batch_size = batch_size * data_parallel_size     # the global batch
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def _length(self) -> int:
        if isinstance(self.dataset, dict):
            return len(next(iter(self.dataset.values())))
        return len(self.dataset)

    def __len__(self):
        n = self._length()
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = self._length()
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        for start in range(0, n - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size):
            sel = np.array_split(idx[start:start + self.batch_size],
                                 self.data_parallel_size)[self.data_parallel_rank]
            if isinstance(self.dataset, dict):
                yield {k: np.asarray(v)[sel] for k, v in self.dataset.items()}
                continue
            items = [self.dataset[i] for i in sel]
            if self.collate_fn is not None:
                yield self.collate_fn(items)
            elif isinstance(items[0], dict):
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
            else:
                yield np.stack(items)

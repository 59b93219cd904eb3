"""Data loader, a copy of the JAX package's ``runtime/dataloader.py``.

``DeepSpeedTPUDataLoader`` yields GLOBAL batches (leading dim =
``train_batch_size``) as numpy trees collated on the host; the engine
splits them into micro-batches and stages them onto the device
(``runtime/data_pipeline.py``). The shuffle order is a pure function of
``(seed, epoch)``, so two loaders with the same seed and epoch yield the
same batch stream and ``RepeatingLoader``'s epoch bump reshuffles
reproducibly; the prefetch-0 and prefetch-2 loss streams rest on it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np


def _default_collate(items: Sequence[Any]):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(it[k]) for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(it[i]) for it in items])
                     for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class DeepSpeedTPUDataLoader:

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 42, drop_last: bool = True,
                 curriculum_schedule=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.curriculum_schedule = curriculum_schedule

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            sel = idx[start:start + self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            yield self.collate_fn(items)


class RepeatingLoader:
    """Parity: ``deepspeed.utils.RepeatingLoader`` — wraps a loader to restart on
    StopIteration (used by pipeline train loops)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

"""Host-side batching data loader with background prefetch.

The port's copy of the JAX package's ``data/loader.py``: batches are NHWC
numpy arrays assembled on a host thread and prefetched ahead of the train
step; the CLI copies each to the card.  Shuffles draw from a seeded
``np.random.RandomState``, and the transforms a dataset applies draw from
the global ``np.random`` on the producer thread, as in the JAX package, so
both packages give the same batches from the same seeds.
"""

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class ArrayDataset:
    """(inputs, targets) arrays/lists with an optional per-sample transform."""

    def __init__(self, inputs, targets=None, transform: Optional[Callable]
                 = None, paired_transform: Optional[Callable] = None):
        self.inputs = inputs
        self.targets = targets
        self.transform = transform
        self.paired_transform = paired_transform

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i):
        x = self.inputs[i]
        t = self.targets[i] if self.targets is not None else None
        if self.paired_transform is not None:
            x, t = self.paired_transform(x, t)
        if self.transform is not None:
            x = self.transform(x)
        return x, t


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def random_split(dataset, lengths, seed: int = 0):
    """Deterministic random split from ``np.random.RandomState(seed)``."""
    n = len(dataset)
    assert sum(lengths) == n, (lengths, n)
    perm = np.random.RandomState(seed).permutation(n)
    out = []
    start = 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start:start + ln]))
        start += ln
    return out


def _collate(samples):
    xs = np.stack([np.asarray(s[0]) for s in samples])
    ts = [s[1] for s in samples]
    if ts[0] is None:
        return xs, None
    return xs, np.stack([np.asarray(t) for t in ts])


class DataLoader:
    """Batching iterator: shuffle, fixed batch, optional background prefetch.

    ``drop_last`` defaults False (torch DataLoader semantics): the final
    batch may be partial.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        del num_workers  # accepted for API parity

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield _collate([self.dataset[j] for j in idx])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []

        def producer():
            try:
                for batch in self._batches():
                    q.put(batch)
            except Exception as e:  # surface loader errors to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        th.join()
        if error:
            raise error[0]

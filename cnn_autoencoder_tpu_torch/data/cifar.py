"""CIFAR-10/100 from the standard python pickle batches.

The port's copy of the JAX package's ``data/cifar.py``: reads the
``cifar-10-batches-py`` / ``cifar-100-python`` directories as distributed
upstream (or ``data_dir`` itself); nothing is downloaded.
"""

import os
import pickle
from typing import Tuple

import numpy as np

from .augs import get_cifar_transform
from .loader import ArrayDataset, DataLoader, random_split


def _load_batch(path: str, labels_key=b"labels"):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, np.asarray(d[labels_key], np.int64)


def load_cifar10(data_dir: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    root = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(root):
        root = data_dir
    if train:
        xs, ts = [], []
        for i in range(1, 6):
            x, t = _load_batch(os.path.join(root, f"data_batch_{i}"))
            xs.append(x)
            ts.append(t)
        return np.concatenate(xs), np.concatenate(ts)
    return _load_batch(os.path.join(root, "test_batch"))


def load_cifar100(data_dir: str, train: bool):
    root = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(root):
        root = data_dir
    fname = "train" if train else "test"
    return _load_batch(os.path.join(root, fname), labels_key=b"fine_labels")


def _make_queues(x, t, num_classes, batch_size, val_batch_size, mode,
                 normalize, seed, workers):
    transform = get_cifar_transform(mode, normalize)
    ds = ArrayDataset(x, t, transform=transform)
    if mode != "training":
        return DataLoader(ds, batch_size, shuffle=False), num_classes
    n_val = min(5000, max(1, len(ds) // 10))
    train_ds, valid_ds = random_split(ds, [len(ds) - n_val, n_val], seed=seed)
    return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed),
            DataLoader(valid_ds, val_batch_size, shuffle=False),
            num_classes)


def get_cifar10(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
                mode="training", normalize=True, seed=0, **kwargs):
    x, t = load_cifar10(data_dir, train=(mode == "training"))
    return _make_queues(x, t, 10, batch_size, val_batch_size, mode,
                        normalize, seed, workers)


def get_cifar100(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
                 mode="training", normalize=True, seed=0, **kwargs):
    x, t = load_cifar100(data_dir, train=(mode == "training"))
    return _make_queues(x, t, 100, batch_size, val_batch_size, mode,
                        normalize, seed, workers)

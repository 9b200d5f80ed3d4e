"""MNIST / EMNIST from raw idx files.

The port's copy of the JAX package's ``data/mnist.py``: the standard
idx(.gz) files are read from ``<data_dir>/<NAME>/raw/`` (torchvision's
layout), ``<data_dir>/<NAME>/`` or ``data_dir`` itself; nothing is
downloaded.
"""

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from .augs import get_mnist_transform
from .loader import ArrayDataset, DataLoader, random_split


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32,
                 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype)
        return data.reshape(dims)


def _find_idx(data_dir: str, name: str, fname: str) -> str:
    for candidate in (os.path.join(data_dir, name, "raw", fname),
                      os.path.join(data_dir, name, fname),
                      os.path.join(data_dir, fname)):
        if os.path.exists(candidate) or os.path.exists(candidate + ".gz"):
            return candidate
    raise FileNotFoundError(
        f"MNIST-style file {fname}(.gz) not found under {data_dir} "
        f"(expected torchvision raw layout {name}/raw/{fname})")


def load_mnist_arrays(data_dir: str, train: bool, name: str = "MNIST"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    prefix = "train" if train else "t10k"
    images = read_idx(_find_idx(data_dir, name,
                                f"{prefix}-images-idx3-ubyte"))
    labels = read_idx(_find_idx(data_dir, name,
                                f"{prefix}-labels-idx1-ubyte"))
    return images[..., None], labels.astype(np.int64)  # NHWC, single channel


def get_mnist(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
              mode="training", normalize=True, seed=0, **kwargs):
    """(train, valid, 10) queues for training; test queue otherwise
    (reference _datautils.py:72-97)."""
    transform = get_mnist_transform(mode, normalize)

    if mode != "training":
        x, t = load_mnist_arrays(data_dir, train=False)
        ds = ArrayDataset(x, t, transform=transform)
        return DataLoader(ds, batch_size, shuffle=False,
                          num_workers=workers), 10

    x, t = load_mnist_arrays(data_dir, train=True)
    ds = ArrayDataset(x, t, transform=transform)
    n_val = min(5000, max(1, len(ds) // 12))
    train_ds, valid_ds = random_split(ds, [len(ds) - n_val, n_val],
                                      seed=seed)
    return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed,
                       num_workers=workers),
            DataLoader(valid_ds, val_batch_size, shuffle=False,
                       num_workers=workers),
            10)


def get_emnist(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
               mode="training", normalize=True, seed=0, **kwargs):
    transform = get_mnist_transform(mode, normalize)
    name = "EMNIST"
    if mode != "training":
        x, t = load_mnist_arrays(data_dir, train=False, name=name)
        ds = ArrayDataset(x, t, transform=transform)
        return DataLoader(ds, batch_size, shuffle=False), 62

    x, t = load_mnist_arrays(data_dir, train=True, name=name)
    ds = ArrayDataset(x, t, transform=transform)
    n_val = max(1, len(ds) // 10)
    train_ds, valid_ds = random_split(ds, [len(ds) - n_val, n_val],
                                      seed=seed)
    return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed),
            DataLoader(valid_ds, val_batch_size, shuffle=False),
            62)

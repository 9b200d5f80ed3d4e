"""Dataset routing and filename resolution.

The port's copy of the JAX package's ``data/datautils.py``:
``get_filenames`` resolves directories, explicit lists, ``.txt`` manifests
and paths that name their format, with train/val/test substring filtering;
``get_data`` routes ``args.dataset`` to its loaders (MNIST, EMNIST, CIFAR10,
CIFAR100, ImageNet, Zarr).  The loaders give host numpy batches; ``device``
is where a 'cae' coded zarr store's codec builds (``None``: the card).
"""

import os
from functools import partial, reduce
from typing import List

import numpy as np

from .augs import get_zarr_transform
from .cifar import get_cifar10, get_cifar100
from .imagenet import get_imagenet
from .mnist import get_emnist, get_mnist
from .zarr_dataset import (BlueNoisePatchSampler, GridPatchSampler,
                           IterableLoader, LabeledZarrDataset, ZarrDataset)


def get_filenames(source, source_format: str, data_mode: str) -> List[str]:
    if (isinstance(source, str) and source_format in source.lower()) \
            or isinstance(source, np.ndarray):
        return [source]

    if isinstance(source, list):
        source_mode = [fn for fn in source
                       if isinstance(fn, str) and data_mode in fn]
        if source_mode:
            source = source_mode
        return reduce(lambda l1, l2: l1 + l2,
                      map(partial(get_filenames, source_format=source_format,
                                  data_mode=data_mode), source), [])

    if isinstance(source, str) and source.lower().endswith("txt"):
        with open(source) as f:
            filenames = [line.strip("\n\r ") for line in f.readlines()]
        return get_filenames(filenames, source_format, data_mode)

    if isinstance(source, str) and os.path.isdir(source):
        entries = [os.path.join(source, fn)
                   for fn in sorted(os.listdir(source))
                   if source_format in fn.lower()]
        return reduce(lambda l1, l2: l1 + l2,
                      map(partial(get_filenames, source_format=source_format,
                                  data_mode=data_mode), entries), [])

    return []


def get_zarr_dataset(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
                     data_mode="training", mode="training",
                     shuffle_train=True, shuffle_val=True,
                     shuffle_test=False, num_classes=None, label_density=0,
                     criterion=None, patch_sample_mode=None, patch_size=128,
                     seed=0, device=None, **kwargs):
    """Queues of zarr/WSI patches; a 'cae' coded store builds its codec on
    ``device``."""
    target_data_type = None
    if criterion is not None and "ce" in criterion.lower():
        target_data_type = (np.float32 if "bce" in criterion.lower()
                            else np.int64)

    prep, input_target, target = get_zarr_transform(
        data_mode=data_mode, label_density=label_density,
        target_data_type=target_data_type, patch_size=patch_size, **kwargs)

    dataset_cls = LabeledZarrDataset if label_density else ZarrDataset

    if isinstance(patch_sample_mode, str) and "blue-noise" in \
            patch_sample_mode:
        sampler = BlueNoisePatchSampler(patch_size=patch_size, **kwargs)
    elif isinstance(patch_sample_mode, str) and "grid" in patch_sample_mode:
        sampler = GridPatchSampler(patch_size=patch_size, **kwargs)
    else:
        sampler = None

    common = dict(transform=prep, input_target_transform=input_target,
                  target_transform=target, patch_sampler=sampler,
                  patch_size=patch_size, seed=seed, device=device, **kwargs)

    if "test" in mode:
        test_files = get_filenames(data_dir, ".zarr", data_mode)
        ds = dataset_cls(test_files, shuffle=shuffle_test, **common)
        return IterableLoader(ds, batch_size), num_classes

    train_files = get_filenames(data_dir, ".zarr", "train")
    val_files = get_filenames(data_dir, ".zarr", "val")
    train_ds = dataset_cls(train_files, shuffle=shuffle_train, **common)
    valid_ds = dataset_cls(val_files, shuffle=shuffle_val, **common)
    return (IterableLoader(train_ds, batch_size),
            IterableLoader(valid_ds, val_batch_size),
            num_classes)


def get_data(args, device=None):
    """(train, valid, num_classes) queues in training mode; (test queue,
    num_classes) otherwise."""
    args_dict = dict(args if isinstance(args, dict) else vars(args))

    if isinstance(args_dict.get("data_dir"), list) \
            and len(args_dict["data_dir"]) == 1:
        args_dict["data_dir"] = args_dict["data_dir"][0]

    dataset = args_dict.get("dataset")
    if dataset == "MNIST":
        return get_mnist(**args_dict)
    if dataset == "EMNIST":
        return get_emnist(**args_dict)
    if dataset == "CIFAR10":
        return get_cifar10(**args_dict)
    if dataset == "CIFAR100":
        return get_cifar100(**args_dict)
    if dataset in ("ImageNet", "ImageNet.S3"):
        return get_imagenet(**args_dict)
    if dataset in ("Zarr", "Histology"):
        return get_zarr_dataset(device=device, **args_dict)
    raise ValueError(
        'The dataset "%s" is not available for training.' % dataset)

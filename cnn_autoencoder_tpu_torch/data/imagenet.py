"""ImageNet-style folder / manifest datasets.

The port's copy of the JAX package's ``data/imagenet.py``: a local image
folder (class subdirectories or flat), and ``.txt`` manifests whose entries
(and the manifest itself) may be ``http(s)://`` or ``s3://`` URLs, read
through ``data/remote.py``.  PIL is imported at the first image read, so the
module imports on a machine without PIL.
"""

import io
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from .augs import get_imagenet_transform
from .loader import DataLoader, random_split
from .remote import fetch_remote, is_remote

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """Lazy image-folder dataset; labels from class subdirectory order."""

    def __init__(self, root: str, transform=None):
        self.root = root
        self.transform = transform
        self.samples: List[Tuple[str, int]] = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if classes:
            for ci, cls in enumerate(classes):
                cdir = os.path.join(root, cls)
                for fn in sorted(os.listdir(cdir)):
                    if fn.lower().endswith(IMG_EXTS):
                        self.samples.append((os.path.join(cdir, fn), ci))
        else:
            for fn in sorted(os.listdir(root)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(root, fn), 0))
        self.num_classes = max(len(classes), 1)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image
        path, label = self.samples[i]
        with Image.open(path) as im:
            x = np.asarray(im.convert("RGB"))
        if self.transform is not None:
            x = self.transform(x)
        return x, np.int64(label)


class ImageManifest:
    """Dataset from a .txt manifest of image paths/URLs.

    Local paths load via PIL; ``s3://``/``http(s)://`` entries stream via
    urllib (anonymous S3 is plain HTTPS GET — no boto3 needed).  The
    manifest file itself may also be remote.  Labels resolve through an
    ``imagenet_classes.json`` (wnid -> index) next to the manifest when
    present (reference _imagenet.py:53-86).
    """

    def __init__(self, manifest: str, transform=None,
                 dataset_size: Optional[int] = None,
                 s3_endpoint: Optional[str] = None):
        self.transform = transform
        self.s3_endpoint = s3_endpoint or os.environ.get("CAE_S3_ENDPOINT")
        if is_remote(manifest):
            text = fetch_remote(manifest,
                                s3_endpoint=self.s3_endpoint).decode()
            self.entries = [ln.strip() for ln in text.splitlines()
                            if ln.strip()]
        else:
            with open(manifest) as f:
                self.entries = [ln.strip() for ln in f if ln.strip()]
        if dataset_size is not None and dataset_size > 0:
            self.entries = self.entries[:dataset_size]
        self._wnid_map = None
        if not is_remote(manifest):
            class_map = os.path.join(os.path.dirname(manifest),
                                     "imagenet_classes.json")
            if os.path.exists(class_map):
                with open(class_map) as f:
                    self._wnid_map = json.load(f)

    def __len__(self):
        return len(self.entries)

    def _label(self, path: str) -> int:
        if self._wnid_map is None:
            return 0
        wnid = os.path.basename(path).split("_")[0]
        return int(self._wnid_map.get(wnid, 0))

    def __getitem__(self, i):
        from PIL import Image
        path = self.entries[i]
        if is_remote(path):
            data = fetch_remote(path, s3_endpoint=self.s3_endpoint)
            with Image.open(io.BytesIO(data)) as im:
                x = np.asarray(im.convert("RGB"))
        else:
            with Image.open(path) as im:
                x = np.asarray(im.convert("RGB"))
        if self.transform is not None:
            x = self.transform(x)
        return x, np.int64(self._label(path))


def get_imagenet(data_dir=".", batch_size=1, val_batch_size=1, workers=0,
                 mode="training", normalize=False, patch_size=128,
                 train_dataset_size=None, val_dataset_size=None,
                 test_dataset_size=None, seed=0, **kwargs):
    """Queues per the reference's routing (reference _datautils.py:186-257)."""
    transform = get_imagenet_transform(mode, normalize, patch_size)

    if isinstance(data_dir, list) and len(data_dir) == 1:
        data_dir = data_dir[0]

    manifest_like = (
        (isinstance(data_dir, list)
         and (data_dir[0].endswith("txt") or data_dir[0].startswith("s3")
              or data_dir[0].startswith("http")))
        or (isinstance(data_dir, str) and data_dir.endswith("txt")))

    if manifest_like:
        if mode != "training":
            ds = ImageManifest(
                data_dir if isinstance(data_dir, str) else data_dir[0],
                transform, test_dataset_size)
            return DataLoader(ds, batch_size, shuffle=False), 1000
        trn = [fn for fn in data_dir if "train" in fn][0]
        val = [fn for fn in data_dir if "val" in fn][0]
        train_ds = ImageManifest(trn, transform, train_dataset_size)
        valid_ds = ImageManifest(val, transform, val_dataset_size)
        return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed),
                DataLoader(valid_ds, val_batch_size, shuffle=False),
                1000)

    sub = os.path.join(data_dir, "ILSVRC/Data/CLS-LOC/test")
    root = sub if os.path.isdir(sub) else data_dir
    ds = ImageFolder(root, transform)
    if mode != "training":
        return DataLoader(ds, batch_size, shuffle=False), ds.num_classes

    train_size = int(len(ds) * 0.96)
    train_ds, valid_ds = random_split(
        ds, [train_size, len(ds) - train_size], seed=seed)
    return (DataLoader(train_ds, batch_size, shuffle=True, seed=seed),
            DataLoader(valid_ds, val_batch_size, shuffle=False),
            1000)

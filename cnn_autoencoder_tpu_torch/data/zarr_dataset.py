"""Zarr patch-sampling datasets: grid + blue-noise samplers, masks, labels.

The port's copy of the JAX package's ``data/zarr_dataset.py``, on the
port's own store (``storage/zarr.py``) and ``data/imageio.py``: iterable
patch datasets over (possibly gigapixel) zarr images with

* ``GridPatchSampler``: all non-overlapping patch positions;
* ``BlueNoisePatchSampler``: Poisson-disk (Bridson) positions;
* mask-aware sampling (positions kept only where a low-res mask is
  positive);
* ``LabeledZarrDataset``: paired (patch, label patch) extraction;
* ``shard()``, the per-worker file split;
* axes normalization (TCZYX -> YXC) and the filename ROI syntax.

Patches come out as fixed-shape HWC numpy arrays.  The stores are read on
the host; a store whose chunks are 'cae' coded builds its codec on
``device`` (``None``: the card).
"""

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..storage import zarr as zarrlib
from .imageio import map_axes_order, parse_roi


def _normalize_axes_array(arr: np.ndarray, data_axes: str) -> np.ndarray:
    """Select T=0/Z=0 and transpose to YXC."""
    if arr.ndim == 2:
        return arr[:, :, None]
    axes = data_axes[-arr.ndim:] if len(data_axes) != arr.ndim else data_axes
    perm = map_axes_order(axes, "".join(a for a in axes if a not in "YXC")
                          + "YXC")
    arr = np.transpose(arr, perm)
    while arr.ndim > 3:
        arr = arr[0]
    return arr


class ZarrImage:
    """One image source: lazy chunk-backed zarr array or eager PIL image;
    a 'cae' coded store's codec builds on ``device``."""

    def __init__(self, filename: str, data_group: str = "0/0",
                 data_axes: str = "XYZCT", source_format: str = ".zarr",
                 device=None):
        self.filename, self.rois = parse_roi(filename, source_format)
        self.data_axes = data_axes
        self.data_group = data_group
        self.device = device
        self._arr = None
        self._shape_yxc = None

    def _open(self):
        if self._arr is not None:
            return self._arr
        from .imageio import image2array
        arr = image2array(self.filename, source_format=".zarr"
                          if (self.filename.endswith(".zarr")
                              or os.path.isdir(self.filename))
                          else os.path.splitext(self.filename)[1],
                          data_group=self.data_group, device=self.device)
        self._arr = arr
        return arr

    @property
    def shape_yxc(self) -> Tuple[int, int, int]:
        if self._shape_yxc is None:
            arr = self._open()
            if isinstance(arr, zarrlib.Array):
                axes = (self.data_axes[-arr.ndim:]
                        if len(self.data_axes) != arr.ndim
                        else self.data_axes)
                h = arr.shape[axes.index("Y")]
                w = arr.shape[axes.index("X")]
                c = arr.shape[axes.index("C")] if "C" in axes else 1
            else:
                h, w = arr.shape[:2]
                c = arr.shape[2] if arr.ndim == 3 else 1
            self._shape_yxc = (h, w, c)
        return self._shape_yxc

    def read_patch(self, y: int, x: int, size: int) -> np.ndarray:
        arr = self._open()
        h, w, c = self.shape_yxc
        y1, x1 = min(y + size, h), min(x + size, w)
        if isinstance(arr, zarrlib.Array):
            axes = (self.data_axes[-arr.ndim:]
                    if len(self.data_axes) != arr.ndim else self.data_axes)
            sl = []
            for a in axes:
                if a == "Y":
                    sl.append(slice(y, y1))
                elif a == "X":
                    sl.append(slice(x, x1))
                elif a == "C":
                    sl.append(slice(None))
                else:
                    sl.append(slice(0, 1))
            patch = arr[tuple(sl)]
            patch = _normalize_axes_array(
                patch.reshape([s for s in patch.shape if True]), axes) \
                if patch.ndim != 3 else patch
            if patch.ndim == 2:
                patch = patch[:, :, None]
        else:
            patch = arr[y:y1, x:x1]
            if patch.ndim == 2:
                patch = patch[:, :, None]
        if patch.shape[0] < size or patch.shape[1] < size:
            patch = np.pad(patch, ((0, size - patch.shape[0]),
                                   (0, size - patch.shape[1]), (0, 0)))
        return patch


class GridPatchSampler:
    """All non-overlapping patch top-left positions."""

    def __init__(self, patch_size: int = 128, **kwargs):
        self.patch_size = patch_size

    def positions(self, height: int, width: int,
                  rng: Optional[np.random.RandomState] = None
                  ) -> List[Tuple[int, int]]:
        p = self.patch_size
        return [(i * p, j * p)
                for i in range(max(1, height // p))
                for j in range(max(1, width // p))]


class BlueNoisePatchSampler:
    """Poisson-disk (Bridson) patch positions: spatially decorrelated
    coverage of large slides."""

    def __init__(self, patch_size: int = 128, sampling_radius: float = None,
                 max_points: Optional[int] = None, **kwargs):
        self.patch_size = patch_size
        self.radius = sampling_radius or patch_size
        self.max_points = max_points

    def positions(self, height: int, width: int,
                  rng: Optional[np.random.RandomState] = None
                  ) -> List[Tuple[int, int]]:
        rng = rng or np.random.RandomState(0)
        r = self.radius
        p = self.patch_size
        h, w = max(1, height - p), max(1, width - p)
        cell = r / np.sqrt(2)
        gw, gh = int(np.ceil(w / cell)) + 1, int(np.ceil(h / cell)) + 1
        grid = -np.ones((gh, gw), np.int64)
        points: List[Tuple[float, float]] = []
        active: List[int] = []

        def grid_idx(pt):
            return int(pt[0] / cell), int(pt[1] / cell)

        def fits(pt):
            gy, gx = grid_idx(pt)
            y0, y1 = max(0, gy - 2), min(gh, gy + 3)
            x0, x1 = max(0, gx - 2), min(gw, gx + 3)
            for yy in range(y0, y1):
                for xx in range(x0, x1):
                    k = grid[yy, xx]
                    if k >= 0:
                        q = points[k]
                        if (q[0] - pt[0]) ** 2 + (q[1] - pt[1]) ** 2 < r * r:
                            return False
            return True

        first = (rng.rand() * h, rng.rand() * w)
        points.append(first)
        gy, gx = grid_idx(first)
        grid[gy, gx] = 0
        active.append(0)

        while active:
            if self.max_points and len(points) >= self.max_points:
                break
            i = active[rng.randint(len(active))]
            base = points[i]
            found = False
            for _ in range(30):
                ang = rng.rand() * 2 * np.pi
                rad = r * (1 + rng.rand())
                cand = (base[0] + rad * np.sin(ang),
                        base[1] + rad * np.cos(ang))
                if 0 <= cand[0] < h and 0 <= cand[1] < w and fits(cand):
                    points.append(cand)
                    gy, gx = grid_idx(cand)
                    grid[gy, gx] = len(points) - 1
                    active.append(len(points) - 1)
                    found = True
                    break
            if not found:
                active.remove(i)

        return [(int(pt[0]), int(pt[1])) for pt in points]


def _load_mask(filename: str, mask_group: str, mask_data_axes: str = "XY",
               device=None):
    try:
        root = zarrlib.open(filename, mode="r", device=device)
    except FileNotFoundError:
        return None
    if not isinstance(root, zarrlib.Group) or mask_group not in root:
        return None
    mask = root[mask_group][...]
    if mask.ndim > 2:
        mask = mask.reshape(mask.shape[-2:])
    if mask_data_axes == "XY":
        mask = mask.T
    return mask


class ZarrDataset:
    """Iterable dataset of (patch, target) over a list of zarr/WSI files.

    ``shard(worker, num_workers)`` splits files across workers.
    """

    def __init__(self, filenames: Sequence[str], transform=None,
                 input_target_transform=None, target_transform=None,
                 patch_sampler=None, shuffle: bool = False,
                 patch_size: int = 128, data_group: str = "0/0",
                 data_axes: str = "XYZCT", mask_group: Optional[str] = None,
                 mask_data_axes: str = "XY", seed: int = 0,
                 dataset_size: int = -1, device=None, **kwargs):
        self._filenames = list(filenames)
        self.transform = transform
        self.input_target_transform = input_target_transform
        self.target_transform = target_transform
        self.patch_sampler = patch_sampler or GridPatchSampler(patch_size)
        self.shuffle = shuffle
        self.patch_size = patch_size
        self.data_group = data_group or "0/0"
        self.data_axes = data_axes
        self.mask_group = mask_group
        self.mask_data_axes = mask_data_axes
        self.seed = seed
        self.dataset_size = dataset_size
        self.device = device
        self._worker = (0, 1)

    def shard(self, worker: int, num_workers: int):
        self._worker = (worker, num_workers)
        return self

    def _mask_allows(self, mask, y, x, h, w):
        if mask is None:
            return True
        my = int(y / max(h, 1) * mask.shape[0])
        mx = int(x / max(w, 1) * mask.shape[1])
        return bool(mask[min(my, mask.shape[0] - 1),
                         min(mx, mask.shape[1] - 1)])

    def _iter_positions(self):
        worker, num_workers = self._worker
        files = self._filenames[worker::num_workers]
        rng = np.random.RandomState(self.seed + worker)
        entries = []
        for fn in files:
            img = ZarrImage(fn, self.data_group, self.data_axes,
                            device=self.device)
            h, w, _ = img.shape_yxc
            mask = (_load_mask(img.filename, self.mask_group,
                               self.mask_data_axes, self.device)
                    if self.mask_group else None)
            pos = [pt for pt in self.patch_sampler.positions(h, w, rng)
                   if self._mask_allows(mask, pt[0], pt[1], h, w)]
            entries.extend((img, pt) for pt in pos)
        if self.shuffle:
            rng.shuffle(entries)
        if self.dataset_size and self.dataset_size > 0:
            entries = entries[:self.dataset_size]
        return entries

    def _get_target(self, img: ZarrImage, y: int, x: int):
        return None

    def __iter__(self) -> Iterator:
        for img, (y, x) in self._iter_positions():
            patch = img.read_patch(y, x, self.patch_size)
            target = self._get_target(img, y, x)
            if self.input_target_transform is not None and target is not None:
                patch, target = self.input_target_transform((patch, target))
            if self.transform is not None:
                patch = self.transform(patch)
            if self.target_transform is not None and target is not None:
                target = self.target_transform(target)
            yield patch, target

    def __len__(self):
        return len(self._iter_positions())


class LabeledZarrDataset(ZarrDataset):
    """Paired (patch, label patch) dataset; labels from a second group."""

    def __init__(self, filenames, labels_data_group: str = "labels/0/0",
                 labels_data_axes: str = "XYZCT", **kwargs):
        super().__init__(filenames, **kwargs)
        self.labels_data_group = labels_data_group or "labels/0/0"
        self.labels_data_axes = labels_data_axes
        self._label_images = {}

    def _get_target(self, img: ZarrImage, y: int, x: int):
        key = img.filename
        if key not in self._label_images:
            self._label_images[key] = ZarrImage(
                img.filename, self.labels_data_group, self.labels_data_axes,
                device=self.device)
        limg = self._label_images[key]
        lh, lw, _ = limg.shape_yxc
        h, w, _ = img.shape_yxc
        scale_y, scale_x = lh / h, lw / w
        size = max(1, int(round(self.patch_size * scale_y)))
        return limg.read_patch(int(y * scale_y), int(x * scale_x), size)


class IterableLoader:
    """Batching wrapper for iterable (patch) datasets."""

    def __init__(self, dataset: ZarrDataset, batch_size: int = 1,
                 num_workers: int = 0, **kwargs):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        xs, ts = [], []
        for x, t in self.dataset:
            xs.append(np.asarray(x))
            ts.append(t)
            if len(xs) == self.batch_size:
                yield (np.stack(xs),
                       None if ts[0] is None
                       else np.stack([np.asarray(t) for t in ts]))
                xs, ts = [], []
        if xs:
            yield (np.stack(xs),
                   None if ts[0] is None
                   else np.stack([np.asarray(t) for t in ts]))

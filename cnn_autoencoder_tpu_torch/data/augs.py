"""Host-side augmentations and per-dataset transform factories (NHWC numpy).

The port's copy of the JAX package's ``data/augs.py``: gaussian noise,
random and center crops, paired elastic deformation (a B-spline control grid
interpolated with scipy), paired rotation, U-Net style distance-based weight
maps, label mapping and merging, and the per-dataset transform pipelines
(zarr, imagenet, mnist, cifar).  All transforms take and give HWC numpy
arrays (inputs float32 in [0, 1] after ``ToFloat``) and draw from the global
``np.random``, as the JAX package's do.
"""

from typing import Callable, List, Sequence

import numpy as np

try:
    from scipy import ndimage
except ImportError:  # pragma: no cover
    ndimage = None

MERGE_FUNS = {"mean": np.mean, "max": np.max, "median": np.median}


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToFloat:
    """HWC uint8 [0,255] -> float32 [0,1]."""

    def __call__(self, x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32)


class Normalize:
    def __init__(self, mean=0.5, std=0.5):
        self.mean, self.std = mean, std

    def __call__(self, x):
        return (x - self.mean) / self.std


class Pad:
    def __init__(self, padding: int):
        self.padding = padding

    def __call__(self, x):
        p = self.padding
        return np.pad(x, ((p, p), (p, p), (0, 0)))


class AddGaussianNoise:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, x):
        noisy = x + np.random.randn(*x.shape).astype(np.float32) * self.std \
            + self.mean
        return np.clip(noisy, 0, 1)


class RandomCrop:
    def __init__(self, size: int, pad_if_needed: bool = True):
        self.size = size
        self.pad_if_needed = pad_if_needed

    def __call__(self, x):
        s = self.size
        h, w = x.shape[:2]
        if self.pad_if_needed and (h < s or w < s):
            x = np.pad(x, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)))
            h, w = x.shape[:2]
        i = np.random.randint(0, h - s + 1)
        j = np.random.randint(0, w - s + 1)
        return x[i:i + s, j:j + s]


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, x):
        s = self.size
        h, w = x.shape[:2]
        if h < s or w < s:
            x = np.pad(x, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)))
            h, w = x.shape[:2]
        i, j = (h - s) // 2, (w - s) // 2
        return x[i:i + s, j:j + s]


def _control_grid_displacement(shape, sigma=10, points=3):
    """Random B-spline-style displacement field from a points x points grid."""
    disp = np.random.randn(2, points, points) * sigma
    h, w = shape
    field = np.stack([
        ndimage.zoom(disp[d], (h / points, w / points), order=3)
        for d in range(2)])
    return field


class RandomElasticDeformationInput:
    """Elastic deformation of the input only (reference _augs.py:85-99)."""

    def __init__(self, sigma=10):
        self.sigma = sigma

    def __call__(self, x):
        field = _control_grid_displacement(x.shape[:2], self.sigma)
        yy, xx = np.meshgrid(np.arange(x.shape[0]), np.arange(x.shape[1]),
                             indexing="ij")
        coords = [yy + field[0], xx + field[1]]
        out = np.stack([
            ndimage.map_coordinates(x[..., c], coords, order=3,
                                    mode="reflect")
            for c in range(x.shape[-1])], axis=-1)
        return out.astype(np.float32)


class RandomElasticDeformationInputTarget:
    """Shared-displacement elastic deformation of (input, dense target)."""

    def __init__(self, sigma=10):
        self.sigma = sigma

    def __call__(self, patch_target):
        patch, target = patch_target
        field = _control_grid_displacement(patch.shape[:2], self.sigma)
        yy, xx = np.meshgrid(np.arange(patch.shape[0]),
                             np.arange(patch.shape[1]), indexing="ij")
        coords = [yy + field[0], xx + field[1]]

        def warp(img, order):
            if img.ndim == 2:
                img = img[..., None]
            out = np.stack([
                ndimage.map_coordinates(img[..., c], coords, order=order,
                                        mode="reflect")
                for c in range(img.shape[-1])], axis=-1)
            return out

        return (warp(patch, 3).astype(np.float32),
                warp(target, 0).astype(np.float32))


class RandomRotationInputTarget:
    def __init__(self, degrees=90.0):
        self.degrees = degrees

    def __call__(self, patch_target):
        patch, target = patch_target
        angle = np.random.rand() * self.degrees
        patch = ndimage.rotate(patch, angle, order=4, reshape=False,
                               mode="reflect", axes=(0, 1))
        target = ndimage.rotate(target, angle, order=0, reshape=False,
                                mode="reflect", axes=(0, 1))
        return patch.astype(np.float32), target.astype(np.float32)


class RandomRotationInput:
    def __init__(self, degrees=30.0):
        self.degrees = degrees

    def __call__(self, x):
        angle = (np.random.rand() * 2 - 1) * self.degrees
        return ndimage.rotate(x, angle, order=1, reshape=False,
                              mode="reflect", axes=(0, 1)).astype(np.float32)


class WeightsDistances:
    """U-Net per-pixel weight map from distances to nearest objects; output
    concatenates the weight channel before the target channels (HWC), so
    channel 0 is the weight map (reference _augs.py:102-136)."""

    def __init__(self, class_weights, sigma=5, w_0=10):
        self.class_weights = np.asarray(class_weights, np.float32)
        self.sigma_2 = 2 * sigma ** 2
        self.w_0 = w_0
        self.structure = np.ones((3, 3))

    def __call__(self, target):
        target = np.asarray(target)
        if target.ndim == 2:
            target = target[..., None]
        base = target[..., 0]
        w_x = np.take(self.class_weights,
                      base.astype(np.int32)).astype(np.float32)

        if target.sum() > 0:
            labels, num_objects = ndimage.label(base,
                                                structure=self.structure)
            dists = []
            for lbl in range(1, num_objects + 1):
                remaining = np.ones_like(base, np.float32)
                remaining[labels == lbl] = 0
                dists.append(ndimage.distance_transform_edt(remaining)
                             .astype(np.float32))
            dists = np.sort(np.stack(dists), axis=0)
            if num_objects > 1:
                w_1 = np.exp(-(dists[0] + dists[1]) ** 2 / self.sigma_2)
            else:
                w_1 = np.exp(-dists[0] ** 2 / self.sigma_2)
            w_x = w_x + self.w_0 * w_1

        return np.concatenate([w_x[..., None], target], axis=-1)


class MapLabels:
    """Cumulative-onehot to ordinal mapping (reference _augs.py:139-148)."""

    def __call__(self, target):
        return np.sum(target, axis=-1)


class MergeLabels:
    def __init__(self, merge_type: str):
        self._merge_fun = MERGE_FUNS[merge_type]

    def __call__(self, target):
        merge_axis = tuple(range(target.ndim - 2, target.ndim))
        return self._merge_fun(target, axis=merge_axis)


class AsType:
    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, x):
        return np.asarray(x).astype(self.dtype)


# --- per-dataset transform factories ----------------------------------------


def get_mnist_transform(data_mode="training", normalize=True) -> Compose:
    trans = [Pad(2), ToFloat()]
    if normalize:
        trans.append(Normalize(0.5, 0.5))
    return Compose(trans)


def get_cifar_transform(data_mode="training", normalize=True) -> Compose:
    trans = [ToFloat()]
    if normalize:
        trans.append(Normalize(0.5, 0.5))
    return Compose(trans)


def get_imagenet_transform(data_mode="training", normalize=False,
                           patch_size=128) -> Compose:
    trans: List[Callable] = [ToFloat()]
    if "train" in data_mode:
        trans.append(AddGaussianNoise(0.0, 0.01))
        trans.append(RandomCrop(patch_size, pad_if_needed=True))
    elif "test" in data_mode:
        trans.append(CenterCrop(patch_size))
    if normalize:
        trans.append(Normalize(0.5, 0.5))
    return Compose(trans)


def get_zarr_transform(data_mode="test", normalize=False,
                       compressed_input=False, rotation=False,
                       elastic_deformation=False, target_data_type=None,
                       label_density=0, map_labels=None, merge_labels=None,
                       add_noise=False, patch_size=128,
                       weight_map_sigma=None, weight_map_w_0=None,
                       class_weights=None, **kwargs):
    """(input transform, paired input+target transform, target transform)
    for zarr patch datasets (reference _augs.py:197-299)."""
    prep: List[Callable] = [ToFloat()]
    if add_noise:
        prep.append(AddGaussianNoise(0.0, 0.001))
    if "train" in data_mode:
        prep.append(RandomCrop(patch_size, pad_if_needed=True))
    elif "test" in data_mode:
        prep.append(CenterCrop(patch_size))
    if not compressed_input and normalize:
        prep.append(Normalize(0.5, 0.5))

    input_target: List[Callable] = []
    if rotation:
        if label_density == 2:
            input_target.append(RandomRotationInputTarget(degrees=30.0))
        else:
            prep.append(RandomRotationInput(degrees=30.0))
    if elastic_deformation:
        if label_density == 2:
            input_target.append(RandomElasticDeformationInputTarget(sigma=10))
        else:
            prep.append(RandomElasticDeformationInput(sigma=10))

    target: List[Callable] = []
    if map_labels:
        target.append(MapLabels())
    if merge_labels is not None:
        target.append(MergeLabels(merge_labels))
    if (class_weights is not None and weight_map_sigma is not None
            and weight_map_w_0 is not None):
        target.append(WeightsDistances(class_weights, weight_map_sigma,
                                       weight_map_w_0))
    if target_data_type is not None:
        target.append(AsType(target_data_type))

    return (Compose(prep),
            Compose(input_target) if input_target else None,
            Compose(target) if target else None)

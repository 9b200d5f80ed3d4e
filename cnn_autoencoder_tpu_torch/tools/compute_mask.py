"""Tissue-mask computation for WSI zarr files: the port of the JAX
package's ``scripts/compute_mask.py``.

    python -m cnn_autoencoder_tpu_torch.tools.compute_mask -i slide.zarr \
        [-o out_dir] [-da XYZCT] [-s 1.25] [-dm 20]

Parses the magnification from OME metadata, downscales the slide to ~1.25x,
Otsu-thresholds the grayscale, cleans it with morphology (remove small
objects and holes, dilate with a disk), and writes ``masks/0/0`` with scale
attributes.  numpy and scipy on the host, as in the JAX tool, so the mask
chunks are byte-equal to its.
"""

import argparse
import math
import os

import numpy as np
from scipy import ndimage

from ..storage import zarr as zarrlib
from ..storage.codecs import Blosc


def otsu_threshold(gray: np.ndarray) -> float:
    """Otsu's method over a 256-bin histogram."""
    hist, bin_edges = np.histogram(gray.ravel(), bins=256)
    hist = hist.astype(np.float64)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    mu0 = np.cumsum(hist * centers)
    mu_t = mu0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        var_between = (mu_t * w0 - mu0) ** 2 / (w0 * w1)
    var_between[~np.isfinite(var_between)] = 0
    return centers[np.argmax(var_between)]


def remove_small_objects(mask: np.ndarray, min_size: int) -> np.ndarray:
    labels, n = ndimage.label(mask, structure=np.ones((3, 3)))
    if n == 0:
        return mask
    sizes = ndimage.sum(mask, labels, range(1, n + 1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes >= min_size
    return keep[labels]


def remove_small_holes(mask: np.ndarray, area_threshold: int) -> np.ndarray:
    return ~remove_small_objects(~mask, area_threshold)


def disk(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (yy ** 2 + xx ** 2) <= radius ** 2


def get_mask(scaled_wsi: np.ndarray) -> np.ndarray:
    """Otsu + morphology cleanup (reference compute_mask.py:18-29)."""
    gray = scaled_wsi.astype(np.float64) @ np.asarray([0.2125, 0.7154,
                                                       0.0721])
    thresh = otsu_threshold(gray)
    mask = gray > thresh
    mask = remove_small_objects(mask == 0, min_size=16 * 16)
    mask = remove_small_holes(mask, area_threshold=128 * 128)
    mask = ndimage.binary_dilation(mask, structure=disk(16))
    return mask


def _downscale(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Area-style downscale by integer-strided mean pooling + crop."""
    h, w = img.shape[:2]
    fy, fx = max(1, h // out_h), max(1, w // out_w)
    hh, ww = (h // fy) * fy, (w // fx) * fx
    pooled = img[:hh, :ww].reshape(hh // fy, fy, ww // fx, fx, -1) \
        .mean(axis=(1, 3))
    return pooled[:out_h, :out_w]


def parse_magnification(z_url: str, default_mag: float = 40.0) -> float:
    """AppMag / Power from OME/METADATA.ome.xml
    (reference compute_mask.py:93-123)."""
    ome_path = os.path.join(z_url, "OME", "METADATA.ome.xml")
    if not os.path.isfile(ome_path):
        return default_mag
    with open(ome_path) as f:
        z_ome = f.read()
    mag = None
    pos = z_ome.find("AppMag")
    if pos >= 0:
        ini = z_ome.find("=", pos) + 1
        end = z_ome.find("|", ini)
        try:
            mag = float(z_ome[ini:end].strip(" "))
        except ValueError:
            pass
    pos = z_ome.find("Power")
    if pos >= 0:
        ini = z_ome.find(">", z_ome.find("Value", pos)) + 1
        end = z_ome.find("<", ini)
        try:
            mag = float(z_ome[ini:end].strip(" "))
        except ValueError:
            pass
    return mag if mag is not None else default_mag


def compute_tissue_mask(z_url, mag=40, scaled_mag=1.25, data_axes="XYZCT",
                        array_keys=None):
    root = zarrlib.open(z_url, mode="r")
    group0 = root["0"] if isinstance(root, zarrlib.Group) and "0" in root \
        else root

    if array_keys is None:
        array_keys = (list(group0.keys())
                      if isinstance(group0, zarrlib.Group) else [None])

    def yxc(arr):
        data = arr[...]
        if data.ndim > 3:
            axes = data_axes[-data.ndim:]
            perm = [axes.index(a) for a in "YXC" if a in axes]
            rest = [i for i in range(data.ndim) if i not in perm]
            data = np.transpose(data, perm + rest)
            while data.ndim > 3:
                data = data[..., 0]
        return data

    shapes = []
    for k in array_keys:
        arr = group0[k] if k is not None else group0
        axes = data_axes[-len(arr.shape):] if len(arr.shape) != len(
            data_axes) else data_axes
        h = arr.shape[axes.index("Y")] if "Y" in axes else arr.shape[0]
        w = arr.shape[axes.index("X")] if "X" in axes else arr.shape[1]
        shapes.append((h, w, k))

    H, W, _ = max(shapes)
    scaled_h = int(math.ceil(H * scaled_mag / mag))
    scaled_w = int(math.ceil(W * scaled_mag / mag))

    # closest pyramid level to the target scale
    _, _, _, key = min(((scaled_h - h) ** 2 + (scaled_w - w) ** 2, h, w, k)
                       for h, w, k in shapes)
    base = yxc(group0[key] if key is not None else group0)
    scaled = _downscale(base, scaled_h, scaled_w)
    return get_mask(scaled)


def mask_zarr(z_url, output_filename, scaled_mag=1.25, default_mag=40,
              data_axes="XYZCT", array_keys=None):
    mag = parse_magnification(z_url, default_mag)
    mask = compute_tissue_mask(z_url, mag=mag, scaled_mag=scaled_mag,
                               data_axes=data_axes, array_keys=array_keys)
    z_grp = zarrlib.Group.create(output_filename)
    arr = z_grp.create_dataset("masks/0/0", shape=mask.shape,
                               chunks=mask.shape, dtype=np.uint8,
                               compressor=Blosc(cname="zlib", clevel=9),
                               overwrite=True)
    arr[...] = mask.astype(np.uint8)
    arr.attrs.update({"scaled_mag": scaled_mag, "scale": scaled_mag / mag})
    return mask


def main(argv=None):
    parser = argparse.ArgumentParser("Compute tissue mask from zarr files")
    parser.add_argument("-i", "--input", dest="inputs", type=str, nargs="+")
    parser.add_argument("-o", "--output", dest="output_dir", type=str,
                        default=None)
    parser.add_argument("-da", "--data-axes", dest="data_axes", type=str,
                        default="XYZCT")
    parser.add_argument("-s", "--scale", dest="scaled_mag", type=float,
                        default=1.25)
    parser.add_argument("-ak", "--array-keys", dest="array_keys", type=str,
                        default=None, nargs="+")
    parser.add_argument("-dm", "--default-mag", dest="default_mag",
                        type=float, default=20)
    args = parser.parse_args(argv)

    fn_list = []
    for filename in args.inputs:
        if filename.lower().endswith(".txt"):
            with open(filename) as fp:
                fn_list += [fn.strip(" \n") for fn in fp.readlines()]
        elif os.path.isdir(filename) and not filename.lower().endswith(
                ".zarr"):
            fn_list += [os.path.join(filename, fn)
                        for fn in os.listdir(filename)
                        if fn.lower().endswith(".zarr")]
        elif filename.lower().endswith(".zarr"):
            fn_list.append(filename)

    for filename in fn_list:
        out = (os.path.join(args.output_dir, os.path.basename(filename))
               if args.output_dir else filename)
        mask_zarr(filename, out, scaled_mag=args.scaled_mag,
                  default_mag=args.default_mag, data_axes=args.data_axes,
                  array_keys=args.array_keys)
        print("Masked %s -> %s" % (filename, out))


if __name__ == "__main__":
    main()

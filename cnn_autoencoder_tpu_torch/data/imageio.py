"""Image/array IO helpers: ROI syntax, axes normalization, format routing.

The port's copy of the JAX package's ``data/imageio.py`` (``parse_roi``,
``map_axes_order``, ``image2array``, ``array_to_image``).  PIL is imported
only where an image file is read or written, so zarr sources and outputs
work on a machine without PIL.  ``image2array`` takes the device that the
codecs of an opened store build on (``None``: the card).
"""

import os
import re
from typing import List

import numpy as np


def parse_roi(filename: str, source_format: str):
    """Split ``path;(start,...):(length,...)`` into (path, [slices]).

    Lengths of -1 mean "to the end".  Multiple ROIs may be separated by
    additional ';'-groups.  Returns (path, list_of_slice_tuples).
    """
    if ";" not in filename:
        return filename, []
    parts = filename.split(";")
    fn = parts[0]
    rois = []
    pattern = re.compile(r"\(([-\d\s,]+)\):\(([-\d\s,]+)\)")
    for spec in parts[1:]:
        m = pattern.match(spec.strip())
        if m is None:
            raise ValueError(f"Malformed ROI spec {spec!r} in {filename!r}")
        starts = [int(v) for v in m.group(1).split(",")]
        lengths = [int(v) for v in m.group(2).split(",")]
        sl = tuple(slice(s, None if l == -1 else s + l)
                   for s, l in zip(starts, lengths))
        rois.append(sl)
    return fn, rois


def map_axes_order(source_axes: str, target_axes: str) -> List[int]:
    """Permutation that transposes ``source_axes`` data into target order.

    Axes present in source but not in target keep relative order and go
    first (the ``rem_axes + 'YXC'`` order of the pipeline).
    """
    perm = [i for i, a in enumerate(source_axes) if a not in target_axes]
    for a in target_axes:
        if a in source_axes:
            perm.append(source_axes.index(a))
    return perm


def image2array(filename: str, source_format: str = ".zarr",
                data_group: str = "0/0", device=None, **_):
    """Open an image source as an array-like with ``shape``/``dtype`` and
    numpy-style slicing.

    zarr sources (local, s3:// or http(s)://) return the lazy, chunk-backed
    store Array, whose codec builds on ``device``; PIL-readable files return
    an in-memory HWC uint8 numpy array.
    """
    from .remote import is_remote
    remote = is_remote(filename)
    if ".zarr" in source_format or filename.rstrip("/").endswith(".zarr") \
            or (remote and ".zarr" in filename) or os.path.isdir(filename):
        from ..storage import zarr as zarrlib
        node = zarrlib.open(filename, mode="r", device=device)
        if isinstance(node, zarrlib.Group):
            if data_group and data_group in node:
                return node[data_group]
            raise KeyError(f"Group {data_group!r} not found in {filename}")
        return node

    from PIL import Image
    if remote:
        import io

        from .remote import fetch_remote
        with Image.open(io.BytesIO(fetch_remote(filename))) as im:
            return np.asarray(im.convert("RGB"))
    with Image.open(filename) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr


def array_to_image(arr: np.ndarray, filename: str, **save_kwargs):
    from PIL import Image
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    parent = os.path.dirname(os.path.abspath(filename))
    os.makedirs(parent, exist_ok=True)
    Image.fromarray(arr).save(filename, **save_kwargs)

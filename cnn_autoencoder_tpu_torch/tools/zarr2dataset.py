"""Split stacked zarr arrays into per-image zarr files (input + label
groups): the port of the JAX package's ``scripts/zarr2dataset.py``.

    python -m cnn_autoencoder_tpu_torch.tools.zarr2dataset -i inputs.zarr \
        -l labels.zarr -o out_dir

A big ``(..., N)`` input stack and label stack become per-image files
``%04d.zarr`` with groups ``0/0`` (input) and ``1/0`` (label), chunks
byte-equal to the JAX tool's.
"""

import argparse
import os

import numpy as np

from ..storage import zarr as zarrlib
from ..storage.codecs import Blosc


def save_group(fn, z, label, dst_dir):
    dst_fn = os.path.join(dst_dir, fn)
    group = zarrlib.Group.create(dst_fn, overwrite=True)
    comp = Blosc(cname="zlib", clevel=5)

    arr = group.create_dataset("0/0", shape=z.shape, chunks=z.shape,
                               dtype=np.uint8, compressor=comp,
                               overwrite=True)
    arr[...] = z.astype(np.uint8)
    lbl = group.create_dataset("1/0", shape=label.shape, chunks=label.shape,
                               dtype=np.uint8, compressor=None,
                               overwrite=True)
    lbl[...] = label.astype(np.uint8)


def convert(inputs_fn, labels_fn, dst_dir):
    z_inputs = zarrlib.open(inputs_fn, mode="r")
    z_labels = zarrlib.open(labels_fn, mode="r")
    os.makedirs(dst_dir, exist_ok=True)
    n = z_inputs.shape[-1]
    for i in range(n):
        save_group("%04d.zarr" % i,
                   np.moveaxis(z_inputs[..., i], -1, 0),
                   np.moveaxis(z_labels[..., i], -1, 0), dst_dir)
    print("Wrote %d per-image zarr files to %s" % (n, dst_dir))


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Convert stacked zarr arrays into a dataset of independent zarr "
        "files")
    parser.add_argument("-i", "--input", type=str, dest="inputs_fn")
    parser.add_argument("-l", "--label", type=str, dest="labels_fn")
    parser.add_argument("-o", "--out-dir", type=str, dest="dst_dir")
    args = parser.parse_args(argv)
    convert(args.inputs_fn, args.labels_fn, args.dst_dir)


if __name__ == "__main__":
    main()

"""Write labeled tissue masks (``masks/1/0``) next to computed masks: the
port of the JAX package's ``scripts/compute_labels.py``.

    python -m cnn_autoencoder_tpu_torch.tools.compute_labels \
        -i slide.zarr::3 [-o out_dir]

Input filenames carry a ``::<label>`` suffix; the existing ``masks/0/0`` is
multiplied by the label and stored as ``masks/1/0`` (+ the label value at
``masks/1/1``), chunks byte-equal to the JAX tool's.
"""

import argparse
import os

import numpy as np

from ..storage import zarr as zarrlib
from ..storage.codecs import Blosc


def label_zarr(z_url, label, output_filename):
    root = zarrlib.open(z_url, mode="r")
    mask = root["masks/0/0"][...]
    labeled = (mask * label).astype(np.int64)

    comp = Blosc(cname="zlib", clevel=9)
    z_grp = zarrlib.Group.create(output_filename)
    arr = z_grp.create_dataset("masks/1/0", shape=labeled.shape,
                               chunks=labeled.shape, dtype=np.int64,
                               compressor=comp, overwrite=True)
    arr[...] = labeled
    lbl = z_grp.create_dataset("masks/1/1", shape=(1,), chunks=(1,),
                               dtype=np.int64, compressor=comp,
                               overwrite=True)
    lbl[...] = np.asarray([label], np.int64)
    z_grp["masks/1"].attrs.update({"label": label})


def main(argv=None):
    parser = argparse.ArgumentParser("Label tissue masks in zarr files")
    parser.add_argument("-i", "--input", dest="inputs", type=str, nargs="+",
                        help="zarr file + '::<label>' suffix")
    parser.add_argument("-o", "--output", dest="output_dir", type=str,
                        default=None)
    args = parser.parse_args(argv)

    fn_list = []
    for filename in args.inputs:
        if filename.lower().endswith(".txt"):
            with open(filename) as fp:
                fn_list += [fn.strip(" \n") for fn in fp.readlines()]
        elif os.path.isdir(filename) and ".zarr" not in filename.lower():
            fn_list += [os.path.join(filename, fn)
                        for fn in os.listdir(filename)
                        if ".zarr" in fn.lower()]
        elif ".zarr" in filename.lower():
            fn_list.append(filename)

    for filename in fn_list:
        filename, label = filename.split("::")
        out = (os.path.join(args.output_dir, os.path.basename(filename))
               if args.output_dir else filename)
        label_zarr(filename, int(label), out)
        print("Labeled %s -> %s (label %s)" % (filename, out, label))


if __name__ == "__main__":
    main()

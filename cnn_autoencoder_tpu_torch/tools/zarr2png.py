"""Export segmentation label groups from zarr files to PNG: the port of
the JAX package's ``scripts/zarr2png.py``.

    python -m cnn_autoencoder_tpu_torch.tools.zarr2png -d src_dir \
        -o out_dir -s SEED [SEED ...]

Writes each store's ``labels/segmentation_<seed>/0/0`` group, scaled by 255,
as ``<name>_<seed>.png`` under ``out_dir/<seed>``.  PIL is imported at
first use.
"""

import argparse
import os

import numpy as np

from ..storage import zarr as zarrlib


def zarr2png(in_fn, src_dir, out_dir, seed, group):
    from PIL import Image
    z = zarrlib.open(os.path.join(src_dir, in_fn), mode="r")
    seg = z[group][...]
    while seg.ndim > 2:
        seg = seg[0]
    seg = (seg * 255.0).astype(np.uint8)
    fn = in_fn.split(".zarr")[0]
    Image.fromarray(seg).save(os.path.join(out_dir, fn + "_%s.png" % seed))


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Convert images from zarr to png format")
    parser.add_argument("-d", "--src-dir", dest="src_dir", type=str)
    parser.add_argument("-o", "--out-dir", dest="out_dir", type=str)
    parser.add_argument("-s", "--seed", dest="seeds", nargs="+", type=str)
    args = parser.parse_args(argv)

    for seed in args.seeds:
        in_fns = [fn for fn in os.listdir(args.src_dir) if ".zarr" in fn]
        out_dir = os.path.join(args.out_dir, seed)
        os.makedirs(out_dir, exist_ok=True)
        for in_fn in in_fns:
            group = "labels/segmentation_%s/0/0" % seed
            zarr2png(in_fn, src_dir=args.src_dir, out_dir=out_dir,
                     group=group, seed=seed)
            print("Converted %s -> %s" % (in_fn, out_dir))


if __name__ == "__main__":
    main()

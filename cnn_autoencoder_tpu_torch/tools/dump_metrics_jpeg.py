"""Dump ``metrics_stats_*.pth`` files into CSV (overall + per-image): the
port of the JAX package's ``scripts/dump_metrics_jpeg.py``.

    python -m cnn_autoencoder_tpu_torch.tools.dump_metrics_jpeg -d logs \
        -m JPEG -o metrics.csv [-fm a]

Reads the stats files of ``tools/compute_metrics.py`` and of the RD harness
(``cli/test_cae.py``; method ``CAE``) and writes the JAX tool's two CSVs,
``<out>`` and ``<out>_per_img``, character for character.
"""

import argparse
import os
from itertools import product

import torch

stat_keys = ["avg", "std"]


def dump_metrics(metrics_filename, out_filename, mode="w"):
    basename, extension = os.path.splitext(out_filename)
    out_filename_per_img = basename + "_per_img" + extension
    out_file_exists = os.path.isfile(out_filename)

    metrics = torch.load(metrics_filename, weights_only=False)
    metric_keys = list(metrics.keys())
    metric_keys.remove("codec")

    codec = metrics["codec"]
    if codec == "CAE":
        identifier = metrics["seed"]
        metric_keys.remove("seed")
    else:
        identifier = metrics["quality"]
        metric_keys.remove("quality")

    metric_keys = [k for k in metric_keys if "stats" not in k]

    with open(out_filename, mode) as o_f, \
            open(out_filename_per_img, mode) as o_i_f:
        if "w" in mode or ("a" in mode and not out_file_exists):
            o_f.write("Method,quality")
            for k, s in product(metric_keys, stat_keys):
                o_f.write(",%s_%s" % (k, s))
            o_f.write("\n")
            o_i_f.write("Method,quality,id")
            for k in metric_keys:
                o_i_f.write(",%s" % k)
            o_i_f.write("\n")

        o_f.write("%s,%s" % (codec, identifier))
        for k, s in product(metric_keys, stat_keys):
            o_f.write(",%f" % metrics["%s_stats" % k][s])
        o_f.write("\n")

        for i in range(len(metrics[metric_keys[0]])):
            o_i_f.write("%s,%s,%i" % (codec, identifier, i))
            for k in metric_keys:
                o_i_f.write(",%f" % metrics[k][i])
            o_i_f.write("\n")


def main(argv=None):
    parser = argparse.ArgumentParser("Dump metrics")
    parser.add_argument("-d", "--dir", type=str, dest="root_dir")
    parser.add_argument("-m", "--method", type=str, dest="method",
                        help="Method used to compute metrics (JPEG, PNG, "
                             "CAE)")
    parser.add_argument("-o", "--out-file", type=str, dest="out_filename")
    parser.add_argument("-fm", "--file-mode", type=str, dest="file_mode",
                        default="w")
    args = parser.parse_args(argv)

    mode = args.file_mode
    for fn in sorted(os.listdir(args.root_dir)):
        if "_%s_" % args.method not in fn or not fn.endswith(".pth"):
            continue
        dump_metrics(os.path.join(args.root_dir, fn), args.out_filename,
                     mode)
        mode = "a"
        print("Dumped", fn)


if __name__ == "__main__":
    main()

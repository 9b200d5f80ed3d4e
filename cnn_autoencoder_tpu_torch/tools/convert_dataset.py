"""Batch-convert images across formats at quality sweeps (0-100): the
port of the JAX package's ``scripts/convert_dataset.py``.

    python -m cnn_autoencoder_tpu_torch.tools.convert_dataset -sd src \
        -dd dst -sf PNG -df JPEG

PIL does the work and is imported at first use.
"""

import argparse
import os

format_dict = {"JPEG2000": "jp2", "JPEG": "jpeg", "PNG": "png"}


def convert(src_filename, dst_filename, file_format, **kwargs):
    from PIL import Image
    with Image.open(src_filename) as im:
        im.save(dst_filename, format=file_format, **kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Convert images to a different image format")
    parser.add_argument("-sd", "--src-dir", type=str, dest="src_dir",
                        default=".")
    parser.add_argument("-dd", "--dst-dir", type=str, dest="dst_dir",
                        default=".")
    parser.add_argument("-sf", "--src-format", type=str, dest="src_format")
    parser.add_argument("-df", "--dst-format", type=str, dest="dst_format",
                        choices=list(format_dict.keys()))
    args = parser.parse_args(argv)

    in_filenames = [".".join(fn.split(".")[:-1])
                    for fn in os.listdir(args.src_dir)
                    if fn.lower().endswith(format_dict[args.src_format])]

    os.makedirs(args.dst_dir, exist_ok=True)
    for in_fn in in_filenames:
        for iq in range(0, 101, 10):
            if "JPEG" in args.dst_format:
                quality_opts = {"quality": iq}
            elif "PNG" in args.dst_format:
                quality_opts = {"compress_level": 9 - iq // 10,
                                "optimize": False}
                if iq == 100:
                    break
            else:
                quality_opts = {}
            out_fn = os.path.join(
                args.dst_dir,
                "%s_%03d.%s" % (in_fn, iq, format_dict[args.dst_format]))
            convert(os.path.join(args.src_dir,
                                 in_fn + ".%s"
                                 % format_dict[args.src_format]),
                    out_fn, args.dst_format, **quality_opts)
            print("Converted", in_fn, "->", out_fn)


if __name__ == "__main__":
    main()

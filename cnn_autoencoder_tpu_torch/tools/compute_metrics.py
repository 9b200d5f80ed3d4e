"""Classical-codec RD sweep (JPEG / PNG baselines): the port of the JAX
package's ``scripts/compute_metrics.py``.

    python -m cnn_autoencoder_tpu_torch.tools.compute_metrics -sd src \
        -dd tmp -sf png -df JPEG -cq 80 -ld logs [-li _id] \
        [--device cpu]

Compresses every source image at a given quality, computes RMSE, MS-SSIM,
SSIM, PSNR and delta-E with bpp from the stored file size, and saves
``metrics_stats_{codec}_{q:03d}{id}.pth`` in the same ``torch.save`` schema
as the CAE harness, so codec-vs-CAE RD curves stay comparable.  The image
metrics run in torch on ``device`` (None: the card): RMSE, SSIM, PSNR and
delta-E in float64 (``utils/metrics.py``), MS-SSIM in float32
(``ops/msssim.py``; NaN where the image is too small for its five levels).
``metrics_arrays`` takes the pixels as arrays; only ``metrics_image`` and
``main`` read and write image files, through PIL imported at first use.
"""

import argparse
import os
from time import perf_counter

import numpy as np
import torch

from ..ops.msssim import ms_ssim
from ..utils.device import resolve_device
from ..utils.metrics import (compute_delta_cielab, compute_psnr,
                             compute_rmse, structural_similarity)

format_dict = {"JPEG": "jpeg", "PNG": "png"}


def compute_ms_ssim(x, x_r):
    try:
        return float(ms_ssim(x_r.float()[None], x.float()[None],
                             data_range=255))
    except AssertionError:
        return float("nan")


metric_fun = {
    "dist": compute_rmse,
    "ms-ssim": compute_ms_ssim,
    "ssim": lambda x, x_r: structural_similarity(x, x_r, channel_axis=2),
    "psnr": compute_psnr,
    "delta_cielab": compute_delta_cielab,
}


def compute_rate(img, comp_size):
    return 8 * float(comp_size) / np.prod(img.shape[:-1])


def metrics_arrays(img_arr, comp_arr, comp_size, device=None):
    """The metrics of one (H, W, 3) source and its decoded copy, the copy
    stored in ``comp_size`` bytes."""
    dev = resolve_device(device)
    metrics = {"rate": compute_rate(img_arr, comp_size)}
    x = torch.from_numpy(np.asarray(img_arr, np.float64)).to(dev)
    x_r = torch.from_numpy(np.asarray(comp_arr, np.float64)).to(dev)
    for m_k, fun in metric_fun.items():
        metrics[m_k] = fun(x, x_r)
    return metrics


def metrics_image(src_fn, comp_fn, device=None):
    from PIL import Image
    with Image.open(src_fn) as im:
        img_arr = np.asarray(im.convert("RGB"))
    comp_size = os.path.getsize(comp_fn)
    with Image.open(comp_fn) as im:
        comp_arr = np.asarray(im.convert("RGB"))
    return metrics_arrays(img_arr, comp_arr, comp_size, device)


def save_metrics_stats(all_metrics, log_dir, codec, quality, identifier=""):
    """Write ``all_metrics`` ({metric: per-image list}) with each metric's
    NaN-aware avg, std, med, min and max under ``<metric>_stats``, the codec
    and the quality, the schema the JAX tool saves, to
    ``metrics_stats_{codec}_{quality:03d}{identifier}.pth``."""
    all_metrics = dict(all_metrics)
    all_metrics_stats = {}
    for m_k, vals in all_metrics.items():
        all_metrics_stats[m_k + "_stats"] = dict(
            avg=float(np.nanmean(vals)), std=float(np.nanstd(vals)),
            med=float(np.nanmedian(vals)), min=float(np.nanmin(vals)),
            max=float(np.nanmax(vals)))
    all_metrics.update(all_metrics_stats)
    all_metrics["codec"] = codec
    all_metrics["quality"] = quality
    torch.save(all_metrics, os.path.join(
        log_dir, "metrics_stats_%s_%03d%s.pth" % (codec, quality,
                                                  identifier)))


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        "Compute compression performance metrics between a compressed "
        "image and the original one")
    parser.add_argument("-sd", "--src-dir", type=str, dest="src_dir",
                        default=".")
    parser.add_argument("-dd", "--dst-dir", type=str, dest="dst_dir",
                        default=".")
    parser.add_argument("-sf", "--src-format", type=str, dest="src_format")
    parser.add_argument("-df", "--dst-format", type=str, dest="dst_format",
                        choices=list(format_dict.keys()))
    parser.add_argument("-ld", "--log-dir", type=str, dest="log_dir",
                        default=".")
    parser.add_argument("-cq", "--comp-quality", type=int,
                        dest="comp_quality", default=100)
    parser.add_argument("-li", "--log-id", type=str, dest="log_identifier",
                        default="")
    parser.add_argument("--device", type=str, dest="device", default=None,
                        help="where the metrics run (default: the card)")
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    # case/dot-insensitive source format; '.jpg' files match 'jpeg'
    key = args.src_format.lower().lstrip(".")
    src_exts = {"jpeg": (".jpeg", ".jpg"), "jpg": (".jpeg", ".jpg"),
                "png": (".png",)}.get(key)
    if src_exts is None:
        parser.error("unsupported --src-format %r (jpeg/jpg/png)"
                     % args.src_format)
    in_filenames = [fn for fn in os.listdir(args.src_dir)
                    if fn.lower().endswith(src_exts)]

    if "JPEG" in args.dst_format:
        quality_opts = {"quality": args.comp_quality}
    else:
        quality_opts = {"compress_level": 9 - args.comp_quality // 10,
                        "optimize": False}

    from PIL import Image
    all_metrics = {"time": []}
    os.makedirs(args.dst_dir, exist_ok=True)
    for in_fn in in_filenames:
        src_fn = os.path.join(args.src_dir, in_fn)
        comp_fn = os.path.join(args.dst_dir,
                               "temp.%s" % format_dict[args.dst_format])

        e_time = perf_counter()
        with Image.open(src_fn) as im:
            im.save(comp_fn, format=args.dst_format, **quality_opts)
        e_time = perf_counter() - e_time

        scores = metrics_image(src_fn, comp_fn, dev)
        for m_k, v in scores.items():
            all_metrics.setdefault(m_k, []).append(
                v if v > 0.0 else np.nan)
        all_metrics["time"].append(e_time)
        os.remove(comp_fn)

    save_metrics_stats(all_metrics, args.log_dir, args.dst_format,
                       args.comp_quality, args.log_identifier)
    print("Saved metrics for %s at quality %d" % (args.dst_format,
                                                  args.comp_quality))


if __name__ == "__main__":
    main()

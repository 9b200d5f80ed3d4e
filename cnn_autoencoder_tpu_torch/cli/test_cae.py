"""RD evaluation harness: the port of the JAX package's ``cli/test_cae.py``.

    python -m cnn_autoencoder_tpu_torch.cli.test_cae -dd slide.zarr \
        -if zarr -dg 0/0 -da YXC -chk checkpoint.msgpack -ps 512 \
        -o tmp.zarr -ld logs

Per input image: a timed compress -> decompress round trip through the
port's ``cli/compress.py:compress_image`` (``codec="CAE"``, one
``CAECodecCore`` built once for all inputs) and
``cli/decompress.py:decompress_image``, then RMSE, bpp (8 x the stored
bytes over the pixels), SSIM, MS-SSIM (``ops/msssim.py``; NaN where the
image is too small for five levels), PSNR and the mean CIE76 delta-E, each
timed.  The image metrics run in float64 on the device (``utils/metrics.py``).
A negative score is stored as NaN.  The aggregates (avg, std, med, min, max,
NaN-aware) go to ``metrics_stats_{seed}_CAE_{id}.pth`` with ``torch.save``
in the JAX harness's schema.  The codec core serves at the port's default
precision (``CAE_TPU_PRECISION`` / ``ops/convops.py:set_default_precision``:
float32 or bf16), as the compress CLI's does.  ``test_cae`` and
``test_image`` take ``device`` (None: the card).
"""

import logging
import os
from time import perf_counter

import numpy as np
import torch

from ..data.datautils import get_filenames
from ..models.factory import autoencoder_from_state_dict
from ..ops.msssim import ms_ssim
from ..storage import zarr as zarrlib
from ..storage.cae_codec import CAECodecCore
from ..utils import loggers
from ..utils.args import get_args
from ..utils.device import resolve_device
from ..utils.metrics import (compute_delta_cielab, compute_psnr, compute_rmse,
                             structural_similarity)
from .compress import _load_yxc, compress_image
from .decompress import decompress_image


def compute_ms_ssim(x=None, x_r=None, **kwargs):
    try:
        val = ms_ssim(x_r.float()[None], x.float()[None], data_range=255)
    except AssertionError:
        # too small for the 5-level pyramid: a missing metric, not an abort
        return float("nan"), None
    return float(val), None


def compute_rate(x=None, y_q_ptr=None, **kwargs):
    return 8 * float(y_q_ptr.nbytes_stored) / float(np.prod(x.shape[:-1])), \
        None


METRIC_FUN = {
    "dist": lambda x=None, x_r=None, **kw: (compute_rmse(x, x_r), None),
    "rate": compute_rate,
    "ms-ssim": compute_ms_ssim,
    "ssim": lambda x=None, x_r=None, **kw: (
        structural_similarity(x, x_r, channel_axis=2), None),
    "psnr": lambda x=None, x_r=None, **kw: (compute_psnr(x, x_r), None),
    "delta_cielab": lambda x=None, x_r=None, **kw: (
        compute_delta_cielab(x, x_r), None),
}


def test_image(checkpoint, input_filename, patch_size=512,
               source_format="zarr", data_group="0/0", data_axes="TCZYX",
               gpu=False, progress_bar=False,
               temp_output_filename="./temp.zarr", core=None, device=None):
    """One image's round trip and metrics ``{metric, metric_time,
    execution_time, evaluation_time}`` (JAX ``cli/test_cae.py:62``), with
    the round trip's two stages, ``compress_time`` and
    ``decompress_time``, beside them."""
    del gpu  # the device is ``device``
    dev = resolve_device(device)
    if not data_group:
        data_group = "0/0"

    start = perf_counter()
    compress_image(codec="CAE", checkpoint=checkpoint,
                   input_filename=input_filename,
                   output_filename=temp_output_filename,
                   patch_size=patch_size, source_format=source_format,
                   data_group=data_group, data_axes=data_axes,
                   progress_bar=progress_bar, core=core, device=dev)
    mid = perf_counter()
    decompress_image(input_filename=temp_output_filename,
                     output_filename=temp_output_filename,
                     destination_format="zarr", data_group=data_group,
                     decomp_group="decompressed",
                     progress_bar=progress_bar, device=dev)
    end = perf_counter()

    _, x = _load_yxc(input_filename, source_format, data_group, data_axes,
                     dev)
    z = zarrlib.open(temp_output_filename, mode="r", device=dev)
    comp_pyr = "/".join(("decompressed/" + data_group).split("/")[:-1])
    x_r = z[comp_pyr + "/0"][...]

    x = torch.from_numpy(np.squeeze(x).astype(np.float64)).to(dev)
    x_r = torch.from_numpy(np.squeeze(x_r).astype(np.float64)).to(dev)

    all_metrics = {}
    all_extra = {}
    eval_time = perf_counter()
    for m_k, fun in METRIC_FUN.items():
        t0 = perf_counter()
        score, extra = fun(x=x, x_r=x_r, y_q_ptr=z[data_group])
        all_metrics[m_k + "_time"] = perf_counter() - t0
        if extra is not None:
            all_extra.update(extra)
        all_metrics[m_k] = score if score >= 0.0 else np.nan  # nan stays nan
    eval_time = perf_counter() - eval_time

    all_metrics["execution_time"] = end - start
    all_metrics["compress_time"] = mid - start
    all_metrics["decompress_time"] = end - mid
    all_metrics["evaluation_time"] = eval_time
    all_metrics.update(all_extra)
    return all_metrics


def test_cae(args, device=None):
    """RD evaluation over every input (JAX ``cli/test_cae.py:109``);
    returns the stats dict it saves and ``test_image``'s dict of each
    input."""
    logger = logging.getLogger(args.mode + "_log")
    dev = resolve_device(device)

    input_fn_list = get_filenames(args.data_dir, args.source_format,
                                  data_mode="all")

    all_metrics_stats = {m_k: [] for m_k in METRIC_FUN}
    all_metrics_stats["execution_time"] = []
    all_metrics_stats["evaluation_time"] = []

    output_dir = args.output_dir
    if isinstance(output_dir, list):
        output_dir = output_dir[0]
    if not output_dir.lower().endswith(".zarr"):
        output_dir += ".zarr"

    per_image = []
    core = None
    if args.checkpoint:
        core = CAECodecCore(
            autoencoder_from_state_dict(args.checkpoint, device=dev),
            device=dev)

    for i, in_fn in enumerate(input_fn_list):
        all_metrics = test_image(
            checkpoint=args.checkpoint, input_filename=in_fn,
            patch_size=args.patch_size, source_format=args.source_format,
            data_axes=args.data_axes, data_group=args.data_group,
            temp_output_filename=output_dir, core=core, device=dev)
        per_image.append(all_metrics)

        avg_str = ""
        for m_k in all_metrics_stats:
            all_metrics_stats[m_k].append(all_metrics[m_k])
            avg_str += "%s=%0.5f " % (m_k, np.nanmean(all_metrics[m_k]))
        logger.debug("\t[{:05d}/{:05d}] Test metrics {}".format(
            i + 1, len(input_fn_list), avg_str))

    for m_k in list(all_metrics_stats.keys()):
        vals = all_metrics_stats[m_k]
        all_metrics_stats[m_k + "_stats"] = dict(
            avg=float(np.nanmean(vals)), std=float(np.nanstd(vals)),
            med=float(np.nanmedian(vals)), min=float(np.nanmin(vals)),
            max=float(np.nanmax(vals)))
        logger.debug("==== Test metrics %s=%0.4f (+-%0.4f)"
                     % (m_k, np.nanmean(vals), np.nanstd(vals)))

    all_metrics_stats["codec"] = "CAE"
    all_metrics_stats["seed"] = args.seed

    # the reference's dump / compare scripts read this file
    torch.save(all_metrics_stats,
               os.path.join(args.log_dir, "metrics_stats_%s_CAE_%s.pth"
                            % (args.seed, args.log_identifier)))
    return all_metrics_stats, per_image


def cli():
    """Entry point of ``python -m cnn_autoencoder_tpu_torch.cli.test_cae``:
    parse argv and evaluate on the card."""
    args = get_args(task="autoencoder", mode="test")
    loggers.setup_logger(args)
    test_cae(args)
    logging.shutdown()


if __name__ == "__main__":
    cli()

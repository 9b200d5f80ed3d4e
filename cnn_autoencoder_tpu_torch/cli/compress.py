"""Compression entry point: the port of the JAX package's ``cli/compress.py``.

    python -m cnn_autoencoder_tpu_torch.cli.compress -dd slide.zarr \
        -o out.zarr -cod CAETPU -chk checkpoint.msgpack -ps 512 -da YXC

The same flag surface (``-dd`` inputs, ``-o`` output, ``-cod CAETPU|CAE|
Blosc|Jpeg|Jpeg2k|None``, ``-sbn`` bottleneck store, ``--add-offset`` halo,
``-ps`` patch size, data axes and ROI handling) and the same stores.  The
CAE codecs run the batched tile pipeline (``pipeline/tiles.py``) on the
card; ``compress_image`` and ``compress`` take ``device`` (``None``: the
card; tests pass ``"cpu"``).  PNG and other PIL inputs need PIL.  The
pixel upload of the CAE codecs crosses the link coded with
``CAE_TPU_CODED_UPLOAD=1`` (``auto``, the default, codes it only on a link
under ``CAE_TPU_PACKED_THRESHOLD_MBPS``): environment variables, as in the
JAX CLI, with no flag.  On the card (``device=None``) the CAE cores serve
over ``parallel/mesh.py:serving_mesh()``: with more than one visible card
every batch shards over all of them, one contiguous shard a card (off
with ``CAE_TPU_SERVE_MESH=0``; a core given a ``(data, model)`` mesh
serves each data shard on the first device of its model group, as the
JAX cores replicate over ``model``).  ``cli()`` joins a multi-process start
(``parallel/distributed.py:initialize_multihost``); only rank 0 writes
the store, the other ranks log and exit, as the JAX CLI's do.
"""

import logging
import os

import numpy as np

from ..data.datautils import get_filenames
from ..data.imageio import image2array, parse_roi
from ..models.factory import autoencoder_from_state_dict
from ..parallel.distributed import initialize_multihost, is_primary
from ..parallel.mesh import serving_mesh
from ..pipeline.tiles import (compress_pixels_to_bottleneck,
                              compress_pixels_to_cae,
                              compress_pixels_to_cae_turbo,
                              copy_sidecar_metadata, normalize_to_yxc)
from ..storage import zarr as zarrlib
from ..storage.cae_codec import CAECodecCore
from ..storage.codecs import Blosc
from ..storage.image_codecs import Jpeg, Jpeg2k
from ..storage.turbo_codec import CAETurboCore
from ..utils import loggers
from ..utils.args import get_args

LOGGER_NAME = "inference_log"


def core_mesh(device):
    """The serving mesh of a core built on ``device``: every visible card
    for the card (``None``), else none."""
    return serving_mesh() if device is None else None


def _load_yxc(input_filename, source_format, data_group, data_axes, device):
    fn, rois = parse_roi(input_filename, source_format)
    z = image2array(fn, source_format, data_group, device=device)
    roi = rois[0] if rois else None
    arr = normalize_to_yxc(z, data_axes=data_axes, roi=roi)
    return fn, np.ascontiguousarray(arr)


def compress_image(codec, checkpoint, input_filename, output_filename,
                   patch_size=512, source_format="zarr", data_group="0/0",
                   data_axes="TCZYX", progress_bar=False,
                   save_as_bottleneck=False, gpu=False, core=None,
                   batch_tiles=None, add_offset=False, device=None):
    """Compress one image into a zarr store (JAX ``cli/compress.py:37``).
    ``core`` reuses a built ``CAETurboCore`` (``CAETPU``) or
    ``CAECodecCore`` (``CAE``); else one is built from ``checkpoint`` on
    ``device``."""
    del gpu  # the device is ``device``
    logger = logging.getLogger(LOGGER_NAME)
    fn, src = _load_yxc(input_filename, source_format, data_group,
                        data_axes, device)
    if src.dtype != np.uint8:
        src = np.clip(src, 0, 255).astype(np.uint8)
    if not data_group:
        data_group = "0/0"
    checkpoint_id = checkpoint if isinstance(checkpoint, str) else None

    if codec == "CAETPU":
        if not isinstance(core, CAETurboCore):
            core = CAETurboCore(
                autoencoder_from_state_dict(checkpoint, device=device),
                device=device, mesh=core_mesh(device))
        compress_pixels_to_cae_turbo(
            core, src, output_filename, data_group=data_group,
            patch_size=patch_size, batch_tiles=batch_tiles,
            checkpoint_id=checkpoint_id, progress_bar=progress_bar)
    elif "CAE" in codec:
        if core is None:
            core = CAECodecCore(
                autoencoder_from_state_dict(checkpoint, device=device),
                device=device, mesh=core_mesh(device))
        if save_as_bottleneck:
            compress_pixels_to_bottleneck(
                core, src, output_filename, data_group=data_group,
                patch_size=patch_size, batch_tiles=batch_tiles,
                progress_bar=progress_bar)
        else:
            # halo = one decoder receptive field's worth of context
            offset = 2 ** core.level if add_offset else 0
            compress_pixels_to_cae(
                core, src, output_filename, data_group=data_group,
                patch_size=patch_size, batch_tiles=batch_tiles,
                checkpoint_id=checkpoint_id, offset=offset,
                progress_bar=progress_bar)
    else:
        if "Blosc" in codec:
            compressor = Blosc(clevel=9)
        elif "Jpeg2k" in codec:
            compressor = Jpeg2k(level=90)
        elif "Jpeg" in codec:
            compressor = Jpeg(level=90)
        elif "None" in codec:
            compressor = None
        else:
            raise ValueError("Codec %s not supported" % codec)
        h, w, c = src.shape
        p = min(patch_size, max(h, w))
        root = zarrlib.Group.create(output_filename, device=device)
        arr = root.create_dataset(data_group, shape=src.shape,
                                  chunks=(p, p, c), dtype=np.uint8,
                                  compressor=compressor, overwrite=True)
        arr[...] = src

    if os.path.isdir(fn):
        copy_sidecar_metadata(fn, output_filename)
    logger.info("Compressed image %s into %s" % (input_filename,
                                                 output_filename))
    return output_filename


def compress(args, device=None):
    """Compress every input file (JAX ``cli/compress.py:107``)."""
    if not args.source_format.startswith("."):
        args.source_format = "." + args.source_format

    input_fn_list = get_filenames(args.data_dir, args.source_format,
                                  data_mode="all")
    output_dir = (args.output_dir if isinstance(args.output_dir, list)
                  else [args.output_dir])

    if ".zarr" not in output_dir[0].lower():
        output_fn_list = []
        for fn in input_fn_list:
            base = fn[:fn.lower().find(args.source_format)]
            base = base.replace("\\", "/").split("/")[-1]
            output_fn_list.append(os.path.join(output_dir[0],
                                               "%s.zarr" % base))
    else:
        output_fn_list = output_dir
        if len(output_fn_list) < len(input_fn_list):
            raise ValueError(
                f"{len(input_fn_list)} inputs but only "
                f"{len(output_fn_list)} explicit .zarr output path(s); "
                "pass a directory as -o to derive one output per input")

    core = None
    if args.codec == "CAETPU" and args.checkpoint:
        core = CAETurboCore(
            autoencoder_from_state_dict(args.checkpoint, device=device),
            device=device, mesh=core_mesh(device))
    elif "CAE" in args.codec and args.checkpoint:
        core = CAECodecCore(
            autoencoder_from_state_dict(args.checkpoint, device=device),
            device=device, mesh=core_mesh(device))

    for in_fn, out_fn in zip(input_fn_list, output_fn_list):
        compress_image(codec=args.codec, checkpoint=args.checkpoint,
                       input_filename=in_fn, output_filename=out_fn,
                       patch_size=args.patch_size,
                       source_format=args.source_format,
                       data_axes=args.data_axes, data_group=args.data_group,
                       progress_bar=args.progress_bar,
                       save_as_bottleneck=args.save_as_bottleneck,
                       core=core, add_offset=getattr(args, "add_offset",
                                                     False),
                       device=device)


def cli():
    """Entry point of ``python -m cnn_autoencoder_tpu_torch.cli.compress``:
    parse argv and compress on the card."""
    args = get_args(task="encoder", mode="inference")
    initialize_multihost()
    loggers.setup_logger(args)
    if is_primary():
        compress(args)
    else:
        # one store, one writer: a second process would race its chunks
        logging.getLogger(LOGGER_NAME).info(
            "secondary process: store writes are rank 0's; exiting")
    logging.shutdown()


if __name__ == "__main__":
    cli()

"""Decompression entry point: the port of the JAX package's
``cli/decompress.py``.

    python -m cnn_autoencoder_tpu_torch.cli.decompress -dd out.zarr \
        -o rec.zarr -of zarr -dg 0/0

Reads a compressed zarr store ('cae' or 'cae_tpu' coded pixels, which
decode themselves, 'cae_bn' latents when a checkpoint is given, or a raw /
general-codec array), reconstructs through the batched decode pipeline
(``pipeline/tiles.py``) on the card, and stores a zarr component
``<label>/<group>/0`` with Blosc-zlib recompression (and optionally its
pyramid) or a PIL-supported image file, which needs PIL.
``decompress_image`` and ``decompress`` take ``device`` (``None``: the card;
tests pass ``"cpu"``).  The pixel fetch of 'cae' and 'cae_tpu' stores
crosses the link coded with ``CAE_TPU_PACKED_FETCH=1``, by rANS
(``CAE_TPU_FETCH_CODEC=rans``, the default) or the bit-plane packer
(``pack``); ``auto`` codes it only on a link under
``CAE_TPU_PACKED_THRESHOLD_MBPS``.  These are environment variables, as in
the JAX CLI, with no flag.  On the card (``device=None``) the decode
shards every batch over ``serving_mesh()``'s cards ('cae' stores and
latents through a mesh core built here, 'cae_tpu' stores through their
codec's), as ``cli/compress.py`` says; ``cli()`` joins a multi-process
start and only rank 0 writes.
"""

import logging
import os
import shutil

import numpy as np

from ..data.datautils import get_filenames
from ..data.imageio import array_to_image, parse_roi
from ..models.factory import autoencoder_from_state_dict
from ..parallel.distributed import initialize_multihost, is_primary
from .compress import core_mesh
from ..pipeline.tiles import (copy_sidecar_metadata, decompress_cae_array,
                              decompress_cae_turbo_array,
                              decompress_latents_to_pixels)
from ..storage import zarr as zarrlib
from ..storage.cae_codec import CAECodecCore
from ..storage.codecs import Blosc
from ..utils import loggers
from ..utils.args import get_args

LOGGER_NAME = "inference_log"


def decompress_image(input_filename, output_filename,
                     destination_format="zarr", data_group="0/0",
                     decomp_group="decompressed", checkpoint=None,
                     progress_bar=False, gpu=False, core=None,
                     reconstruction_level=-1, compute_pyramids=False,
                     add_offset=False, device=None):
    """Decompress one zarr image (JAX ``cli/decompress.py:27``)."""
    del gpu  # the device is ``device``
    compressor = Blosc(cname="zlib", clevel=9, shuffle=2)
    fn, _ = parse_roi(input_filename, ".zarr")

    if not data_group:
        data_group = "0/0"

    src_root = zarrlib.open(fn, mode="r", device=device)
    z_arr = src_root[data_group] if isinstance(src_root, zarrlib.Group) \
        else src_root
    component = ("%s/%s" % (decomp_group, data_group) if decomp_group
                 else data_group)
    comp_pyr = "/".join(component.split("/")[:-1])
    stored_id = (z_arr._meta.get("compressor") or {}).get("id")

    has_checkpoint = checkpoint is not None and (
        not isinstance(checkpoint, str) or len(checkpoint) > 0)

    if has_checkpoint or core is not None:
        # a checkpoint means "this store holds latents"; a store of coded
        # pixels would otherwise die in the synthesizer on a channel
        # mismatch
        if stored_id in ("cae", "cae_tpu"):
            raise ValueError(
                "input %r stores codec-coded PIXELS (compressor %r); it is "
                "self-decoding — drop the checkpoint argument (-chk). A "
                "checkpoint is only for latent ('cae_bn' / -sbn) inputs."
                % (input_filename, stored_id))
        if core is None:
            core = CAECodecCore(
                autoencoder_from_state_dict(checkpoint, device=device),
                device=device, mesh=core_mesh(device))
        halo = 2 if add_offset else 0  # latent-space halo for stitching
        # image outputs: stage the pixel store next to the target, not at
        # the target (a zarr directory at 'x.png' would block the image)
        store_path = output_filename if "zarr" in destination_format \
            else output_filename + ".tmp.zarr"
        decompress_latents_to_pixels(
            core, z_arr, store_path, component=comp_pyr + "/0",
            compressor=compressor, halo=halo,
            rec_level=reconstruction_level, progress_bar=progress_bar)
        rec = None
    else:
        # self-decoding input: the codec in the metadata does the work
        if stored_id == "cae_bn":
            # float latents would otherwise reach the raw branch: a PIL
            # TypeError (image out) or a uint8-cast garbage store (zarr out)
            raise ValueError(
                "input %r stores LATENTS (compressor 'cae_bn' / -sbn); "
                "decoding them needs the model: pass the checkpoint "
                "(-chk) that wrote the store." % (input_filename,))
        if stored_id == "cae":
            # the store's own codec keeps one device for chunk-by-chunk
            # reads; the batched decode shards over the serving mesh
            mesh, mesh_core = core_mesh(device), None
            if mesh is not None:
                own = z_arr.compressor.core
                mesh_core = CAECodecCore(own.model, mesh=mesh,
                                         compute_dtype=own.compute_dtype)
            rec = decompress_cae_array(z_arr, core=mesh_core)
        elif stored_id == "cae_tpu":
            rec = decompress_cae_turbo_array(z_arr)
        else:
            rec = z_arr[...]
        if "zarr" in destination_format:
            root = zarrlib.Group.create(output_filename, device=device)
            h, w = rec.shape[:2]
            p = min(z_arr.chunks[0], h)
            out_arr = root.create_dataset(
                comp_pyr + "/0", shape=rec.shape,
                chunks=(min(p, h), min(p, w), rec.shape[2]),
                dtype=np.uint8, compressor=compressor, overwrite=True)
            out_arr[...] = rec

    if "zarr" in destination_format:
        if compute_pyramids:
            _write_pyramid(output_filename, comp_pyr, compressor)
        copy_sidecar_metadata(fn, output_filename)
    else:
        if rec is None:
            tmp = output_filename + ".tmp.zarr"
            rec = zarrlib.open(tmp, mode="r")[comp_pyr + "/0"][...]
            shutil.rmtree(tmp, ignore_errors=True)
        base = output_filename.split(destination_format)[0]
        array_to_image(rec, base + destination_format)

    return output_filename


def _write_pyramid(output_filename, comp_pyr, compressor, levels=4):
    """Store 2x-downsampled pyramid components '<group>/1..L' next to the
    full-resolution reconstruction."""
    root = zarrlib.open(output_filename, mode="r")
    base = root[comp_pyr + "/0"][...]
    out_root = zarrlib.Group.create(output_filename)
    cur = base.astype(np.float32)
    for lvl in range(1, levels + 1):
        h, w = cur.shape[:2]
        if h < 2 or w < 2:
            break
        hh, ww = (h // 2) * 2, (w // 2) * 2
        cur = cur[:hh, :ww].reshape(hh // 2, 2, ww // 2, 2, -1) \
            .mean(axis=(1, 3))
        arr = out_root.create_dataset(
            "%s/%d" % (comp_pyr, lvl), shape=cur.shape,
            chunks=(min(512, cur.shape[0]), min(512, cur.shape[1]),
                    cur.shape[2]),
            dtype=np.uint8, compressor=compressor, overwrite=True)
        arr[...] = np.clip(cur, 0, 255).astype(np.uint8)


def decompress(args, device=None):
    """Decompress every input (JAX ``cli/decompress.py:158``)."""
    logger = logging.getLogger(LOGGER_NAME)

    if not args.destination_format.startswith("."):
        args.destination_format = "." + args.destination_format

    input_fn_list = get_filenames(args.data_dir, ".zarr", data_mode="all")
    output_dir = (args.output_dir if isinstance(args.output_dir, list)
                  else [args.output_dir])

    if args.destination_format.lower() not in output_dir[0].lower():
        output_fn_list = []
        for fn in input_fn_list:
            base = fn.split(".zarr")[0].replace("\\", "/").split("/")[-1]
            output_fn_list.append(os.path.join(
                output_dir[0], "%s%s" % (base, args.destination_format)))
    else:
        output_fn_list = output_dir
        if len(output_fn_list) < len(input_fn_list):
            raise ValueError(
                f"{len(input_fn_list)} inputs but only "
                f"{len(output_fn_list)} explicit output path(s); "
                "pass a directory as -o to derive one output per input")

    if args.task_label_identifier is None:
        args.task_label_identifier = "decompressed"

    core = None
    if args.checkpoint:
        core = CAECodecCore(
            autoencoder_from_state_dict(args.checkpoint, device=device),
            device=device, mesh=core_mesh(device))

    for in_fn, out_fn in zip(input_fn_list, output_fn_list):
        logger.info("Decompressing %s into %s" % (in_fn, out_fn))
        decompress_image(
            input_filename=in_fn, output_filename=out_fn,
            destination_format=args.destination_format,
            data_group=args.data_group,
            decomp_group=args.task_label_identifier,
            progress_bar=args.progress_bar, checkpoint=args.checkpoint,
            core=core,
            reconstruction_level=getattr(args, "reconstruction_level", -1),
            compute_pyramids=getattr(args, "compute_pyramids", False),
            add_offset=getattr(args, "add_offset", False), device=device)


def cli():
    """Entry point of ``python -m cnn_autoencoder_tpu_torch.cli.decompress``:
    parse argv and decompress on the card."""
    args = get_args(task="decoder", mode="inference")
    initialize_multihost()
    loggers.setup_logger(args)
    if is_primary():
        decompress(args)
    else:
        logging.getLogger(LOGGER_NAME).info(
            "secondary process: store writes are rank 0's; exiting")
    logging.shutdown()


if __name__ == "__main__":
    cli()

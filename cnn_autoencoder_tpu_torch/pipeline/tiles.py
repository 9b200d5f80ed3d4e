"""Batched, pipelined tile compression/decompression over zarr stores.

The port of the JAX package's ``pipeline/tiles.py`` on the port's
``CAECodecCore`` ('cae', 'cae_bn') and ``CAETurboCore`` ('cae_tpu'), with
the same function names, arguments, stores and chunk bytes:

* tiles are gathered into fixed-size batches (the last one padded with its
  own last tile) and run through the model on the device in one call;
* host entropy coding uses the OpenMP rANS batch API;
* zarr chunk IO on reader threads, device compute and host rANS + writes
  overlap: whole-batch jobs run on ``FETCH_WORKERS`` threads, at most
  ``MAX_INFLIGHT`` batches in flight, as in the JAX module.

Every kernel launches on the current stream, which is the same default
stream in every thread, and each batch is coded from its own tiles alone,
so the bytes a store holds do not depend on how the threads are scheduled
(``tests/test_torch_threads.py``; ``chip_smoke.py`` phase 7 on the card).
``utils.device.full_f32`` counts its blocks across threads for the same
reason.

The pixel transports (``coding/pixel_rans.py``, ``coding/pixel_pack.py``)
move tiles across the link coded, in the same places as the JAX module:
``CAE_TPU_CODED_UPLOAD`` codes the compress paths' uploads,
``CAE_TPU_PACKED_FETCH`` the decompress paths' fetches, by rANS
(``CAE_TPU_FETCH_CODEC=rans``, the default) or the bit-plane packer
(``pack``); ``auto`` probes the link (``coding/link_probe.py``).  The
transports persist on the core (``_up_transport``, ``_fetch_transport``),
so a serving process calibrates once.  An upload calibrates from the first
batch's tiles, a fetch from a probe batch decoded raw and discarded, both
on the calling thread before any batch is dispatched coded, so every
stored byte and decoded pixel is the same as without the transport.
``roundtrip_cae_turbo`` calibrates its fetch transport on the calling
thread from batch 0's frames while encode jobs hold theirs, so no decode
job ever waits for it.

A core with a data mesh (``parallel/mesh.py``) shards every batch over
its devices: ``default_batch_tiles`` rounds the batch up to a multiple of
the ``data`` axis so tiles shard evenly, the bit-plane packer stays off
(its buffer is compacted over the whole batch), and the coded fetch's
gates weigh a shard's batch (``per_shard_batch``), the unit its heads
frame.  A mesh with a ``model`` axis serves each data shard on the first
device of its model group (``parallel/mesh.py:data_devices``), the model
replicated over the axis as the JAX cores replicate it.

``decompress_latents_to_pixels`` takes ``rec_level`` other than full
scale through a multiscale decoder's color layers, as the JAX package does.

The whole-image fused paths (``compress_image_fused`` /
``decompress_image_fused``) take an image that fits the card in one upload,
run the core over chunks of tiles on the card and fetch once, with no
worker threads.
"""

import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..coding.link_probe import coded_upload_enabled
from ..coding.pixel_pack import packed_fetch_enabled
from ..coding.pixel_rans import PixelRansTransport
from ..data.imageio import map_axes_order
from ..storage import zarr as zarrlib
from ..storage.cae_codec import (CAECodecCore, ConvolutionalAutoencoder,
                                 ConvolutionalAutoencoderBottleneck,
                                 narrowest)
from ..storage.codecs import Blosc
from ..storage.turbo_codec import CAETurboCore
from ..utils.profiling import GLOBAL_TIMER


def default_batch_tiles(patch_size: int, core=None,
                        n_tiles: Optional[int] = None) -> int:
    """Pick a batch so one device batch is ~32 MB of uint8 pixels, shrunk
    until the image splits into at least ~4 batches when ``n_tiles`` is
    given.  ``CAE_TPU_BATCH_TILES`` overrides (0 = auto).  When ``core``
    serves over a mesh, the batch is rounded up to a multiple of the data
    axis so tiles shard evenly."""
    forced = int(os.environ.get("CAE_TPU_BATCH_TILES", 0))
    b = forced if forced > 0 else max(
        1, min(64, (1 << 25) // max(1, patch_size * patch_size * 3)))
    if n_tiles and not forced:
        b = max(1, min(b, -(-n_tiles // 4)))
    mesh = getattr(core, "mesh", None)
    if mesh is not None:
        nd = mesh.shape["data"]
        b = -(-b // nd) * nd
    return b


# Concurrency of the pipelined paths: whole-batch jobs run on small thread
# pools so host work (reads, rANS, writes, copies) overlaps the device.
FETCH_WORKERS = int(os.environ.get("CAE_TPU_FETCH_WORKERS", 4))
MAX_INFLIGHT = int(os.environ.get("CAE_TPU_MAX_INFLIGHT", 8))


def normalize_to_yxc(z, data_axes: str = "TCZYX", roi=None):
    """Transpose/select so the array-like is (Y, X, C), index 0 on others."""
    arr = z[...] if not isinstance(z, np.ndarray) else z
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim == 3 and len(data_axes) != 3:
        # PIL-style HWC input with a 5-axis default spec: already YXC
        data_axes = "YXC"
    rem_axes = "".join(a for a in data_axes if a not in "YXC")
    if arr.ndim != len(data_axes):
        data_axes = data_axes[-arr.ndim:]
        rem_axes = "".join(a for a in data_axes if a not in "YXC")
    perm = map_axes_order(data_axes, rem_axes + "YXC")
    arr = np.transpose(arr, perm)
    if roi is not None:
        roi = tuple(roi[a] for a in perm)
        arr = arr[roi]
    while arr.ndim > 3:
        arr = arr[0]
    return arr


def _iter_batches(items: Sequence, batch: int):
    for i in range(0, len(items), batch):
        yield items[i:i + batch]


def _tile_grid(h: int, w: int, p: int):
    return [(i, j) for i in range(-(-h // p)) for j in range(-(-w // p))]


def _read_tile_fn(src: np.ndarray, p: int):
    """The (p, p, c) tile at grid (i, j), zero-padded past the image."""
    h, w, c = src.shape

    def read_tile(ij):
        i, j = ij
        tile = np.zeros((p, p, c), np.uint8)
        block = src[i * p:min((i + 1) * p, h), j * p:min((j + 1) * p, w)]
        tile[:block.shape[0], :block.shape[1]] = block
        return tile
    return read_tile


def _stacked_batch(pool, read_tile, idxs, batch: int) -> np.ndarray:
    """Read one group of tiles and pad it to ``batch`` with its last tile."""
    tiles = list(pool.map(read_tile, idxs))
    while len(tiles) < batch:
        tiles.append(tiles[-1])
    return np.stack(tiles)


def _drain(jobs: List, limit: int) -> None:
    """Wait for the oldest jobs until at most ``limit`` stay in flight."""
    while len(jobs) > limit:
        jobs.pop(0).result()


def _persisted_transport(core, attr: str) -> PixelRansTransport:
    """The core's transport of one direction, made on first use: a serving
    process that codes many images calibrates once."""
    tr = getattr(core, attr, None)
    if tr is None:
        tr = PixelRansTransport(core.device)
        setattr(core, attr, tr)
    return tr


def _upload_transport(core) -> Optional[PixelRansTransport]:
    """The core's upload transport when the coded upload is on."""
    if not coded_upload_enabled(core.device):
        return None
    return _persisted_transport(core, "_up_transport")


def _fetch_codec() -> str:
    codec = os.environ.get("CAE_TPU_FETCH_CODEC", "rans")
    if codec not in ("rans", "pack"):
        raise ValueError(f"CAE_TPU_FETCH_CODEC={codec!r}: 'rans' or 'pack'")
    return codec


def _fetch_transport(core) -> Optional[PixelRansTransport]:
    """The core's fetch transport when the coded fetch is on with the rANS
    codec (the packer needs none)."""
    if not packed_fetch_enabled(core.device) or _fetch_codec() != "rans":
        return None
    return _persisted_transport(core, "_fetch_transport")


def _gate_upload(tr, tiles_np: np.ndarray, n_values: int):
    """``tr``, calibrated from ``tiles_np`` if it is not (first use, or a
    refit after overflows), or None where coding would expand on the
    wire."""
    if (tr is not None and not tr.calibrated()
            and not tr.calibrate_and_gate_upload(tiles_np, n_values)):
        return None
    return tr


def _gate_fetch(tr, rec, core, batch: int):
    """``tr``, calibrated from the reconstructions ``rec`` (a stacked
    array, or a list of tile arrays) if it is not, or None where coding
    ``core``'s batches of ``batch`` tiles would expand on the wire.  The
    gate weighs a shard's batch (``core.per_shard_batch``): the unit the
    coded fetch frames under a mesh (JAX ``tiles.py:740-745``)."""
    if tr is None or tr.calibrated():
        return tr
    if not isinstance(rec, np.ndarray):
        rec = np.stack([r for r in rec if r.shape == rec[0].shape])
    ph, pw = getattr(core, "base", core).padded_hw(*rec.shape[1:3])
    return tr if tr.calibrate_and_gate_fetch(
        rec, ph * pw * 3, core.per_shard_batch(batch)) else None


def compress_pixels_to_cae(core: CAECodecCore, src: np.ndarray,
                           out_path: str, data_group: str = "0/0",
                           patch_size: int = 512,
                           batch_tiles: Optional[int] = None,
                           checkpoint_id: Optional[str] = None,
                           offset: int = 0,
                           progress_bar: bool = False) -> zarrlib.Array:
    """Full-CAE path: pixel tiles -> 'cae' host frame chunks
    (JAX ``tiles.py:104``).

    ``offset`` > 0 encodes each tile with a halo of real neighboring pixels,
    so the decoder sees true context across chunk borders and the decode
    crops the halo.  Each batch job reads, encodes on the device, fetches
    the int8 symbols, codes them on the host and writes its chunks."""
    h, w, c = src.shape
    p = min(patch_size, max(h, w))
    n_tiles = (-(-h // p)) * (-(-w // p))
    batch = batch_tiles or default_batch_tiles(p, core, n_tiles)
    hal = offset
    pe = p + 2 * hal  # encoded tile side

    root = zarrlib.Group.create(out_path, device=core.device)
    arr = root.create_dataset(
        data_group or "0/0", shape=(h, w, c), chunks=(p, p, c),
        dtype=np.uint8,
        compressor={"id": "cae", "checkpoint": checkpoint_id,
                    "offset": hal},
        overwrite=True)

    def read_tile(ij):
        i, j = ij
        tile = np.zeros((pe, pe, c), np.uint8)
        y0, x0 = i * p - hal, j * p - hal
        ys, xs = max(0, y0), max(0, x0)
        ye, xe = min(h, y0 + pe), min(w, x0 + pe)
        tile[ys - y0:ye - y0, xs - x0:xe - x0] = src[ys:ye, xs:xe]
        return tile

    pool = ThreadPoolExecutor(max_workers=4)
    workers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    n_values = pe * pe * c
    up_transport = _upload_transport(core)
    if (up_transport is not None and up_transport.calibrated()
            and not up_transport.worthwhile(n_values)):
        up_transport = None  # this call's tiles are too small to code

    def read_group(idxs):
        with GLOBAL_TIMER.stage("compress/read", len(idxs) * p * p / 1e6):
            return _stacked_batch(pool, read_tile, idxs, batch)

    def compress_one(idxs, tiles_np=None):
        nonlocal up_transport
        mp = len(idxs) * p * p / 1e6
        if tiles_np is None:
            tiles_np = read_group(idxs)
        tr = _gate_upload(up_transport, tiles_np, n_values)
        if tr is None:
            up_transport = None
        snap = tr.snapshot() if tr is not None else None
        coded = snap is not None
        if coded:
            with GLOBAL_TIMER.stage("compress/host_rans_up", mp):
                cap = tr.capacity(n_values)
                queues, totals = tr.encode_host(tiles_np, cap, snap.freq,
                                                snap.start, snap.pred_mode)
                coded = bool((totals >= 0).all())
                if not coded:
                    tr.note_overflow()
        with GLOBAL_TIMER.stage("compress/h2d+dispatch", mp):
            if coded:
                sym_dev = core.encode_tiles_device_coded(
                    queues, totals, tiles_np.shape, snap, cap)
            else:
                GLOBAL_TIMER.add_link_bytes("h2d", tiles_np.nbytes)
                sym_dev = core.encode_tiles_device(tiles_np)
        with GLOBAL_TIMER.stage("compress/d2h_sym", mp):
            sym_np = core.fetch_symbols(sym_dev)[:len(idxs)]
        with GLOBAL_TIMER.stage("compress/rans", mp):
            bufs = core.entropy_encode(sym_np, [(pe, pe)] * sym_np.shape[0])
        with GLOBAL_TIMER.stage("compress/write", mp):
            for (i, j), buf in zip(idxs, bufs):
                arr.write_chunk_raw((i, j, 0), buf)

    try:
        inflight: List = []
        for group in _iter_batches(_tile_grid(h, w, p), batch):
            pre = None
            if up_transport is not None and not up_transport.calibrated():
                # calibrate here, from the first batch's tiles, before any
                # batch is dispatched: every batch then rides the coded
                # upload
                pre = read_group(group)
                up_transport = _gate_upload(up_transport, pre, n_values)
            inflight.append(workers.submit(compress_one, group, pre))
            _drain(inflight, MAX_INFLIGHT)
        _drain(inflight, 0)
    finally:
        pool.shutdown()
        workers.shutdown()
    return arr


def compress_pixels_to_bottleneck(core: CAECodecCore, src: np.ndarray,
                                  out_path: str, data_group: str = "0/0",
                                  patch_size: int = 512,
                                  batch_tiles: Optional[int] = None,
                                  progress_bar: bool = False
                                  ) -> zarrlib.Array:
    """Bottleneck path: pixel tiles -> float latent chunks stored with the
    self-describing 'cae_bn' codec (JAX ``tiles.py:250``)."""
    h, w, c = src.shape
    p = min(patch_size, max(h, w))
    n_tiles = (-(-h // p)) * (-(-w // p))
    batch = batch_tiles or default_batch_tiles(p, core, n_tiles)
    lp_h, lp_w = core.latent_hw(p, p)
    cbn = core.channels_bn

    codec = ConvolutionalAutoencoderBottleneck(
        channels_bn=cbn, fact_ent=core.model.fact_ent.params(),
        filters=list(core.model.filters))

    lh, lw = core.latent_hw(h, w)
    root = zarrlib.Group.create(out_path, device=core.device)
    arr = root.create_dataset(
        data_group or "0/0", shape=(lh, lw, cbn), chunks=(lp_h, lp_w, cbn),
        dtype=np.float32, compressor=codec, overwrite=True)
    # the latent rounds h, w up to multiples of 2^level; the decode side
    # crops back to the true pixel size recorded here
    arr.attrs["true_pixel_shape"] = [int(h), int(w)]

    read_tile = _read_tile_fn(src, p)
    pool = ThreadPoolExecutor(max_workers=8)
    pending = []

    def flush_one():
        idxs, y_dev = pending.pop(0)
        y_np = y_dev[:len(idxs)].cpu().numpy()  # (B, lh, lw, C) latents
        for (i, j), y_tile in zip(idxs, y_np):
            arr.write_chunk((i, j, 0), y_tile)

    try:
        for group in _iter_batches(_tile_grid(h, w, p), batch):
            # latents() normalizes u8 -> [0, 1] itself
            y = core.latents(_stacked_batch(pool, read_tile, group, batch))
            pending.append((group, y))
            if len(pending) >= 2:
                flush_one()
        while pending:
            flush_one()
    finally:
        pool.shutdown()
    return arr


def decompress_latents_to_pixels(core: CAECodecCore, src: zarrlib.Array,
                                 out_path: str, component: str,
                                 batch_tiles: Optional[int] = None,
                                 compressor=None, halo: int = 0,
                                 rec_level: int = -1,
                                 progress_bar: bool = False
                                 ) -> zarrlib.Array:
    """Decode a latent array ('cae_bn'-stored) back to pixels
    (JAX ``tiles.py:314``).

    ``halo`` > 0 reads each latent chunk with that many latent pixels of
    real neighboring context, decodes the enlarged tile and crops: seamless
    stitched reconstruction.  ``rec_level`` other than full scale (-1 or
    the model's level) decodes the multiscale decoder's reconstruction at
    ``2 ** rec_level`` times the latent's size (JAX ``tiles.py:331-352``);
    a model without color layers raises before any store is created."""
    if compressor is None:
        compressor = Blosc(cname="zlib", clevel=9, shuffle=2)
    lh, lw, cbn = src.shape
    lp_h, lp_w, _ = src.chunks
    level = core.level
    if rec_level not in (-1, level) and \
            not core.model.decoder.multiscale_analysis:
        raise ValueError(
            "Partial reconstruction (rec_level=%d of %d) needs a "
            "multiscale_analysis decoder (color layers); this model "
            "has none" % (rec_level, level))
    scale = 2 ** (level if rec_level in (-1, level) else rec_level)
    h, w = lh * scale, lw * scale
    true_hw = (src.attrs or {}).get("true_pixel_shape")
    if true_hw:
        h = min(h, -(-int(true_hw[0]) // 2 ** level) * scale)
        w = min(w, -(-int(true_hw[1]) // 2 ** level) * scale)
        if rec_level in (-1, level):
            h, w = min(h, int(true_hw[0])), min(w, int(true_hw[1]))
    p_h, p_w = lp_h * scale, lp_w * scale
    batch = batch_tiles or default_batch_tiles(max(p_h, p_w), core)

    root = zarrlib.Group.create(out_path, device=core.device)
    out = root.create_dataset(component, shape=(h, w, 3),
                              chunks=(p_h, p_w, 3), dtype=np.uint8,
                              compressor=compressor, overwrite=True)

    grid = list(src.chunk_ids())
    pool = ThreadPoolExecutor(max_workers=8)

    def read_latent(ij):
        i, j = ij[0], ij[1]
        if halo <= 0:
            return src.read_chunk(ij)
        le_h, le_w = lp_h + 2 * halo, lp_w + 2 * halo
        tile = np.zeros((le_h, le_w, cbn), np.float32)
        y0, x0 = i * lp_h - halo, j * lp_w - halo
        ys, xs = max(0, y0), max(0, x0)
        ye, xe = min(lh, y0 + le_h), min(lw, x0 + le_w)
        tile[ys - y0:ye - y0, xs - x0:xe - x0] = src[ys:ye, xs:xe, :]
        # edge-replicate outside the image so the decoder sees plausible
        # context at true borders
        tile[:ys - y0] = tile[ys - y0]
        if ye - y0 < le_h:
            tile[ye - y0:] = tile[ye - y0 - 1]
        tile[:, :xs - x0] = tile[:, xs - x0:xs - x0 + 1]
        if xe - x0 < le_w:
            tile[:, xe - x0:] = tile[:, xe - x0 - 1:xe - x0]
        return tile

    pending = []
    crop = halo * scale

    def flush_one():
        idxs, rec_dev = pending.pop(0)
        rec_np = rec_dev[:len(idxs)].cpu().numpy()
        if crop:
            rec_np = rec_np[:, crop:-crop, crop:-crop]
        futures = [pool.submit(out.write_chunk, ij, rec)
                   for ij, rec in zip(idxs, rec_np)]
        for f in futures:
            f.result()

    try:
        for group in _iter_batches(grid, batch):
            chunks = list(pool.map(read_latent, group))
            while len(chunks) < batch:
                chunks.append(chunks[-1])
            rec = core.decode_latents_device(np.stack(chunks),
                                             rec_level=rec_level)
            pending.append((group, rec))
            if len(pending) >= 2:
                flush_one()
        while pending:
            flush_one()
    finally:
        pool.shutdown()
    return out


def decompress_cae_array(src: zarrlib.Array,
                         batch_tiles: Optional[int] = None,
                         core: Optional[CAECodecCore] = None) -> np.ndarray:
    """Materialize a 'cae'-coded pixel array via the batched decode path
    (JAX ``tiles.py:410``), cropping each tile's ``offset`` halo.

    ``core`` may be given to reuse a built model; else the codec of the
    array's metadata is built (on the array's device).  Host rANS decodes
    run ahead on their own worker, the device decodes on the main thread,
    and fetch + stitch jobs run on ``FETCH_WORKERS`` threads, each into a
    disjoint region of the output."""
    if core is None:
        codec = src.compressor
        assert isinstance(codec, ConvolutionalAutoencoder), (
            "source array is not 'cae'-coded")
        core = codec.core
    p = src.chunks[0]
    comp_cfg = src._meta.get("compressor") or {}
    offset = int(comp_cfg.get("offset", 0) or 0)
    grid = list(src.chunk_ids())
    batch = batch_tiles or default_batch_tiles(p, core, len(grid))
    out = np.zeros(src.shape, np.uint8)

    pool = ThreadPoolExecutor(max_workers=8)
    raw = list(pool.map(src.read_chunk_raw, grid))
    pool.shutdown()

    mp_batch = batch * p * p / 1e6
    # the coded fetch (rANS, or the bit-plane packer) gives the pixels of a
    # raw fetch; its transport persists on the core
    ph, pw = core.padded_hw(p + 2 * offset, p + 2 * offset)
    n_values = ph * pw * 3
    # the packer compacts over the whole batch: single-device only (JAX
    # tiles.py:447)
    use_packed = (core.mesh is None and packed_fetch_enabled(core.device)
                  and _fetch_codec() == "pack" and n_values % 128 == 0)
    transport = _fetch_transport(core)
    if (transport is not None and transport.calibrated()
            and not transport.worthwhile_fetch(
                n_values, core.per_shard_batch(batch))):
        transport = None  # this call's tiles are too small to code

    def fetch_and_stitch(idxs, rec_dev, tr):
        # ``tr`` is the transport the batch was dispatched with: another
        # job's refit may drop ``transport`` for later batches meanwhile
        nonlocal transport
        with GLOBAL_TIMER.stage("decompress/fetch_total", mp_batch):
            if torch.is_tensor(rec_dev):
                rec_dev = rec_dev[:len(idxs)]
            rec_np = core.fetch_pixels(rec_dev, (batch, ph, pw, 3),
                                       tr)[:len(idxs)]
        if tr is not None and not tr.calibrated():
            # a third overflow dropped the table in this fetch: refit from
            # these (raw) pixels so later batches go coded again
            if _gate_fetch(tr, rec_np, core, batch) is None:
                transport = None
        if offset:
            rec_np = rec_np[:, offset:-offset, offset:-offset]
        with GLOBAL_TIMER.stage("decompress/stitch", mp_batch):
            for ij, rec in zip(idxs, rec_np):
                sl, valid = src.chunk_slices(ij)
                out[sl] = rec[:valid[0], :valid[1], :valid[2]]

    def rans_decode_group(i):
        # decode only present chunks and carry their ids; missing chunks
        # keep the fill value in `out`
        ids = [g for g, b in zip(grid[i:i + batch], raw[i:i + batch])
               if b is not None]
        bufs = [b for b in raw[i:i + batch] if b is not None]
        if not bufs:
            return None, ids
        with GLOBAL_TIMER.stage("decompress/rans", mp_batch):
            sym, _ = core.entropy_decode(bufs)
        if sym.shape[0] < batch:
            pad = np.repeat(sym[-1:], batch - sym.shape[0], axis=0)
            sym = np.concatenate([sym, pad], axis=0)
        return sym, ids

    starts = list(range(0, len(grid), batch))
    if transport is not None and not transport.calibrated():
        # the calibration probe: the first present batch decoded raw, the
        # table fit from its reconstructions and the pixels discarded, so
        # every output batch goes through the coded fetch
        for i0 in starts:
            sym0, _ = rans_decode_group(i0)
            if sym0 is not None:
                rec0 = core.fetch_pixels(core.decode_tiles_device(sym0))
                transport = _gate_fetch(transport, rec0, core, batch)
                break

    rans_pool = ThreadPoolExecutor(max_workers=1)
    fetchers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    try:
        futures = {}
        jobs: List = []
        for k, i in enumerate(starts):
            for j in starts[k:k + 4]:
                if j not in futures:
                    futures[j] = rans_pool.submit(rans_decode_group, j)
            sym, ids = futures.pop(i).result()
            if sym is None:
                continue
            tr = transport  # once: a fetch job's refit may change it
            with GLOBAL_TIMER.stage("decompress/h2d+dispatch", mp_batch):
                rec = core.decode_tiles_device(sym, packed=use_packed,
                                               transport=tr)
            jobs.append(fetchers.submit(fetch_and_stitch, ids, rec, tr))
            _drain(jobs, MAX_INFLIGHT)
        _drain(jobs, 0)
    finally:
        rans_pool.shutdown()
        fetchers.shutdown()
    return out


def copy_sidecar_metadata(src_path: str, dst_path: str) -> None:
    """Copy the labels/masks groups and OME metadata beside the output
    (JAX ``tiles.py:562``).  Remote sources fetch OME/METADATA.ome.xml over
    HTTP or anonymous/signed S3."""
    from ..data.remote import fetch_remote, is_remote
    if is_remote(src_path):
        url = src_path.rstrip("/") + "/OME/METADATA.ome.xml"
        try:
            xml = fetch_remote(url)
        except (FileNotFoundError, RuntimeError):
            return  # the source ships no OME sidecar
        ome_dir = os.path.join(dst_path, "OME")
        os.makedirs(ome_dir, exist_ok=True)
        with open(os.path.join(ome_dir, "METADATA.ome.xml"), "wb") as f:
            f.write(xml)
        return
    if not os.path.isdir(src_path):
        return
    try:
        src_root = zarrlib.open(src_path, mode="r")
    except FileNotFoundError:
        return
    if not isinstance(src_root, zarrlib.Group):
        return
    dst_root = zarrlib.Group.create(dst_path)
    for name in ("labels", "masks"):
        if name in src_root and name not in dst_root:
            shutil.copytree(os.path.join(src_path, name),
                            os.path.join(dst_path, name))
    ome_src = os.path.join(src_path, "OME")
    ome_dst = os.path.join(dst_path, "OME")
    if os.path.isdir(ome_src) and not os.path.isdir(ome_dst):
        shutil.copytree(ome_src, ome_dst)


def _create_turbo_array(core: CAETurboCore, out_path: str, data_group,
                        shape, p: int, checkpoint_id):
    root = zarrlib.Group.create(out_path, device=core.device)
    return root.create_dataset(
        data_group or "0/0", shape=shape, chunks=(p, p, shape[2]),
        dtype=np.uint8,
        compressor={"id": "cae_tpu", "checkpoint": checkpoint_id,
                    "num_streams": core.num_streams},
        overwrite=True)


def _stitch_turbo(arr: zarrlib.Array, out: np.ndarray, ids, rec) -> None:
    for ij, r in zip(ids, rec):
        sl, valid = arr.chunk_slices(ij)
        out[sl] = r[:valid[0], :valid[1], :valid[2]]


def compress_pixels_to_cae_turbo(core: CAETurboCore, src: np.ndarray,
                                 out_path: str,
                                 data_group: str = "0/0",
                                 patch_size: int = 512,
                                 batch_tiles: Optional[int] = None,
                                 checkpoint_id: Optional[str] = None,
                                 progress_bar: bool = False):
    """Turbo path: conv, quantization and rANS coding on the device
    ('cae_tpu' chunks), only compressed bytes cross the link
    (JAX ``tiles.py:599``).  Batches are read on the main thread and
    encoded and written by ``FETCH_WORKERS`` threads."""
    assert isinstance(core, CAETurboCore)
    h, w, c = src.shape
    p = min(patch_size, max(h, w))
    n_tiles = (-(-h // p)) * (-(-w // p))
    batch = batch_tiles or default_batch_tiles(p, core, n_tiles)
    arr = _create_turbo_array(core, out_path, data_group, (h, w, c), p,
                              checkpoint_id)
    read_tile = _read_tile_fn(src, p)
    pool = ThreadPoolExecutor(max_workers=4)
    workers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    up_transport = _upload_transport(core)

    def encode_and_write(idxs, tiles_np):
        nonlocal up_transport
        tr = _gate_upload(up_transport, tiles_np, p * p * c)
        if tr is None:
            up_transport = None
        with GLOBAL_TIMER.stage("compress/turbo_encode",
                                len(idxs) * p * p / 1e6):
            bufs = core.encode_tiles(tiles_np, up_transport=tr)
        for (i, j), buf in zip(idxs, bufs[:len(idxs)]):
            arr.write_chunk_raw((i, j, 0), buf)

    try:
        inflight: List = []
        for group in _iter_batches(_tile_grid(h, w, p), batch):
            tiles_np = _stacked_batch(pool, read_tile, group, batch)
            # the first batch calibrates the upload here, before any
            # dispatch
            up_transport = _gate_upload(up_transport, tiles_np, p * p * c)
            inflight.append(workers.submit(encode_and_write, group,
                                           tiles_np))
            _drain(inflight, MAX_INFLIGHT)
        _drain(inflight, 0)
    finally:
        pool.shutdown()
        workers.shutdown()
    return arr


def decompress_cae_turbo_array(src: zarrlib.Array,
                               batch_tiles: Optional[int] = None,
                               core: Optional[CAETurboCore] = None
                               ) -> np.ndarray:
    """Materialize a 'cae_tpu'-coded array via batched device decode
    (JAX ``tiles.py:690``); concurrent jobs each stitch a disjoint region
    of the output."""
    if core is None:
        core = src.compressor.core
    p = src.chunks[0]
    grid = list(src.chunk_ids())
    batch = batch_tiles or default_batch_tiles(p, core, len(grid))
    out = np.zeros(src.shape, np.uint8)

    pool = ThreadPoolExecutor(max_workers=8)
    raw = list(pool.map(src.read_chunk_raw, grid))
    pool.shutdown()

    transport = _fetch_transport(core)
    if transport is not None and not transport.calibrated():
        # the calibration probe: the first present batch decoded raw, the
        # table fit from its reconstructions and the pixels discarded
        for i0 in range(0, len(grid), batch):
            bufs0 = [b for b in raw[i0:i0 + batch] if b is not None]
            if bufs0:
                transport = _gate_fetch(transport, core.decode_tiles(bufs0),
                                        core, batch)
                break

    def decode_and_stitch(ids, bufs):
        nonlocal transport
        tr = transport  # once: another job's refit may change it
        with GLOBAL_TIMER.stage("decompress/turbo_decode",
                                len(ids) * p * p / 1e6):
            rec = core.decode_tiles(bufs, transport=tr)
        if tr is not None and not tr.calibrated():
            # a third overflow dropped the table: refit from these pixels
            if _gate_fetch(tr, rec, core, batch) is None:
                transport = None
        _stitch_turbo(src, out, ids, rec)

    workers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    try:
        jobs: List = []
        for i in range(0, len(grid), batch):
            # decode only present chunks against their own ids; missing
            # chunks keep the fill value in `out`
            ids = [g for g, b in zip(grid[i:i + batch], raw[i:i + batch])
                   if b is not None]
            bufs = [b for b in raw[i:i + batch] if b is not None]
            if not bufs:
                continue
            jobs.append(workers.submit(decode_and_stitch, ids, bufs))
            _drain(jobs, MAX_INFLIGHT)
        _drain(jobs, 0)
    finally:
        workers.shutdown()
    return out


def roundtrip_cae_turbo(core: CAETurboCore, src: np.ndarray, out_path: str,
                        data_group: str = "0/0", patch_size: int = 512,
                        batch_tiles: Optional[int] = None,
                        checkpoint_id: Optional[str] = None):
    """Overlapped compress + decompress of one image through the turbo path
    (JAX ``tiles.py:795``): batch ``k``'s decode runs while batch ``k+1``
    encodes, on separate worker pools, so neither direction waits for the
    other.  Stored bytes and the reconstruction are those of
    ``compress_pixels_to_cae_turbo`` then ``decompress_cae_turbo_array``,
    with the transports as those calibrate them.

    An uncalibrated fetch transport is calibrated on this thread from batch
    0's frames (a raw probe decode, discarded) as soon as its encode is
    done; until then finished encode jobs leave their frames here instead
    of submitting decode jobs.  A decode job never waits, so the decode
    pool cannot fill with waiting jobs while batch 0's waits behind them.

    Returns ``(arr, rec)``: the written zarr array and the reconstructed
    (h, w, c) uint8 image."""
    assert isinstance(core, CAETurboCore)
    h, w, c = src.shape
    p = min(patch_size, max(h, w))
    n_tiles = (-(-h // p)) * (-(-w // p))
    batch = batch_tiles or default_batch_tiles(p, core, n_tiles)
    arr = _create_turbo_array(core, out_path, data_group, (h, w, c), p,
                              checkpoint_id)
    out = np.zeros((h, w, c), np.uint8)
    read_tile = _read_tile_fn(src, p)

    read_pool = ThreadPoolExecutor(max_workers=4)
    # one pool per direction: encode jobs never queue behind decode jobs
    enc_workers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    dec_workers = ThreadPoolExecutor(max_workers=FETCH_WORKERS)
    up_transport = _upload_transport(core)
    fetch_tr = _fetch_transport(core)
    dec_jobs: List = []
    held: List = []   # frames waiting for the fetch calibration
    dec_lock = threading.Lock()
    released = fetch_tr is None or fetch_tr.calibrated()

    def decode_and_stitch(ids, bufs):
        nonlocal fetch_tr
        tr = fetch_tr
        with GLOBAL_TIMER.stage("decompress/turbo_decode",
                                len(ids) * p * p / 1e6):
            rec = core.decode_tiles(bufs, transport=tr)
        if tr is not None and not tr.calibrated():
            # a third overflow dropped the table: refit from these pixels
            if _gate_fetch(tr, rec, core, batch) is None:
                fetch_tr = None
        _stitch_turbo(arr, out, [(i, j, 0) for i, j in ids], rec)

    def encode_and_roundtrip(idxs, tiles_np):
        nonlocal up_transport
        tr = _gate_upload(up_transport, tiles_np, p * p * c)
        if tr is None:
            up_transport = None
        with GLOBAL_TIMER.stage("compress/turbo_encode",
                                len(idxs) * p * p / 1e6):
            bufs = core.encode_tiles(tiles_np, up_transport=tr)
        bufs = [bytes(b) for b in bufs[:len(idxs)]]
        for (i, j), buf in zip(idxs, bufs):
            arr.write_chunk_raw((i, j, 0), buf)
        with dec_lock:
            if released:
                dec_jobs.append(dec_workers.submit(decode_and_stitch, idxs,
                                                   bufs))
            else:
                held.append((idxs, bufs))
        return bufs

    def calibrate_fetch(bufs0):
        nonlocal fetch_tr, released
        fetch_tr = _gate_fetch(fetch_tr, core.decode_tiles(bufs0), core,
                               batch)
        with dec_lock:
            released = True
            dec_jobs.extend(dec_workers.submit(decode_and_stitch, *job)
                            for job in held)
            held.clear()

    try:
        inflight: List = []
        first = None
        for group in _iter_batches(_tile_grid(h, w, p), batch):
            tiles_np = _stacked_batch(read_pool, read_tile, group, batch)
            up_transport = _gate_upload(up_transport, tiles_np, p * p * c)
            inflight.append(enc_workers.submit(encode_and_roundtrip, group,
                                               tiles_np))
            if first is None:
                first = inflight[0]
            if not released and first.done():
                calibrate_fetch(first.result())
            _drain(inflight, MAX_INFLIGHT)
        if not released:
            calibrate_fetch(first.result())
        _drain(inflight, 0)
        with dec_lock:
            pending = list(dec_jobs)
        _drain(pending, 0)
    finally:
        read_pool.shutdown()
        enc_workers.shutdown()
        dec_workers.shutdown()
    return arr, out


# --- whole-image fused paths -------------------------------------------------


def _pad_to_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Repeat the last item of ``x`` until its length is a multiple of
    ``chunk``, so every chunk runs at one shape."""
    pad = (-x.shape[0]) % chunk
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def compress_image_fused(core: CAECodecCore, src: np.ndarray, out_path: str,
                         data_group: str = "0/0", patch_size: int = 512,
                         chunk: int = 16,
                         checkpoint_id: Optional[str] = None
                         ) -> zarrlib.Array:
    """Whole-image compress (JAX ``tiles.py:1036``): one upload of the
    image, zero-padded to whole tiles and cut into tiles on the device, the
    core's encode over chunks of ``chunk`` tiles (the last padded with its
    last tile), one fetch of the symbols, the host coder, one 'cae' chunk
    per tile.  The JAX package pads on the host; here the padding is made
    on the device, so the host allocates no padded copy of the image.  Its
    stages are recorded in ``GLOBAL_TIMER`` under the pipeline's names."""
    h, w, c = src.shape
    p = min(patch_size, max(h, w))
    grid_h, grid_w = -(-h // p), -(-w // p)
    mp = h * w / 1e6

    with GLOBAL_TIMER.stage("compress/h2d+dispatch", mp):
        GLOBAL_TIMER.add_link_bytes("h2d", src.nbytes)
        img = torch.zeros((grid_h * p, grid_w * p, c), dtype=torch.uint8,
                          device=core.device)
        img[:h, :w] = torch.from_numpy(np.ascontiguousarray(src)).to(
            core.device)
        tiles = img.reshape(grid_h, p, grid_w, p, c) \
            .permute(0, 2, 1, 3, 4).reshape(-1, p, p, c)
        n = tiles.shape[0]
        sym = torch.cat([core.latent_symbols(group) for group in
                         _pad_to_chunks(tiles, chunk).split(chunk)])[:n]
    with GLOBAL_TIMER.stage("compress/d2h_sym", mp):
        sym_np = core.fetch_symbols(core.narrow_symbols(sym))

    root = zarrlib.Group.create(out_path, device=core.device)
    arr = root.create_dataset(
        data_group or "0/0", shape=(h, w, c), chunks=(p, p, c),
        dtype=np.uint8,
        compressor={"id": "cae", "checkpoint": checkpoint_id, "offset": 0},
        overwrite=True)
    with GLOBAL_TIMER.stage("compress/rans", mp):
        bufs = core.entropy_encode(sym_np, [(p, p)] * n)
    with GLOBAL_TIMER.stage("compress/write", mp):
        for k, buf in enumerate(bufs):
            arr.write_chunk_raw((k // grid_w, k % grid_w, 0), buf)
    return arr


def decompress_image_fused(src: zarrlib.Array,
                           core: Optional[CAECodecCore] = None,
                           chunk: int = 16) -> np.ndarray:
    """Whole-image decompress (JAX ``tiles.py:1069``) of a 'cae' store of
    offset 0: the chunks read on 8 threads, one host decode of all of them,
    one upload in the narrowest integer type, the core's decode over chunks
    of ``chunk`` tiles, one fetch, the stitch.  Missing chunks keep the
    fill value.  Stages as in ``compress_image_fused``."""
    if core is None:
        codec = src.compressor
        assert isinstance(codec, ConvolutionalAutoencoder), (
            "source array is not 'cae'-coded")
        core = codec.core
    offset = int((src._meta.get("compressor") or {}).get("offset", 0) or 0)
    if offset:
        raise ValueError(f"decompress_image_fused takes 'cae' stores of "
                         f"offset 0, this one has {offset}")
    mp = src.shape[0] * src.shape[1] / 1e6
    grid = list(src.chunk_ids())
    with GLOBAL_TIMER.stage("decompress/read", mp):
        with ThreadPoolExecutor(max_workers=8) as pool:
            raw = list(pool.map(src.read_chunk_raw, grid))
    ids = [ij for ij, b in zip(grid, raw) if b is not None]
    out = np.zeros(src.shape, np.uint8)
    if not ids:
        return out

    with GLOBAL_TIMER.stage("decompress/rans", mp):
        sym, _ = core.entropy_decode([b for b in raw if b is not None])
    with GLOBAL_TIMER.stage("decompress/h2d+dispatch", mp):
        sym_dev = torch.from_numpy(narrowest(sym)).to(core.device)
        rec = torch.cat([core.decode_tiles_device(group) for group in
                         _pad_to_chunks(sym_dev, chunk).split(chunk)])
    with GLOBAL_TIMER.stage("decompress/fetch_total", mp):
        rec = rec[:len(ids)].cpu().numpy()
    with GLOBAL_TIMER.stage("decompress/stitch", mp):
        for ij, r in zip(ids, rec):
            sl, valid = src.chunk_slices(ij)
            out[sl] = r[:valid[0], :valid[1], :valid[2]]
    return out

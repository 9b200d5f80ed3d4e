"""CAE codecs with the host rANS coder: 'cae' (the whole autoencoder) and
'cae_bn' (the bottleneck's float latent only).

Bitstream, byte-identical to the JAX package's (``storage/cae_codec.py``
there): ``struct.pack('>QQ', h, w)``, the tile's true size in pixels (or
the latent chunk's, for 'cae_bn'), then the host rANS payload of the
channel-major quantized latent (``coding/rans.py``).

``CAECodecCore`` is the batched machinery: the encoder on the device, the
int8 symbol fetch (the int32 copy only on overflow), the host coder, the
narrowest lossless upload of decoded symbols and the decoder on the device.
Tiles whose sides are not multiples of ``2**compression_level`` are
reflect-padded before encoding and cropped after decoding.  The 'cae_tpu'
codec writes these frames for a batch its device coder cannot take.

The pixels may cross the link coded (``coding/pixel_rans.py``,
``coding/pixel_pack.py``): ``encode_tiles_device_coded`` takes host-coded
tiles and decodes them on the device (K5) before the encoder;
``decode_tiles_device`` with a transport codes the reconstruction's
residuals on the device (K6), or packs their bit-planes, and
``fetch_pixels`` fetches and decodes any of the three forms on the host.
Every form gives the same pixels; a batch past its coded budget falls back
to the device's raw pixels.  ``GLOBAL_TIMER`` counts the bytes each way.

With a ``mesh`` (``parallel/mesh.py``, the JAX core's ``mesh=``) a batch is
padded to a multiple of the ``data`` axis by repeating its last tile and
each contiguous shard runs on its mesh device, on a replica of the model
there, every kernel launched per shard; every shard's device work is
launched before any result is fetched, and the results are gathered on the
mesh's first device.  The bit-plane packer stays single-device (its buffer
is compacted over the whole batch), so a mesh core fetches raw or by rANS,
whose head is one pooled head a shard, ``(n_shards, head_words)``.  Frames
and pixels are those of one device.

The model runs at a compute type fixed when the core is built: float32, or
bf16 activations end to end (``ops.convops.set_default_precision("bf16")``
or CAE_TPU_PRECISION=bf16), as the JAX codec casts them at the model's
boundary.  Frames do not depend on it: a frame written at either decodes at
either, in either package.
"""

import base64
import copy
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding import rans
from ..coding.pixel_pack import (pack_pixels_device_with_head,
                                 unpack_pixels_host)
from ..coding.pixel_rans import (_CAP_BUCKET, RansFetchResult,
                                 TransportSnapshot, compact_host,
                                 compact_queues_device,
                                 decode_residuals_device,
                                 encode_residuals_device,
                                 expand_queues_device)
from ..models.entropy import medians_fn, update_cdf_tables
from ..models.factory import autoencoder_from_state_dict
from ..ops.convops import core_precision, get_activations_dtype
from ..parallel.mesh import (check_model_axis, gather_batch, replicate,
                             split_batch)
from ..training.checkpoint import msgpack_restore, msgpack_serialize
from ..utils.device import resolve_device
from ..utils.profiling import GLOBAL_TIMER
from .codecs import (Codec, check_frame_hw, latent_hw, ndarray_copy,
                     padded_hw, register_codec)


def reflect_index(n: int, size: int) -> np.ndarray:
    """Indices that reflect-pad a length-n axis to ``size`` (numpy's
    'reflect' mode, the JAX package's padding of odd tiles)."""
    return np.pad(np.arange(n), (0, size - n), mode="reflect")


def host_frame_hw(raw: bytes) -> Tuple[int, int]:
    """The (h, w) of a host frame's header, checked before it sizes any
    allocation; raises ValueError on a short or implausible header."""
    if len(raw) < 16:
        raise ValueError(f"corrupt frame: {len(raw)} bytes is shorter than "
                         "the 16-byte header")
    h, w = struct.unpack(">QQ", bytes(raw[:16]))
    check_frame_hw(h, w)
    return h, w


def narrowest(sym) -> np.ndarray:
    """Host symbols in the narrowest integer type that holds them losslessly
    (int8, else int16, else as given): the type they cross the link in."""
    sym = np.ascontiguousarray(sym)
    if sym.dtype != np.int8 and sym.size:
        lo, hi = sym.min(), sym.max()
        if -128 <= lo and hi <= 127:
            return sym.astype(np.int8)
        if sym.dtype != np.int16 and -32768 <= lo and hi <= 32767:
            return sym.astype(np.int16)
    return sym


def _channel_indexes(c: int, h: int, w: int) -> np.ndarray:
    return np.broadcast_to(np.arange(c, dtype=np.int32)[:, None, None],
                           (c, h, w))


class CAECodecCore:
    """Batched encode/decode of tiles for one CAE model on ``device``
    (``None``: the card), with activations in ``compute_dtype`` (float32 or
    bf16; ``None``: ``get_activations_dtype()`` now) at the precision
    ``convops.core_precision(compute_dtype)`` gives now, which the core
    keeps (``precision``) and hands its model's layers.  The encoder and the
    decoder run in eval mode (``train=False``: batch norms on their running
    statistics, no dropout) whatever the model's ``training`` flag, as the
    JAX cores apply them.  ``mesh``: a data mesh to shard batches over
    (the model moves to its first device; ``device`` is then unused)."""

    def __init__(self, model, device=None, compute_dtype=None, mesh=None):
        if mesh is not None:
            check_model_axis(mesh.shape["model"])
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.compute_dtype = (get_activations_dtype() if compute_dtype is None
                              else compute_dtype)
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {self.compute_dtype}: the codec "
                             "runs float32 or bf16")
        self.precision = core_precision(compute_dtype)
        self.model = model.to(self.device)
        self.level = model.compression_level
        self.channels_bn = model.channels_bn
        fe = {k: v.detach().cpu().numpy()
              for k, v in model.fact_ent.params().items()}
        tables = update_cdf_tables(fe, model.filters)
        self.cdf = tables["quantized_cdf"]
        self.cdf_length = tables["cdf_length"]
        self.offset = tables["offset"]
        self.medians = np.asarray(medians_fn(fe), np.float32)
        self._med = torch.from_numpy(self.medians).to(self.device)
        # one single-device core a mesh device, in mesh order (a repeated
        # device repeats its core)
        self.shards = None if mesh is None else self._shard_cores()

    # -- mesh ---------------------------------------------------------------

    def _on_device(self, device, model):
        """A single-device copy of this core on ``device``, sharing its host
        tables."""
        core = copy.copy(self)
        core.mesh = core.shards = None
        core.device, core.model = device, model
        core._med = self._med.to(device)
        return core

    def _shard_cores(self) -> List["CAECodecCore"]:
        models = replicate(self.mesh, self.model)
        by_model = {}
        for d, m in zip(self.mesh.devices, models):
            if id(m) not in by_model:
                by_model[id(m)] = self._on_device(d, m)
        return [by_model[id(m)] for m in models]

    def per_shard_batch(self, batch: int) -> int:
        """Tiles a shard after the mesh's padding: the framing unit of the
        rANS fetch's pooled heads, at which the pipeline's gates weigh a
        coded fetch (JAX ``turbo_codec.py:per_shard_batch``)."""
        nd = 1 if self.mesh is None else self.mesh.shape["data"]
        return max(1, -(-batch // nd))

    def _split(self, x) -> List:
        """``x``'s shards, tensors moved to their devices."""
        return split_batch(x, len(self.shards),
                           [c.device for c in self.shards])

    def _sharded(self, method: str, x, *args) -> torch.Tensor:
        """``method`` of each shard core on its shard of ``x`` (all launched
        before any result is gathered), gathered and cut to ``x``'s
        batch."""
        parts = [getattr(core, method)(part, *args)
                 for core, part in zip(self.shards, self._split(x))]
        return gather_batch(parts, self.device)[:x.shape[0]]

    # -- geometry -----------------------------------------------------------

    def padded_hw(self, h: int, w: int) -> Tuple[int, int]:
        return padded_hw(h, w, self.level)

    def latent_hw(self, h: int, w: int) -> Tuple[int, int]:
        return latent_hw(h, w, self.level)

    # -- device steps -------------------------------------------------------

    @torch.no_grad()
    def latent_symbols(self, tiles_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 (numpy or tensor) -> (B, C, lh, lw) int32
        quantized latent ``round(y - medians)``, channel-major, on the
        device; y in the compute type, the medians and the difference in
        float32."""
        if self.shards:
            return self._sharded("latent_symbols", tiles_u8)
        if not torch.is_tensor(tiles_u8):
            tiles_u8 = torch.from_numpy(np.ascontiguousarray(tiles_u8))
        x = tiles_u8.to(self.device)
        _, h, w, _ = x.shape
        x = x.float() / 255.0
        ph, pw = self.padded_hw(h, w)
        if (ph, pw) != (h, w):
            iy = torch.from_numpy(reflect_index(h, ph)).to(self.device)
            ix = torch.from_numpy(reflect_index(w, pw)).to(self.device)
            x = x[:, iy][:, :, ix]
        y = self._apply(self.model.encoder, x)
        sym = torch.round(y - self._med).to(torch.int32)
        return sym.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def latents(self, tiles_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 (numpy or tensor), sides multiples of
        2**level -> (B, lh, lw, C) float32 latents y on the device, computed
        in the compute type: what a 'cae_bn' store holds (the JAX core's
        ``_latent``)."""
        if self.shards:
            return self._sharded("latents", tiles_u8)
        if not torch.is_tensor(tiles_u8):
            tiles_u8 = torch.from_numpy(np.ascontiguousarray(tiles_u8))
        x = tiles_u8.to(self.device).float() / 255.0
        return self._apply(self.model.encoder, x).float()

    def _apply(self, track, x: torch.Tensor):
        """The encoder or the decoder in eval mode on x in the compute type,
        at the core's precision (the bf16 mode's layers on float32 rows
        where its activations are float32)."""
        return track(x.to(self.compute_dtype), train=False,
                     compute_dtype=self.precision)

    @staticmethod
    def narrow_symbols(sym: torch.Tensor):
        """(int8 symbols, overflow count, int32 symbols) of a device batch:
        the int8 copy is what crosses the link unless a symbol leaves int8
        range.  No clipping: the host coder takes any int32 symbol."""
        overflow = ((sym > 127) | (sym < -128)).sum().to(torch.int32)
        return sym.to(torch.int8), overflow, sym

    def encode_tiles_device(self, tiles_u8):
        """The device step of an encode: (B, H, W, 3) uint8 -> (int8
        symbols, overflow count, int32 symbols) on the device, channel-major.
        Pass the result to ``fetch_symbols``."""
        return self.narrow_symbols(self.latent_symbols(tiles_u8))

    @torch.no_grad()
    def encode_from_rans(self, offsets: torch.Tensor, flat: torch.Tensor,
                         snap: TransportSnapshot, shape, px_capacity: int
                         ) -> torch.Tensor:
        """The coded upload's device step: the flat host-coded words of
        ``compact_host`` expanded to rows, decoded by K5 to the (B, H, W, 3)
        tiles of ``shape`` and encoded (reflect-padded as raw tiles are) ->
        (B, C, lh, lw) int32 symbols."""
        queues = expand_queues_device(flat, offsets, px_capacity)
        return self.latent_symbols(decode_residuals_device(
            queues, snap.dec_lut, shape, snap.pred_mode))

    def encode_tiles_device_coded(self, queues_u16: np.ndarray,
                                  totals: np.ndarray, shape,
                                  snap: TransportSnapshot, px_capacity: int):
        """``encode_tiles_device`` of tiles coded on the host: the (B,
        px_capacity) uint16 queues of ``PixelRansTransport.encode_host``
        with ``snap``'s tables, compacted to one flat buffer, which is all
        that crosses the link.  Returns what ``encode_tiles_device``
        does."""
        if self.shards:
            # each shard uploads its own tiles' words
            parts = [core.encode_tiles_device_coded(
                q, t, (len(q),) + tuple(shape[1:]), snap.to(core.device),
                px_capacity)[2] for core, q, t in zip(
                    self.shards, self._split(queues_u16),
                    self._split(totals))]
            return self.narrow_symbols(gather_batch(
                parts, self.device)[:len(queues_u16)])
        flat, offs = compact_host(queues_u16, totals, px_capacity)
        GLOBAL_TIMER.add_link_bytes("h2d", flat.nbytes + offs.nbytes)
        return self.narrow_symbols(self.encode_from_rans(
            torch.from_numpy(offs).to(self.device),
            torch.from_numpy(flat).to(self.device), snap, shape,
            px_capacity))

    @staticmethod
    def fetch_symbols(sym_dev) -> np.ndarray:
        """Device-to-host symbol copy: the int8 symbols and the overflow
        count in one copy; the int32 symbols follow only on overflow."""
        sym8, overflow, sym_wide = sym_dev
        buf = torch.cat([overflow.reshape(1).view(torch.uint8),
                         sym8.reshape(-1).view(torch.uint8)])
        host = buf.cpu().numpy()
        GLOBAL_TIMER.add_link_bytes("d2h", host.nbytes)
        if int(host[:4].view(np.int32)[0]) == 0:
            return host[4:].view(np.int8).reshape(tuple(sym8.shape))
        wide = sym_wide.cpu().numpy()
        GLOBAL_TIMER.add_link_bytes("d2h", wide.nbytes)
        return wide

    @torch.no_grad()
    def decode_tiles_device(self, sym, packed: bool = False, transport=None):
        """(B, C, lh, lw) symbols -> (B, lh·2^level, lw·2^level, 3) uint8
        reconstructions on the device.  Host symbols go up the link in the
        narrowest lossless integer type (int8, else int16, else int32).

        With a calibrated ``transport`` (``PixelRansTransport``) the
        result is ``decode_rans``'s coded form instead, with ``packed``
        the bit-plane packer's (head, words, widths, total); pass either to
        ``fetch_pixels``.  Under a mesh ``packed`` is ignored, and the coded
        form keeps the padded batch (one pooled head a shard)."""
        snap = transport.snapshot() if transport is not None else None
        if self.shards:
            if snap is None:
                return self._sharded("decode_tiles_device", sym)
            return self._decode_rans_sharded(sym, snap, transport)
        if snap is not None:
            b, _, lh, lw = sym.shape
            n = (lh << self.level) * (lw << self.level) * 3
            return self.decode_rans(sym, snap, transport.capacity(n),
                                    transport.pooled_head_words(n, b))
        if packed:
            return self.decode_packed(sym)
        if not torch.is_tensor(sym):
            sym = torch.from_numpy(narrowest(sym))
            GLOBAL_TIMER.add_link_bytes("h2d", sym.numel()
                                        * sym.element_size())
        y = sym.to(self.device).permute(0, 2, 3, 1).float() + self._med
        return self._synthesize(y)

    def _decode_rans_sharded(self, sym, snap: TransportSnapshot,
                             transport) -> RansFetchResult:
        """``decode_rans`` on every shard, each compacting its own tiles
        into a head of one shard's budget; the heads stack in mesh
        order."""
        b, _, lh, lw = sym.shape
        n = (lh << self.level) * (lw << self.level) * 3
        capacity = transport.capacity(n)
        head_words = transport.pooled_head_words(n, self.per_shard_batch(b))
        parts = [core.decode_rans(part, snap.to(core.device), capacity,
                                  head_words)
                 for core, part in zip(self.shards, self._split(sym))]
        return RansFetchResult(
            gather_batch([p.head for p in parts], self.device),
            gather_batch([p.totals for p in parts], self.device),
            gather_batch([p.rec for p in parts], self.device), capacity,
            snap.freq, snap.start, snap.pred_mode)

    def decode_packed(self, sym):
        """Decode, then pack the residuals' bit-planes on the device:
        ``pack_pixels_device_with_head``'s (head, words, widths, total)."""
        return pack_pixels_device_with_head(self.decode_tiles_device(sym))

    @torch.no_grad()
    def decode_rans(self, sym, snap: TransportSnapshot, capacity: int,
                    head_words: int) -> RansFetchResult:
        """Decode, then code the reconstruction's residuals with K6 at
        ``capacity`` words a tile and compact the queues into one head of
        ``head_words``; the raw pixels stay on the device for an overflow's
        fallback."""
        rec = self.decode_tiles_device(sym)
        bufs, totals = encode_residuals_device(rec, snap.tables, capacity,
                                               snap.pred_mode)
        head = compact_queues_device(bufs, totals, head_words)
        return RansFetchResult(head[None], totals, rec, capacity, snap.freq,
                               snap.start, snap.pred_mode)

    @classmethod
    def fetch_pixels(cls, rec_dev, shape=None, transport=None) -> np.ndarray:
        """Device-to-host pixels of any transport: a uint8 tensor (raw); the
        packer's (head, words, widths, total), with ``shape`` the tiles'
        (B, P, Q, C); or a ``RansFetchResult``, with the ``transport`` that
        coded it.  The copy is one in the common case; a coded batch past
        its budget takes the raw pixels.  The copies are timed as
        ``decompress/d2h_pixels``, the host decode as
        ``decompress/host_rans_px`` or ``decompress/host_unpack_px``."""
        if torch.is_tensor(rec_dev):
            with GLOBAL_TIMER.stage("decompress/d2h_pixels",
                                    rec_dev.numel() / 1e6):
                out = rec_dev.cpu().numpy()
            GLOBAL_TIMER.add_link_bytes("d2h", out.nbytes)
            return out
        if isinstance(rec_dev, RansFetchResult):
            return cls._fetch_rans(rec_dev, shape, transport)
        return cls._fetch_packed(rec_dev, shape)

    @staticmethod
    def _fetch_rans(res: RansFetchResult, shape, transport) -> np.ndarray:
        # the totals and a predicted slice of the head come in one copy
        # (the estimate + 4 % covers almost every batch); a second copy
        # fetches the tail of an under-predicted one
        n_shards, hw = res.head.shape
        b = res.totals.shape[0]
        per = b // n_shards
        p, q, c = shape[1:]
        est = transport.estimate_coded_words(p * q * c, per)
        nb = min(hw, -(-int(est * 1.04) // _CAP_BUCKET) * _CAP_BUCKET)
        head16 = res.head.view(torch.int16)
        with GLOBAL_TIMER.stage("decompress/d2h_pixels", b * p * q / 1e6):
            host = torch.cat([res.totals.view(torch.int16),
                              head16[:, :nb].reshape(-1)]).cpu().numpy()
        totals = host[:2 * b].view(np.int32)
        head = host[2 * b:].view(np.uint16).reshape(n_shards, nb)
        offs = totals.reshape(n_shards, per)
        # a tile past its own budget (its row was cut on the device) or the
        # batch past the pooled head (words cut in the compaction)
        if (int(totals.max()) > res.capacity
                or int(np.cumsum(offs, axis=1).max()) > hw):
            transport.note_overflow()
            with GLOBAL_TIMER.stage("decompress/d2h_pixels",
                                    b * p * q / 1e6):
                out = res.rec.cpu().numpy()
            GLOBAL_TIMER.add_link_bytes("d2h", out.nbytes + host.nbytes)
            return out
        needed = int(offs.sum(axis=1).max())
        if needed > nb:
            nb2 = min(hw, -(-needed // _CAP_BUCKET) * _CAP_BUCKET)
            with GLOBAL_TIMER.stage("decompress/d2h_pixels", 0.0):
                tail = head16[:, nb:nb2].cpu().numpy().view(np.uint16)
            head = np.concatenate([head, tail], axis=1)
        GLOBAL_TIMER.add_link_bytes("d2h", head.nbytes + totals.nbytes)
        out = np.empty((b, p, q, c), np.uint8)
        with GLOBAL_TIMER.stage("decompress/host_rans_px", b * p * q / 1e6):
            for s in range(n_shards):
                off = 0
                for j in range(per):
                    tot = int(offs[s, j])
                    out[s * per + j] = transport.decode_host(
                        head[s, off:off + tot], tot, (1, p, q, c), res.freq,
                        res.start, res.pred_mode)[0]
                    off += tot
        return out

    @staticmethod
    def _fetch_packed(rec_dev, shape) -> np.ndarray:
        # the used word count, the head and the widths in one copy; the
        # tail only when the batch packed past the head
        head, buf, widths, total = rec_dev
        mp = shape[0] * shape[1] * shape[2] / 1e6
        nh = head.shape[0]
        with GLOBAL_TIMER.stage("decompress/d2h_pixels", mp):
            host = torch.cat([total.reshape(1).view(torch.uint8),
                              head.view(torch.uint8), widths]).cpu().numpy()
            used = int(host[:4].view(np.int32)[0])
            words = host[4:4 + 4 * nh].view(np.int32)
            widths_np = host[4 + 4 * nh:]
            if used > nh:
                bucket = 1 << 14
                hi = min(-(-used // bucket) * bucket, buf.shape[0])
                words = np.concatenate([words, buf[nh:hi].cpu().numpy()])
        GLOBAL_TIMER.add_link_bytes("d2h", words.nbytes + widths_np.nbytes
                                    + 4)
        with GLOBAL_TIMER.stage("decompress/host_unpack_px", mp):
            return unpack_pixels_host(words, widths_np, shape)

    @torch.no_grad()
    def decode_latents_device(self, y, rec_level: int = -1) -> torch.Tensor:
        """Decode float NHWC latents (medians included; cast to the compute
        type here) to uint8 on the device (JAX ``cae_codec.py:433-443``).
        ``rec_level`` -1 or the model's level reconstructs at full scale; a
        coarser level L takes the multiscale decoder's reconstruction at
        2**L times the latent's size, and raises for a decoder without
        color layers."""
        if self.shards:
            return self._sharded("decode_latents_device", y, rec_level)
        rec_idx = 0 if rec_level in (-1, self.level) \
            else self.level - rec_level
        if not torch.is_tensor(y):
            y = torch.from_numpy(np.ascontiguousarray(y, np.float32))
        return self._synthesize(y.to(self.device, torch.float32), rec_idx)

    def _synthesize(self, y: torch.Tensor, rec_idx: int = 0) -> torch.Tensor:
        """Float32 latents -> uint8 reconstructions at pyramid index
        ``rec_idx`` (0: full scale)."""
        x_r, _ = self._apply(self.model.decoder, y)
        if x_r[rec_idx] is None:
            raise ValueError(
                "Partial reconstruction at this level needs a "
                "multiscale_analysis decoder (color layers)")
        # clip, then truncate to uint8, as the JAX codec converts
        return torch.clamp(x_r[rec_idx].float() * 255.0, 0,
                           255).to(torch.uint8)

    # -- host steps ---------------------------------------------------------

    def entropy_encode(self, sym_np: np.ndarray,
                       true_hw: Sequence[Tuple[int, int]]) -> List[bytes]:
        """(B, C, lh, lw) symbols -> host frames."""
        b, c, lh, lw = sym_np.shape
        streams = rans.encode_batch(
            sym_np.reshape(b, -1).astype(np.int32, copy=False),
            _channel_indexes(c, lh, lw), self.cdf, self.cdf_length,
            self.offset)
        return [struct.pack(">QQ", th, tw) + s
                for s, (th, tw) in zip(streams, true_hw)]

    def entropy_decode(self, bufs: Sequence[bytes]
                       ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Host frames of one true (h, w) -> ((B, C, lh, lw) int32 symbols,
        the frames' (h, w)).  Every header is checked before any
        allocation."""
        hws = {host_frame_hw(b) for b in bufs}
        if len(hws) != 1:
            raise ValueError(f"entropy_decode takes frames of one tile size "
                             f"per call, got {sorted(hws)}")
        h, w = hws.pop()
        lh, lw = self.latent_hw(h, w)
        sym = rans.decode_batch(
            [bytes(b[16:]) for b in bufs],
            _channel_indexes(self.channels_bn, lh, lw), self.cdf,
            self.cdf_length, self.offset)
        return (sym.reshape(len(bufs), self.channels_bn, lh, lw),
                [(h, w)] * len(bufs))

    # -- batched codec ------------------------------------------------------

    def encode_tiles(self, tiles_u8, true_hw=None) -> List[bytes]:
        """(B, H, W, 3) uint8 -> one host frame per tile."""
        bsz, h, w, _ = tiles_u8.shape
        if true_hw is None:
            true_hw = [(h, w)] * bsz
        sym = self.fetch_symbols(self.encode_tiles_device(tiles_u8))
        return self.entropy_encode(sym, true_hw)

    def decode_tiles(self, bufs: Sequence[bytes]) -> np.ndarray:
        """Host frames of one tile size -> (B, h, w, 3) uint8 (host)."""
        sym, true_hw = self.entropy_decode(bufs)
        h, w = true_hw[0]
        return self.decode_tiles_device(sym)[:, :h, :w, :].cpu().numpy()


class ConvolutionalAutoencoder(Codec):
    """zarr codec id 'cae': a pixel chunk <-> a host CAE frame.
    ``offset`` pads the chunk by that many edge pixels before encoding and
    crops them after decoding.  It serves at the precision set when it is
    built (``ops.convops.set_default_precision``)."""

    codec_id = "cae"
    takes_device = True

    def __init__(self, checkpoint, device=None, offset: int = 0):
        self.checkpoint = checkpoint if isinstance(checkpoint, str) else None
        self.offset = int(offset or 0)
        self.core = CAECodecCore(
            autoencoder_from_state_dict(checkpoint, device=device),
            device=device)

    def encode(self, buf) -> bytes:
        buf = np.asarray(buf)
        if self.offset:
            buf = np.pad(buf, ((self.offset,) * 2, (self.offset,) * 2,
                               (0, 0)), mode="edge")
        h, w, _ = buf.shape
        return self.core.encode_tiles(buf[None].astype(np.uint8),
                                      [(h, w)])[0]

    def decode(self, buf, out=None):
        rec = self.core.decode_tiles([bytes(buf)])[0]
        if self.offset:
            rec = rec[self.offset:-self.offset, self.offset:-self.offset]
        return ndarray_copy(np.ascontiguousarray(rec), out)

    def get_config(self):
        return {"id": self.codec_id, "checkpoint": self.checkpoint,
                "offset": self.offset}


class ConvolutionalAutoencoderBottleneck(Codec):
    """zarr codec id 'cae_bn': a float latent chunk (h, w, C) <-> a host
    rANS frame, on the host.

    Self-describing: the bottleneck's parameters ride in the config as
    base64 flax-msgpack (``fact_ent_checkpoint``), which both packages read
    and write."""

    codec_id = "cae_bn"

    def __init__(self, channels_bn: int, fact_ent=None, filters=None,
                 fact_ent_checkpoint: Optional[str] = None):
        if fact_ent is not None:
            # fact_ent: the parameter dict, or a dict holding it as 'params'
            params = fact_ent["params"] if "params" in fact_ent else fact_ent
            # in sorted key order, as the JAX codec's pytree map leaves
            # them, so both packages write the same config string
            params = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                          else np.asarray(v))
                      for k, v in sorted(params.items())}
            if filters is None:
                k = sum(1 for key in params if key.startswith("matrix_")) - 1
                filters = [3] * k
            fact_ent_checkpoint = base64.b64encode(
                msgpack_serialize(params)).decode("ascii")
        if fact_ent_checkpoint is None:
            raise ValueError("cae_bn codec needs fact_ent params")

        self.channels_bn = int(channels_bn)
        self.filters = list(filters) if filters is not None else [3, 3, 3, 3]
        self.fact_ent_checkpoint = fact_ent_checkpoint

        params: Dict[str, np.ndarray] = msgpack_restore(
            base64.b64decode(fact_ent_checkpoint))
        tables = update_cdf_tables(params, self.filters)
        self.cdf = tables["quantized_cdf"]
        self.cdf_length = tables["cdf_length"]
        self.offset = tables["offset"]
        self.medians = np.asarray(params["quantiles"][:, 0, 1], np.float32)

    def encode(self, buf) -> bytes:
        buf = np.asarray(buf, np.float32)
        h, w, _ = buf.shape
        sym = np.round(buf - self.medians).astype(np.int32)
        stream = rans.encode_with_indexes(
            np.transpose(sym, (2, 0, 1)),
            _channel_indexes(self.channels_bn, h, w), self.cdf,
            self.cdf_length, self.offset)
        return struct.pack(">QQ", h, w) + stream

    def decode(self, buf, out=None):
        h, w = host_frame_hw(bytes(buf))
        sym = rans.decode_with_indexes(
            bytes(buf[16:]), _channel_indexes(self.channels_bn, h, w),
            self.cdf, self.cdf_length, self.offset)
        sym = sym.reshape(self.channels_bn, h, w)
        y_q = np.transpose(sym, (1, 2, 0)).astype(np.float32) + self.medians
        return ndarray_copy(np.ascontiguousarray(y_q), out)

    def get_config(self):
        return {"id": self.codec_id, "channels_bn": self.channels_bn,
                "filters": self.filters,
                "fact_ent_checkpoint": self.fact_ent_checkpoint}


register_codec(ConvolutionalAutoencoder)
register_codec(ConvolutionalAutoencoderBottleneck)

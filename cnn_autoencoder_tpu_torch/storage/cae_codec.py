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

The model runs at a compute type fixed when the core is built: float32, or
bf16 activations end to end (``ops.convops.set_default_precision("bf16")``
or CAE_TPU_PRECISION=bf16), as the JAX codec casts them at the model's
boundary.  Frames do not depend on it: a frame written at either decodes at
either, in either package.
"""

import base64
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding import rans
from ..models.entropy import medians_fn, update_cdf_tables
from ..models.factory import autoencoder_from_state_dict
from ..ops.convops import get_activations_dtype
from ..training.checkpoint import msgpack_restore, msgpack_serialize
from ..utils.device import resolve_device
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
    bf16; ``None``: ``get_activations_dtype()`` now)."""

    def __init__(self, model, device=None, compute_dtype=None):
        self.device = resolve_device(device)
        self.compute_dtype = (get_activations_dtype() if compute_dtype is None
                              else compute_dtype)
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {self.compute_dtype}: the codec "
                             "runs float32 or bf16")
        self.model = model.to(self.device).eval()
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
        y = self.model.encoder(x.to(self.compute_dtype))
        sym = torch.round(y - self._med).to(torch.int32)
        return sym.permute(0, 3, 1, 2).contiguous()

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

    @staticmethod
    def fetch_symbols(sym_dev) -> np.ndarray:
        """Device-to-host symbol copy: the int8 symbols and the overflow
        count in one copy; the int32 symbols follow only on overflow."""
        sym8, overflow, sym_wide = sym_dev
        buf = torch.cat([overflow.reshape(1).view(torch.uint8),
                         sym8.reshape(-1).view(torch.uint8)])
        host = buf.cpu().numpy()
        if int(host[:4].view(np.int32)[0]) == 0:
            return host[4:].view(np.int8).reshape(tuple(sym8.shape))
        return sym_wide.cpu().numpy()

    @torch.no_grad()
    def decode_tiles_device(self, sym) -> torch.Tensor:
        """(B, C, lh, lw) symbols -> (B, lh·2^level, lw·2^level, 3) uint8
        reconstructions on the device.  Host symbols go up the link in the
        narrowest lossless integer type (int8, else int16, else int32)."""
        if not torch.is_tensor(sym):
            sym = torch.from_numpy(narrowest(sym))
        y = sym.to(self.device).permute(0, 2, 3, 1).float() + self._med
        return self._synthesize(y)

    @torch.no_grad()
    def decode_latents_device(self, y, rec_level: int = -1) -> torch.Tensor:
        """Decode float NHWC latents (medians included; cast to the compute
        type here) to uint8 on the device.  ``rec_level`` -1 or the model's
        level reconstructs at full scale; a coarser level needs a multiscale
        decoder, which the port does not have yet, and raises."""
        if rec_level not in (-1, self.level):
            raise ValueError(
                "Partial reconstruction at this level needs a "
                "multiscale_analysis decoder (color layers)")
        if not torch.is_tensor(y):
            y = torch.from_numpy(np.ascontiguousarray(y, np.float32))
        return self._synthesize(y.to(self.device, torch.float32))

    def _synthesize(self, y: torch.Tensor) -> torch.Tensor:
        """Float32 latents -> uint8 reconstructions."""
        x_r, _ = self.model.decoder(y.to(self.compute_dtype))
        # clip, then truncate to uint8, as the JAX codec converts
        return torch.clamp(x_r[0].float() * 255.0, 0, 255).to(torch.uint8)

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
            params = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                          else np.asarray(v)) for k, v in params.items()}
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

"""'cae_tpu' turbo codec: CAE analysis, quantization and rANS coding all on
the device.

Bitstream (per chunk, self-framed), byte-identical to the JAX package's:
  '>QQ' true (h, w) pixels, with bit 63 of h set (the turbo marker; a host
        'cae' frame's h is a real height, so the formats never collide)
  '>BH' version, num_streams S
  v4:   '>I' payload bytes, then one little-endian u16 word queue in decode
        order (2 flush words per stream, stream-major, then refills in
        (step, stream) order)
  v3:   '>I' * S per-stream byte lengths, then the streams' little-endian
        u16 words one after the other (legacy: read, never written)

A batch the device coder cannot take, because a symbol falls outside its
channel's table (an escape) or because no capacity of six fits its words,
is written as host 'cae' frames (``storage/cae_codec.py``), as the JAX codec
writes it.  A store may therefore mix turbo and host frames, and
``decode_tiles`` reads the format of every buffer on its own.
"""

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding.device_rans import (bake_device_tables, decode_device,
                                  decode_interleaved, encode_states,
                                  expected_bits_per_symbol, pack_streams,
                                  stream_channel_map, unpack_streams)
from ..models.factory import autoencoder_from_state_dict
from ..ops.kernels.rans_kernel import rans_compact
from .cae_codec import CAECodecCore, host_frame_hw
from .codecs import (Codec, check_frame_hw, ndarray_copy,
                     register_codec)

VERSION = 4
LEGACY_VERSION = 3
HOST_FORMAT = 0    # the version key of host 'cae' frames in decode_tiles
DEFAULT_STREAMS = 1024
CAPACITY_TRIES = 6  # capacities tried before the host coder takes a batch
TURBO_FLAG = 1 << 63   # set on the big-endian h field of turbo frames


def is_turbo_frame(raw: bytes) -> bool:
    """True iff this chunk buffer is a turbo frame (vs host 'cae' format)."""
    return len(raw) >= 16 and (raw[0] & 0x80) != 0


class CAETurboCore:
    """Batched device encode/decode of tiles for one CAE model; ``base`` is
    the host-format core of the same model, which writes the batches the
    device coder cannot take and reads host frames.  ``compute_dtype`` is
    the model's activation type, as ``CAECodecCore`` takes it."""

    def __init__(self, model, num_streams: int = DEFAULT_STREAMS,
                 device=None, compute_dtype=None):
        if not 1 <= num_streams <= 0xFFFF:
            raise ValueError(f"num_streams {num_streams} does not fit the "
                             "frame's u16 field")
        self.base = CAECodecCore(model, device=device,
                                 compute_dtype=compute_dtype)
        self.num_streams = num_streams
        fe = {k: v.detach().cpu().numpy()
              for k, v in model.fact_ent.params().items()}
        tables = bake_device_tables(fe, model.filters)
        # stream padding codes symbol 0, so it must be in every table
        zero = -tables.offset.numpy()
        if not bool(((zero >= 0) & (zero < tables.length.numpy())).all()):
            raise ValueError("turbo tables exclude symbol 0 for some "
                             "channel; stream padding would be uncodable")
        self.expected_bits = expected_bits_per_symbol(tables)
        self.tables = tables.to(self.device)
        self._ch_maps = {}
        self.capacity_retries = 0  # compactions re-run at a larger capacity
        self.host_fallbacks = 0    # batches written as host 'cae' frames

    @property
    def model(self):
        return self.base.model

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def channels_bn(self) -> int:
        return self.base.channels_bn

    # -- geometry -----------------------------------------------------------

    def _ch_map(self, lh: int, lw: int, s: int) -> torch.Tensor:
        key = (lh, lw, s)
        if key not in self._ch_maps:
            self._ch_maps[key] = torch.from_numpy(stream_channel_map(
                self.channels_bn, (lh, lw), s)).to(self.device)
        return self._ch_maps[key]

    def _steps(self, lh: int, lw: int, s: int) -> int:
        return -(-self.channels_bn * lh * lw // s)

    def _latent_hw(self, th: int, tw: int) -> Tuple[int, int]:
        return self.base.latent_hw(*self.base.padded_hw(th, tw))

    # -- encode -------------------------------------------------------------

    def latent_symbols(self, tiles_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, C, lh, lw) int32 quantized latent
        ``round(y - medians)``, channel-major, on the device."""
        return self.base.latent_symbols(tiles_u8)

    def escapes(self, sym_cm: torch.Tensor) -> torch.Tensor:
        """Per-tile count of symbols outside their channel's table."""
        v = sym_cm - self.tables.offset[None, :, None, None]
        bad = (v < 0) | (v >= self.tables.length[None, :, None, None])
        return bad.sum(dim=(1, 2, 3))

    def frames_from_symbols(self, sym_cm: torch.Tensor,
                            true_hw: Sequence[Tuple[int, int]]
                            ) -> List[bytes]:
        """Entropy-code a (B, C, lh, lw) symbol batch into frames: one state
        pass, then one compaction and one device-to-host copy (escape count,
        totals and uint16 words together) per capacity tried.  Escapes, or
        six capacities that all overflow, send the batch to the host coder,
        which codes the same symbols."""
        bsz, _, lh, lw = sym_cm.shape
        s = self.num_streams
        t = self._steps(lh, lw, s)
        esc = self.escapes(sym_cm).sum()
        state = encode_states(pack_streams(sym_cm.reshape(bsz, -1), s),
                              self._ch_map(lh, lw, s), self.tables)
        # the first capacity from the tables' entropy (+12% headroom), then
        # doubling, as the JAX codec tries them; none needs to exceed one
        # word per symbol
        capacity = 2 * s + 64 + int(t * s * self.expected_bits / 16.0 * 1.12)
        worst = 2 * s + t * s
        for attempt in range(CAPACITY_TRIES):
            if attempt:
                self.capacity_retries += 1
                capacity *= 2
            cap = min(capacity, worst)
            n_esc, totals, words = self._compact_fetch(state, esc, cap)
            if n_esc:
                break
            if int(totals.max()) <= cap:
                return self._frame(words, totals, true_hw)
        self.host_fallbacks += 1
        sym = self.base.fetch_symbols(self.base.narrow_symbols(sym_cm))
        return self.base.entropy_encode(sym, true_hw)

    def _compact_fetch(self, state, esc: torch.Tensor, cap: int):
        """Compact ``state`` at ``cap`` into one device buffer holding the
        escape count and the totals (int32) before the (B, cap) uint16
        words, and copy it to the host at once.  Returns (escape count,
        totals, words) as host arrays."""
        bsz = state.words.shape[0]
        head = 2 * (bsz + 1)  # uint16 slots of the int32 head
        buf = torch.empty(head + bsz * cap, dtype=torch.uint16,
                          device=self.device)
        counts = buf[:head].view(torch.int32)
        rans_compact(state, cap, out=(buf[head:].view(bsz, cap), counts[1:]))
        counts[0] = esc
        host = buf.cpu().numpy()
        counts_h = host[:head].view(np.int32)
        return (int(counts_h[0]), counts_h[1:],
                host[head:].reshape(bsz, cap))

    def _frame(self, bufs_np, totals_np, true_hw) -> List[bytes]:
        out = []
        words_le = bufs_np.astype("<u2")
        for i, (th, tw) in enumerate(true_hw):
            total = int(totals_np[i])
            out.append(b"".join([
                struct.pack(">QQ", th | TURBO_FLAG, tw),
                struct.pack(">BH", VERSION, self.num_streams),
                struct.pack(">I", total * 2),
                words_le[i, :total].tobytes()]))
        return out

    def encode_tiles(self, tiles_u8, true_hw=None) -> List[bytes]:
        """(B, H, W, 3) uint8 (numpy or tensor) -> one frame per tile."""
        bsz, h, w, _ = tiles_u8.shape
        if true_hw is None:
            true_hw = [(h, w)] * bsz
        return self.frames_from_symbols(self.latent_symbols(tiles_u8),
                                        true_hw)

    # -- decode -------------------------------------------------------------

    @staticmethod
    def _parse_header(raw: bytes) -> Tuple[int, int, int, int]:
        """(version, S, true h, true w) of a frame, version ``HOST_FORMAT``
        and S 0 for a host 'cae' frame; raises ValueError on anything
        else."""
        if not is_turbo_frame(raw):
            return (HOST_FORMAT, 0) + host_frame_hw(raw)
        h_field, tw = struct.unpack(">QQ", raw[:16])
        th = h_field & ~TURBO_FLAG
        check_frame_hw(th, tw)
        if len(raw) < 23:
            # both versions need (version u8, S u16) and one more u32
            raise ValueError(
                f"corrupt cae_tpu frame: truncated header ({len(raw)} bytes)")
        version, s = struct.unpack(">BH", raw[16:19])
        if version not in (VERSION, LEGACY_VERSION):
            raise ValueError(f"cae_tpu frame version {version} unsupported "
                             f"(expected {LEGACY_VERSION} or {VERSION})")
        if s < 1:
            raise ValueError("corrupt cae_tpu frame: zero stream count")
        return version, s, th, tw

    def symbols_from_frames(self, raws: Sequence[bytes], s: int, th: int,
                            tw: int) -> torch.Tensor:
        """Decode same-geometry v4 frames -> (B, C, lh, lw) int32 symbols
        on the device."""
        lh, lw = self._latent_hw(th, tw)
        t = self._steps(lh, lw, s)
        batch = len(raws)
        totals = np.zeros(batch, np.int64)  # in 16-bit words
        payloads = []
        for i, raw in enumerate(raws):
            (nbytes,) = struct.unpack(">I", raw[19:23])
            payload = raw[23:]
            if len(payload) < nbytes or nbytes % 2:
                raise ValueError(
                    f"corrupt cae_tpu frame: payload holds {len(payload)} "
                    f"bytes, header declares {nbytes}")
            totals[i] = nbytes // 2
            payloads.append(payload[:nbytes])
        qcap = max(128, -(-int(totals.max()) // 128) * 128)
        queues = np.zeros((batch, qcap), np.uint16)
        for i, payload in enumerate(payloads):
            queues[i, :totals[i]] = np.frombuffer(payload, "<u2")
        sym_ts = decode_interleaved(torch.from_numpy(queues).to(self.device),
                                    self._ch_map(lh, lw, s), self.tables, t)
        flat = unpack_streams(sym_ts, self.channels_bn * lh * lw)
        return flat.reshape(batch, self.channels_bn, lh, lw)

    def symbols_from_frames_v3(self, raws: Sequence[bytes], s: int, th: int,
                               tw: int) -> torch.Tensor:
        """Decode same-geometry legacy v3 frames (a length table, then
        per-stream words) -> (B, C, lh, lw) int32 symbols on the device.
        The untrusted length table is checked against the payload before it
        sizes any allocation."""
        lh, lw = self._latent_hw(th, tw)
        t = self._steps(lh, lw, s)
        batch = len(raws)
        lengths = np.zeros((batch, s), np.int64)  # in 16-bit words
        payloads = []
        for i, raw in enumerate(raws):
            table = raw[19:19 + 4 * s]
            if len(table) < 4 * s:
                raise ValueError(
                    f"corrupt cae_tpu frame: v3 length table truncated "
                    f"({len(table)} of {4 * s} bytes)")
            ln = np.frombuffer(table, ">u4").astype(np.int64) // 2
            payload = raw[19 + 4 * s:]
            need = int(ln.sum())
            if len(payload) < 2 * need or len(payload) % 2:
                raise ValueError(
                    f"corrupt cae_tpu frame: payload holds {len(payload)} "
                    f"bytes, header declares {2 * need}")
            lengths[i] = ln
            payloads.append(payload)
        longest = int(lengths.max())
        # legit v3 streams are near-balanced: a table with one huge entry
        # passes the payload check above yet would size a (batch, S,
        # longest) buffer far past the words present
        words_present = int(lengths.sum())
        if s * longest > 16 * max(words_present, 2 * s + 64):
            raise ValueError(
                "corrupt cae_tpu frame: v3 length table implausibly skewed "
                f"(max stream {longest} words x {s} streams vs "
                f"{words_present} words present)")
        cap = max(64, longest)
        bufs = np.zeros((batch, s, cap), np.uint16)
        cols = np.arange(cap)
        for i in range(batch):
            flat = np.frombuffer(payloads[i], "<u2")
            mask = cols[None, :] < lengths[i][:, None]          # (S, cap)
            bufs[i][mask] = flat[:int(lengths[i].sum())]
        sym_ts = decode_device(torch.from_numpy(bufs).to(self.device),
                               self._ch_map(lh, lw, s), self.tables, t)
        flat = unpack_streams(sym_ts, self.channels_bn * lh * lw)
        return flat.reshape(batch, self.channels_bn, lh, lw)

    def reconstruct(self, sym_cm: torch.Tensor, th: int, tw: int
                    ) -> np.ndarray:
        """(B, C, lh, lw) symbols -> (B, th, tw, 3) uint8 pixels (host)."""
        rec = self.base.decode_tiles_device(sym_cm)
        return rec[:, :th, :tw, :].cpu().numpy()

    def _decode_group(self, version: int, s: int, th: int, tw: int,
                      raws: List[bytes]) -> np.ndarray:
        if version == HOST_FORMAT:
            return self.base.decode_tiles(raws)
        if version == VERSION:
            sym = self.symbols_from_frames(raws, s, th, tw)
        else:
            sym = self.symbols_from_frames_v3(raws, s, th, tw)
        return self.reconstruct(sym, th, tw)

    def decode_tiles(self, bufs: List[bytes]):
        """Decode a batch of frames, each turbo v4, turbo v3 or host format
        on its own (a writer's fallback is per batch, and reader batches
        need not align with writer batches).  Returns a stacked (B, h, w, 3)
        uint8 array when all tiles share a shape, else a list of arrays, in
        the order of ``bufs``."""
        n = len(bufs)
        if n == 0:
            return np.zeros((0, 0, 0, 3), np.uint8)
        groups = {}  # (version, s, th, tw) -> [(index, raw)]
        for i, raw in enumerate(bufs):
            raw = bytes(raw)
            groups.setdefault(self._parse_header(raw), []).append((i, raw))
        recs: List[Optional[np.ndarray]] = [None] * n
        for key, group in groups.items():
            rec = self._decode_group(*key, [r for _, r in group])
            if len(groups) == 1:
                return rec
            for (i, _), r in zip(group, rec):
                recs[i] = r
        if all(r.shape == recs[0].shape for r in recs):
            return np.stack(recs)
        return recs


class ConvolutionalAutoencoderTurbo(Codec):
    """zarr codec id 'cae_tpu' (device-coded bitstream), serving at the
    precision set when it is built (``ops.convops.set_default_precision``).
    """

    codec_id = "cae_tpu"

    def __init__(self, checkpoint, num_streams: int = DEFAULT_STREAMS,
                 device=None):
        self.checkpoint = checkpoint if isinstance(checkpoint, str) else None
        self.num_streams = num_streams
        self.core = CAETurboCore(
            autoencoder_from_state_dict(checkpoint, device=device),
            num_streams=num_streams, device=device)

    def encode(self, buf) -> bytes:
        buf = np.asarray(buf)
        h, w, _ = buf.shape
        return self.core.encode_tiles(buf[None].astype(np.uint8),
                                      [(h, w)])[0]

    def decode(self, buf, out=None):
        rec = self.core.decode_tiles([bytes(buf)])[0]
        return ndarray_copy(np.ascontiguousarray(rec), out)

    def get_config(self):
        return {"id": self.codec_id, "checkpoint": self.checkpoint,
                "num_streams": self.num_streams}


register_codec(ConvolutionalAutoencoderTurbo)

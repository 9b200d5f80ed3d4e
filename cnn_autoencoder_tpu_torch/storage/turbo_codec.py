"""'cae_tpu' turbo codec: CAE analysis, quantization and rANS coding all on
the device, frame v4.

Bitstream (per chunk, self-framed), byte-identical to the JAX package's:
  '>QQ' true (h, w) pixels, with bit 63 of h set (the turbo marker)
  '>BH' version 4, num_streams S
  '>I'  payload bytes, then one little-endian u16 word queue in decode
        order (2 flush words per stream, stream-major, then refills in
        (step, stream) order)

Three behaviours of the JAX codec are not ported yet and raise instead:
a batch with escapes (the JAX codec writes host 'cae' frames for it),
host-format frames, and legacy v3 frames.
"""

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding.device_rans import (bake_device_tables, decode_interleaved,
                                  encode_states, expected_bits_per_symbol,
                                  pack_streams, stream_channel_map,
                                  unpack_streams)
from ..models.entropy import medians_fn
from ..ops.kernels.rans_kernel import rans_compact
from ..models.factory import autoencoder_from_state_dict
from ..utils.device import resolve_device
from .codecs import (Codec, check_frame_hw, latent_hw, ndarray_copy,
                     padded_hw, register_codec)

VERSION = 4
LEGACY_VERSION = 3
DEFAULT_STREAMS = 1024
TURBO_FLAG = 1 << 63   # set on the big-endian h field of turbo frames


def is_turbo_frame(raw: bytes) -> bool:
    """True iff this chunk buffer is a turbo frame (vs host 'cae' format)."""
    return len(raw) >= 16 and (raw[0] & 0x80) != 0


def _reflect_index(n: int, size: int) -> np.ndarray:
    """Indices that reflect-pad a length-n axis to ``size`` (numpy's
    'reflect' mode, the JAX package's padding of odd tiles)."""
    return np.pad(np.arange(n), (0, size - n), mode="reflect")


class CAETurboCore:
    """Batched device encode/decode of tiles for one CAE model."""

    def __init__(self, model, num_streams: int = DEFAULT_STREAMS,
                 device=None):
        self.device = resolve_device(device)
        if not 1 <= num_streams <= 0xFFFF:
            raise ValueError(f"num_streams {num_streams} does not fit the "
                             "frame's u16 field")
        self.model = model.to(self.device).eval()
        self.level = model.compression_level
        self.channels_bn = model.channels_bn
        self.num_streams = num_streams
        fe = {k: v.detach().cpu().numpy()
              for k, v in model.fact_ent.params().items()}
        self.medians = np.asarray(medians_fn(fe), np.float32)
        tables = bake_device_tables(fe, model.filters)
        # stream padding codes symbol 0, so it must be in every table
        zero = -tables.offset.numpy()
        if not bool(((zero >= 0) & (zero < tables.length.numpy())).all()):
            raise ValueError("turbo tables exclude symbol 0 for some "
                             "channel; stream padding would be uncodable")
        self.expected_bits = expected_bits_per_symbol(tables)
        self.tables = tables.to(self.device)
        self._med = torch.from_numpy(self.medians).to(self.device)
        self._ch_maps = {}
        self.capacity_retries = 0  # compactions re-run at a larger capacity

    # -- geometry -----------------------------------------------------------

    def _ch_map(self, lh: int, lw: int, s: int) -> torch.Tensor:
        key = (lh, lw, s)
        if key not in self._ch_maps:
            self._ch_maps[key] = torch.from_numpy(stream_channel_map(
                self.channels_bn, (lh, lw), s)).to(self.device)
        return self._ch_maps[key]

    def _steps(self, lh: int, lw: int, s: int) -> int:
        return -(-self.channels_bn * lh * lw // s)

    # -- encode -------------------------------------------------------------

    @torch.no_grad()
    def latent_symbols(self, tiles_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, C, lh, lw) int32 quantized latent
        ``round(y - medians)``, channel-major, on the device.  Tiles whose
        sides are not multiples of 2**level are reflect-padded."""
        if not torch.is_tensor(tiles_u8):
            tiles_u8 = torch.from_numpy(np.ascontiguousarray(tiles_u8))
        x = tiles_u8.to(self.device)
        _, h, w, _ = x.shape
        x = x.float() / 255.0
        ph, pw = padded_hw(h, w, self.level)
        if (ph, pw) != (h, w):
            iy = torch.from_numpy(_reflect_index(h, ph)).to(self.device)
            ix = torch.from_numpy(_reflect_index(w, pw)).to(self.device)
            x = x[:, iy][:, :, ix]
        y = self.model.encoder(x)
        sym = torch.round(y - self._med).to(torch.int32)
        return sym.permute(0, 3, 1, 2).contiguous()

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
        totals and uint16 words together) per capacity tried."""
        bsz, _, lh, lw = sym_cm.shape
        s = self.num_streams
        t = self._steps(lh, lw, s)
        esc = self.escapes(sym_cm).sum()
        state = encode_states(pack_streams(sym_cm.reshape(bsz, -1), s),
                              self._ch_map(lh, lw, s), self.tables)
        # first capacity from the tables' entropy (+12% headroom); double on
        # overflow.  The worst case (one word per symbol) always fits.
        capacity = 2 * s + 64 + int(t * s * self.expected_bits / 16.0 * 1.12)
        worst = 2 * s + t * s
        while True:
            cap = min(capacity, worst)
            n_esc, totals, words = self._compact_fetch(state, esc, cap)
            if n_esc:
                raise ValueError(
                    f"{n_esc} latent symbols fall outside the coding tables "
                    "(escapes); the host 'cae' coder that codes such batches "
                    "is not ported yet")
            if int(totals.max()) <= cap:
                return self._frame(words, totals, true_hw)
            self.capacity_retries += 1
            capacity *= 2

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
    def _parse_header(raw: bytes) -> Tuple[int, int, int]:
        """(S, true h, true w) of a v4 turbo frame; raises ValueError on
        anything else."""
        if len(raw) < 16:
            raise ValueError(
                f"corrupt frame: {len(raw)} bytes is shorter than the "
                "16-byte header")
        if not is_turbo_frame(raw):
            raise ValueError(
                "host-format ('cae') frame: the host coder is not ported yet")
        h_field, tw = struct.unpack(">QQ", raw[:16])
        th = h_field & ~TURBO_FLAG
        check_frame_hw(th, tw)
        if len(raw) < 23:
            raise ValueError(
                f"corrupt cae_tpu frame: truncated header ({len(raw)} bytes)")
        version, s = struct.unpack(">BH", raw[16:19])
        if version == LEGACY_VERSION:
            raise ValueError("cae_tpu frame version 3 (legacy per-stream "
                             "layout): its decoder is not ported yet")
        if version != VERSION:
            raise ValueError(f"cae_tpu frame version {version} unsupported "
                             f"(expected {VERSION})")
        if s < 1:
            raise ValueError("corrupt cae_tpu frame: zero stream count")
        return s, th, tw

    def symbols_from_frames(self, raws: Sequence[bytes], s: int, th: int,
                            tw: int) -> torch.Tensor:
        """Decode same-geometry v4 frames -> (B, C, lh, lw) int32 symbols
        on the device."""
        ph, pw = padded_hw(th, tw, self.level)
        lh, lw = latent_hw(ph, pw, self.level)
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

    @torch.no_grad()
    def reconstruct(self, sym_cm: torch.Tensor, th: int, tw: int
                    ) -> np.ndarray:
        """(B, C, lh, lw) symbols -> (B, th, tw, 3) uint8 pixels (host)."""
        y = sym_cm.permute(0, 2, 3, 1).float() + self._med
        x_r, _ = self.model.decoder(y)
        rec = torch.clamp(x_r[0] * 255.0, 0, 255).to(torch.uint8)
        return rec[:, :th, :tw, :].cpu().numpy()

    def decode_tiles(self, bufs: List[bytes]):
        """Decode a batch of frames.  Returns a stacked (B, h, w, 3) uint8
        array when all tiles share a shape, else a list of arrays."""
        n = len(bufs)
        if n == 0:
            return np.zeros((0, 0, 0, 3), np.uint8)
        groups = {}  # (s, th, tw) -> [(index, raw)]
        for i, raw in enumerate(bufs):
            raw = bytes(raw)
            groups.setdefault(self._parse_header(raw), []).append((i, raw))
        recs: List[Optional[np.ndarray]] = [None] * n
        for (s, th, tw), group in groups.items():
            sym = self.symbols_from_frames([r for _, r in group], s, th, tw)
            rec = self.reconstruct(sym, th, tw)
            if len(groups) == 1:
                return rec
            for (i, _), r in zip(group, rec):
                recs[i] = r
        if all(r.shape == recs[0].shape for r in recs):
            return np.stack(recs)
        return recs


class ConvolutionalAutoencoderTurbo(Codec):
    """zarr codec id 'cae_tpu' (device-coded bitstream)."""

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

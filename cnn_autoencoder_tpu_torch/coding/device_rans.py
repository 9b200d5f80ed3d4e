"""On-device interleaved rANS of cae_tpu frames: tables and stream layout.

The latent of a tile is split into S interleaved streams (flattened
channel-major symbol p goes to stream p % S at step p // S), every stream
runs a word-wise rANS-32/16 with 12-bit probabilities, and in frame v4 the
words of all streams share one queue per tile in decode order.  Escapes
(symbols outside a channel's table) are not coded: callers count them and
code such a batch with the host coder instead.

``encode_interleaved`` / ``decode_interleaved`` keep the contract of the JAX
package's ``encode_device_interleaved`` / ``decode_device_interleaved``
(uint16 words and queues); they run the kernels of
``ops/kernels/rans_kernel.py`` on CUDA tensors and the plain versions there
on CPU tensors.  ``encode_states`` and ``rans_compact`` are the encode's
two passes, for callers that may compact one state pass at several
capacities.

``encode_device`` / ``decode_device`` are the legacy per-stream layout of
frame v3 (one word buffer per stream and a length table), plain PyTorch on
any device as the JAX package's are XLA scans: the codec decodes v3 frames
that older stores hold and writes none; the writer serves tests.
"""

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.rans_kernel import (MASK, PRECISION, PROB_SCALE,
                                       STATE_MIN, EncodeState, _as_uint16,
                                       _from_uint16, _unpack_flags,
                                       pack_dec_lut, rans_compact,
                                       rans_decode, rans_encode_states,
                                       rans_encode_states_plain)
from . import xla_f32
from .cdf import pmf_to_quantized_cdf


class DeviceTables(NamedTuple):
    """Per-channel coding tables."""
    freq: torch.Tensor     # (C, L) int32
    start: torch.Tensor    # (C, L) int32
    slot: torch.Tensor     # (C, 4096) int32: cum -> symbol value index
    offset: torch.Tensor   # (C,) int32
    length: torch.Tensor   # (C,) int32: true pmf length (rows past it are
    #                        freq=1 padding, never valid)
    support: int           # L = max(length)

    def to(self, device) -> "DeviceTables":
        return self._replace(**{k: getattr(self, k).to(device)
                                for k in ("freq", "start", "slot", "offset",
                                          "length")})


def bake_device_tables(params: Dict[str, np.ndarray], filters: Sequence[int],
                       extra_support: int = 8) -> DeviceTables:
    """12-bit tables over a widened quantile support (CPU tensors).

    The JAX package's ``bake_device_tables``, with its logit chain and its
    logistic computed by ``coding/xla_f32.py`` as XLA's CPU backend and
    numpy compute them in float32, bit for bit, so the tables of the two
    packages are element-equal for any parameters."""
    params = {k: np.asarray(v) for k, v in params.items()}
    quantiles = params["quantiles"]
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64),
                     0, None) + extra_support
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64),
                     0, None) + extra_support
    offset = (-minima).astype(np.int32)
    pmf_length = (maxima + minima + 1).astype(np.int64)
    max_length = int(pmf_length.max())
    if max_length > 255:
        raise ValueError(
            f"device rANS supports <=255 symbol values/channel (packed LUT "
            f"val field); got {max_length}")

    samples = (np.arange(max_length, dtype=np.float32)[:, None]
               + (medians - minima)[None, :])
    num_filters = len(filters)
    lower = xla_f32.logits_cumulative(params, samples - 0.5, num_filters)
    upper = xla_f32.logits_cumulative(params, samples + 0.5, num_filters)
    pmf = xla_f32.interval_pmf(lower, upper).T  # (C, L)

    channels = pmf.shape[0]
    freq = np.zeros((channels, max_length), np.int32)
    start = np.zeros((channels, max_length), np.int32)
    slot = np.zeros((channels, PROB_SCALE), np.int32)
    for c in range(channels):
        n = int(pmf_length[c])
        prob = pmf[c, :n].astype(np.float64)
        prob = prob / prob.sum()
        cdf = pmf_to_quantized_cdf(prob, PRECISION)
        f = np.diff(cdf)
        freq[c, :n] = f
        start[c, :n] = cdf[:-1]
        freq[c, n:] = 1  # padding keeps the division well-defined
        slot[c] = np.repeat(np.arange(n), f)

    return DeviceTables(freq=torch.from_numpy(freq),
                        start=torch.from_numpy(start),
                        slot=torch.from_numpy(slot),
                        offset=torch.from_numpy(offset),
                        length=torch.from_numpy(pmf_length.astype(np.int32)),
                        support=max_length)


def expected_bits_per_symbol(tables: DeviceTables) -> float:
    """Mean source entropy (bits/symbol) under the baked tables, used to
    size the first encode capacity."""
    freq = tables.freq.cpu().numpy().astype(np.float64)
    length = tables.length.cpu().numpy()
    bits = []
    for c in range(freq.shape[0]):
        p = freq[c, :length[c]] / PROB_SCALE
        p = p[p > 0]
        bits.append(float(-(p * np.log2(p)).sum()))
    return float(np.mean(bits))


def stream_channel_map(num_channels: int, latent_hw: Tuple[int, int],
                       num_streams: int) -> np.ndarray:
    """(T, S) channel index per (step, stream) for a channel-major latent;
    the total is padded up to S*T with the last channel."""
    h, w = latent_hw
    n = num_channels * h * w
    s = num_streams
    t = -(-n // s)
    p = np.arange(s * t)
    ch = np.minimum(p // (h * w), num_channels - 1).astype(np.int32)
    return ch.reshape(t, s)


def pack_streams(symbols_flat: torch.Tensor, num_streams: int
                 ) -> torch.Tensor:
    """(B, N) channel-major symbols -> (B, T, S) interleaved, zero-padded."""
    b, n = symbols_flat.shape
    s = num_streams
    t = -(-n // s)
    pad = s * t - n
    if pad:
        symbols_flat = torch.nn.functional.pad(symbols_flat, (0, pad))
    return symbols_flat.reshape(b, t, s)


def unpack_streams(sym_ts: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, S) -> (B, N)."""
    return sym_ts.reshape(sym_ts.shape[0], -1)[:, :n]


def encode_states(symbols: torch.Tensor, channel_map: torch.Tensor,
                  tables: DeviceTables) -> EncodeState:
    """The encode's state pass over (B, T, S) int32 symbols."""
    return rans_encode_states(symbols.contiguous(), channel_map, tables.freq,
                              tables.start, tables.offset)


def encode_interleaved(symbols: torch.Tensor, channel_map: torch.Tensor,
                       tables: DeviceTables, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (B, T, S) int32 symbols -> ((B, capacity) uint16 words in
    decode order, (B,) int32 total words).  The caller checks escapes and
    ``totals <= capacity``."""
    return rans_compact(encode_states(symbols, channel_map, tables),
                        capacity)


def decode_interleaved(queues: torch.Tensor, channel_map: torch.Tensor,
                       tables: DeviceTables, num_steps: int) -> torch.Tensor:
    """Decode (B, Q) uint16 word queues -> (B, T, S) int32 symbols.  Reads
    past a (corrupt or truncated) queue's end take its last word: garbage
    out, no out-of-bounds read."""
    lut = pack_dec_lut(tables.freq, tables.start, tables.slot)
    vals = rans_decode(queues, channel_map, lut, num_steps)
    return vals + tables.offset[channel_map][None]


# -- frame v3: one word buffer per stream -------------------------------------


def encode_device(symbols: torch.Tensor, channel_map: torch.Tensor,
                  tables: DeviceTables, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame v3 writer: (B, T, S) int32 symbols -> ((B, S, capacity) uint16
    words, (B, S) int32 lengths in words with the 2 flush words, escape
    count).  Each stream's words lie in its decode order; words past
    ``capacity`` are dropped.  The caller checks ``escapes == 0`` and
    ``lengths.max() <= capacity``."""
    b, t, s = symbols.shape
    v = symbols - tables.offset[channel_map][None]
    esc = ((v < 0) | (v >= tables.length[channel_map][None])).sum()
    state = rans_encode_states_plain(symbols, channel_map, tables.freq,
                                     tables.start, tables.offset)
    flags = _unpack_flags(state.flags, t, s).long()          # (B, T, S)
    # the decoder reads a stream's words forward, one per refill
    pos = 2 + torch.cumsum(flags, dim=1) - flags
    pos = torch.where((flags > 0) & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    buf = torch.zeros((b, s, capacity + 1), dtype=torch.int64,
                      device=symbols.device)
    buf.scatter_(2, pos.transpose(1, 2),
                 (_from_uint16(state.words) * flags).transpose(1, 2))
    x = state.final.long() & 0xFFFFFFFF
    buf[:, :, 0] = x & 0xFFFF
    buf[:, :, 1] = x >> 16
    lengths = (2 + flags.sum(dim=1)).to(torch.int32)
    return _as_uint16(buf[:, :, :capacity]), lengths, esc


def decode_device(bufs: torch.Tensor, channel_map: torch.Tensor,
                  tables: DeviceTables, num_steps: int) -> torch.Tensor:
    """Frame v3 reader: (B, S, cap) uint16 word buffers -> (B, T, S) int32
    symbols: T steps of one LUT gather and one refill over (B, S).  A read
    past a buffer's end takes its last word (garbage out, no out-of-bounds
    read)."""
    b, s, cap = bufs.shape
    dev = bufs.device
    words = _from_uint16(bufs)
    lut = pack_dec_lut(tables.freq, tables.start,
                       tables.slot).reshape(-1).long() & 0xFFFFFFFF
    x = words[:, :, 0] | (words[:, :, 1] << 16)
    pos = torch.full((b, s, 1), 2, dtype=torch.int64, device=dev)
    out = torch.empty((b, num_steps, s), dtype=torch.int32, device=dev)
    for t in range(num_steps):
        cum = x & MASK
        p = lut[channel_map[t].long()[None] * PROB_SCALE + cum]
        out[:, t] = (p >> 24).to(torch.int32)
        x = (((p & MASK) + 1) * (x >> PRECISION) + cum
             - ((p >> PRECISION) & MASK)) & 0xFFFFFFFF
        take = torch.gather(words, 2, pos.clamp(max=cap - 1))[..., 0]
        need = x < STATE_MIN
        x = torch.where(need, ((x << 16) | take) & 0xFFFFFFFF, x)
        pos = pos + need[..., None].long()
    return out + tables.offset[channel_map][None]

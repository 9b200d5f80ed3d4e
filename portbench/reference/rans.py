"""The reference's reader of cae_tpu frames (version 4), in numpy.

A frame is ``'>QQ'`` true (h, w) with bit 63 of h set, ``'>BH'`` version
and stream count S, ``'>I'`` payload bytes, then one queue of
little-endian uint16 words in decode order: two flush words a stream
(stream-major), then the refills in (step, stream) order.  The tile's
channel-major latent (C, h / 2^L, w / 2^L) is split over the S streams
(symbol p to stream p % S at step p // S); every stream decodes
rANS-32/16 with 12-bit probabilities from tables baked from the
bottleneck's parameters (``bake_tables``: the quantile support widened by
8, the pmf by the JAX codec's float32 arithmetic, ``xla_f32.py``, and
``cdf.py``'s quantization).  A stream starts from its flush words and
ends, when the frame is sound, at the encoder's initial state 2^16 with
every word of the queue read.
"""

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import xla_f32
from .cdf import pmf_to_quantized_cdf

PRECISION = 12
PROB_SCALE = 1 << PRECISION
MASK = PROB_SCALE - 1
STATE_MIN = 1 << 16
VERSION = 4
TURBO_FLAG = 1 << 63
HEADER_BYTES = 23


def bake_tables(fe: Dict[str, np.ndarray], num_filters: int,
                extra_support: int = 8) -> Dict[str, np.ndarray]:
    """``freq``, ``start`` (C, L), ``slot`` (C, 4096) and ``offset`` (C,)
    of the frames' coder, from the bottleneck's parameters (numpy)."""
    fe = {k: np.asarray(v, np.float32) for k, v in fe.items()}
    q = fe["quantiles"]
    med = q[:, 0, 1]
    minima = np.clip(np.ceil(med - q[:, 0, 0]).astype(np.int64), 0,
                     None) + extra_support
    maxima = np.clip(np.ceil(q[:, 0, 2] - med).astype(np.int64), 0,
                     None) + extra_support
    length = maxima + minima + 1
    support = int(length.max())
    samples = (np.arange(support, dtype=np.float32)[:, None]
               + (med - minima)[None, :])
    lower = xla_f32.logits_cumulative(fe, samples - 0.5, num_filters)
    upper = xla_f32.logits_cumulative(fe, samples + 0.5, num_filters)
    pmf = xla_f32.interval_pmf(lower, upper).T
    c_n = pmf.shape[0]
    freq = np.ones((c_n, support), np.int64)
    start = np.zeros((c_n, support), np.int64)
    slot = np.zeros((c_n, PROB_SCALE), np.int64)
    for c in range(c_n):
        n = int(length[c])
        prob = pmf[c, :n].astype(np.float64)
        cdf = pmf_to_quantized_cdf(prob / prob.sum(), PRECISION)
        freq[c, :n] = np.diff(cdf)
        start[c, :n] = cdf[:-1]
        slot[c] = np.repeat(np.arange(n), np.diff(cdf))
    return {"freq": freq, "start": start, "slot": slot,
            "offset": -minima.astype(np.int64)}


def parse(frame: bytes) -> Tuple[int, int, int, np.ndarray]:
    """(true h, true w, S, uint16 words) of a v4 frame; raises ValueError
    on any other buffer."""
    if len(frame) < HEADER_BYTES or not frame[0] & 0x80:
        raise ValueError("not a cae_tpu frame")
    h_field, tw = struct.unpack(">QQ", frame[:16])
    version, s = struct.unpack(">BH", frame[16:19])
    if version != VERSION or s < 1:
        raise ValueError(f"cae_tpu frame version {version}, S {s}")
    (nbytes,) = struct.unpack(">I", frame[19:HEADER_BYTES])
    payload = frame[HEADER_BYTES:]
    if len(payload) != nbytes or nbytes % 2:
        raise ValueError("cae_tpu frame payload does not match its header")
    return (h_field & ~TURBO_FLAG, tw, s,
            np.frombuffer(payload, "<u2").astype(np.int64))


def decode(frames: Sequence[bytes], tables: Dict[str, np.ndarray],
           channels: int, level: int) -> Tuple[np.ndarray, np.ndarray]:
    """Frames of one geometry -> ((B, C, h, w) int64 symbols, (B,) bool:
    the frame is sound, every stream ending at 2^16 with its queue read to
    the end).  A frame that does not parse, or has another geometry than
    the first, decodes to no symbols and is not sound."""
    parsed: List = []
    for f in frames:
        try:
            parsed.append(parse(bytes(f)))
        except ValueError:
            parsed.append(None)
    first = next((p for p in parsed if p is not None), None)
    if first is None:
        raise ValueError("no frame of the batch parses")
    th, tw, s = first[:3]
    side = 1 << level
    lh, lw = -(-th // side), -(-tw // side)
    n = channels * lh * lw
    t_n = -(-n // s)
    good = np.array([p is not None and p[:3] == (th, tw, s) for p in parsed])
    b = len(frames)
    qlen = max(len(p[3]) for p, ok in zip(parsed, good) if ok)
    words = np.zeros((b, qlen + 1), np.int64)
    totals = np.zeros(b, np.int64)
    for i, (p, ok) in enumerate(zip(parsed, good)):
        if ok:
            words[i, :len(p[3])] = p[3]
            totals[i] = len(p[3])
    ch_map = np.minimum(np.arange(s * t_n) // (lh * lw),
                        channels - 1).reshape(t_n, s)
    sidx = np.arange(s)
    first_w = np.minimum(2 * sidx, qlen)
    x = words[:, first_w] | (words[:, np.minimum(2 * sidx + 1, qlen)] << 16)
    pos = np.full(b, 2 * s, np.int64)
    out = np.empty((b, t_n, s), np.int64)
    freq, start, slot, offset = (tables[k] for k in
                                 ("freq", "start", "slot", "offset"))
    rows = np.arange(b)[:, None]
    for t in range(t_n):
        ch = ch_map[t][None, :]
        cum = x & MASK
        idx = slot[ch, cum]
        out[:, t] = idx + offset[ch]
        x = freq[ch, idx] * (x >> PRECISION) + cum - start[ch, idx]
        need = x < STATE_MIN
        rank = np.cumsum(need, axis=1) - need
        take = words[rows, np.minimum(pos[:, None] + rank, qlen)]
        x = np.where(need, (x << 16) | take, x)
        pos = pos + need.sum(axis=1)
    sound = good & (pos == totals) & (x == STATE_MIN).all(axis=1)
    sym = out.reshape(b, -1)[:, :n].reshape(b, channels, lh, lw)
    return sym, sound

"""Plain Python rANS coder (the host 'cae' bitstream).

The port's own copy of the JAX package's ``coding/_rans_py.py``: the 64-bit
rANS entropy coder with 4-bit bypass escape coding that the C++ coder of
``csrc/rans.cpp`` implements,

* 16-bit probability precision, CDF tables from
  ``models/entropy.py:update_cdf_tables``;
* out-of-range values escape through the final CDF bucket and are coded as
  4-bit bypass chunks (unary-ish chunk-count prefix, then LSB-first chunks);
* symbols are rANS-coded in reverse, 32-bit renormalization words are written
  back-to-front, the final 64-bit state is flushed as two little-endian
  words at the stream head.

It is the plain version the tests and ``chip_smoke.py`` hold the C++ coder
to, byte for byte; no path of the codecs runs it.  It costs microseconds a
symbol.

Below it, numpy versions of the C++ coder's other entries, held to them in
the tests: the interleaved rANS-32/16 word queue of frame v4 (``ilv_*``,
12-bit tables, at most 256 values a channel, no escapes) and the pixel
transport's predictors, its single-table queue (``pixel_rans_*``: zigzag
residuals padded with zeros to whole steps and coded as one channel of 256
values) and the bit-plane packer's inverse (``pixel_unpack_blocks``).
"""

import struct
from bisect import bisect_right

import numpy as np

PRECISION = 16
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1
RANS64_L = 1 << 31
MASK32 = (1 << 32) - 1


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    syms = []  # (start_or_val, range, is_bypass)
    for s, idx in zip(symbols, indexes):
        cdf = cdfs[idx]
        max_value = cdf_lengths[idx] - 2
        value = int(s) - int(offsets[idx])
        raw_val = 0
        if value < 0:
            raw_val = -2 * value - 1
            value = max_value
        elif value >= max_value:
            raw_val = 2 * (value - max_value)
            value = max_value
        syms.append((int(cdf[value]), int(cdf[value + 1] - cdf[value]), False))

        if value == max_value:
            n_bypass = 0
            while (raw_val >> (BYPASS_PRECISION * n_bypass)) != 0:
                n_bypass += 1
            val = n_bypass
            while val >= MAX_BYPASS_VAL:
                syms.append((MAX_BYPASS_VAL, 0, True))
                val -= MAX_BYPASS_VAL
            syms.append((val, 0, True))
            for j in range(n_bypass):
                val = (raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL
                syms.append((val, 0, True))

    state = RANS64_L
    words = []  # renorm words in emission order (reverse symbol order)
    for start, rng, bypass in reversed(syms):
        if bypass:
            x_max = (RANS64_L >> BYPASS_PRECISION) << 32
            if state >= x_max:
                words.append(state & MASK32)
                state >>= 32
            state = (state << BYPASS_PRECISION) | start
        else:
            x_max = ((RANS64_L >> PRECISION) << 32) * rng
            if state >= x_max:
                words.append(state & MASK32)
                state >>= 32
            state = ((state // rng) << PRECISION) + (state % rng) + start

    out_words = [state & MASK32, (state >> 32) & MASK32] + words[::-1]
    return struct.pack("<%dI" % len(out_words), *out_words)


def decode_with_indexes(data: bytes, indexes, cdfs, cdf_lengths, offsets):
    n_words = len(data) // 4
    words = struct.unpack("<%dI" % n_words, data[:4 * n_words])
    pos = 2
    state = words[0] | (words[1] << 32)
    mask = (1 << PRECISION) - 1

    def get_bits(nbits):
        nonlocal state, pos
        val = state & ((1 << nbits) - 1)
        state >>= nbits
        if state < RANS64_L:
            state = (state << 32) | words[pos]
            pos += 1
        return val

    output = []
    for idx in indexes:
        cdf = cdfs[idx]
        cdf_length = int(cdf_lengths[idx])
        max_value = cdf_length - 2
        cum = state & mask
        value = bisect_right(cdf, cum, 0, cdf_length) - 1
        start = int(cdf[value])
        freq = int(cdf[value + 1]) - start
        state = freq * (state >> PRECISION) + cum - start
        if state < RANS64_L:
            state = (state << 32) | words[pos]
            pos += 1

        if value == max_value:
            val = get_bits(BYPASS_PRECISION)
            n_bypass = val
            while val == MAX_BYPASS_VAL:
                val = get_bits(BYPASS_PRECISION)
                n_bypass += val
            raw_val = 0
            for j in range(n_bypass):
                raw_val |= get_bits(BYPASS_PRECISION) << (j * BYPASS_PRECISION)
            value = raw_val >> 1
            if raw_val & 1:
                value = -value - 1
            else:
                value += max_value

        output.append(value + int(offsets[idx]))
    return output


# -- interleaved (frame-v4) queues ------------------------------------------

ILV_PRECISION = 12
ILV_PROB_SCALE = 1 << ILV_PRECISION
ILV_STATE_MIN = 1 << 16
ILV_EMIT_SHIFT = 20
ILV_MAX_VALUES = 256


def _ilv_steps(a, n, num_streams, fill):
    """(n,) per-symbol values -> (T, S) in step-major order, ``fill`` past
    n."""
    t = -(-n // num_streams)
    out = np.full(t * num_streams, fill, a.dtype)
    out[:n] = a
    return out.reshape(t, num_streams)


def ilv_encode(symbols, indexes, freqs, starts, lengths, offsets,
               num_streams: int) -> np.ndarray:
    """Symbol i goes to stream i % S at step i // S; returns the uint16
    queue: 2 flush words a stream (low, high; stream-major), then every
    refill word in (step, stream) order, as ``csrc/rans.cpp:ilv_encode``."""
    sym = np.asarray(symbols, np.int64).ravel()
    idx = np.asarray(indexes, np.int64).ravel()
    lengths = np.asarray(lengths, np.int64)
    if (lengths[idx] > ILV_MAX_VALUES).any():
        raise ValueError("interleaved rANS supports <=256 values/channel")
    v = sym - np.asarray(offsets, np.int64)[idx]
    if ((v < 0) | (v >= lengths[idx])).any():
        raise ValueError("symbol outside its channel support")
    n, s = sym.shape[0], num_streams
    f = _ilv_steps(np.asarray(freqs, np.int64)[idx, v], n, s, 1)
    st = _ilv_steps(np.asarray(starts, np.int64)[idx, v], n, s, 0)
    live = _ilv_steps(np.ones(n, bool), n, s, False)
    x = np.full(s, ILV_STATE_MIN, np.int64)
    words_rev = []
    for step in range(f.shape[0] - 1, -1, -1):
        fs = f[step]
        e = live[step] & ((x >> ILV_EMIT_SHIFT) >= fs)
        # written back to front: a step's words lie in ascending stream
        # order, the steps in ascending order
        words_rev.append(x[e] & 0xFFFF)
        x[e] >>= 16
        x = np.where(live[step],
                     ((x // fs) << ILV_PRECISION) + x % fs + st[step], x)
    flush = np.empty(2 * s, np.int64)
    flush[0::2] = x & 0xFFFF
    flush[1::2] = x >> 16
    return np.concatenate([flush] + words_rev[::-1]).astype(np.uint16)


def ilv_decode(words, indexes, freqs, starts, lengths, offsets,
               num_streams: int) -> np.ndarray:
    """Inverse of ``ilv_encode``: int32 symbols.  Reads past the queue's end
    take zero words, as ``csrc/rans.cpp:ilv_decode``."""
    words = np.asarray(words, np.int64).ravel()
    idx = np.asarray(indexes, np.int64).ravel()
    freqs, starts = np.asarray(freqs, np.int64), np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    if (lengths > ILV_MAX_VALUES).any():
        raise ValueError("interleaved rANS supports <=256 values/channel")
    # cum -> (value, start, freq) per channel; cums no value covers read
    # (0, 0, 1), the C++ LUT's zero entries
    channels = freqs.shape[0]
    lut_v = np.zeros((channels, ILV_PROB_SCALE), np.int64)
    lut_st = np.zeros((channels, ILV_PROB_SCALE), np.int64)
    lut_f = np.ones((channels, ILV_PROB_SCALE), np.int64)
    for c in range(channels):
        for v in range(int(lengths[c])):
            st, f = int(starts[c, v]), int(freqs[c, v])
            lut_v[c, st:st + f], lut_st[c, st:st + f] = v, st
            lut_f[c, st:st + f] = f
    n, s = idx.shape[0], num_streams
    ch = _ilv_steps(idx, n, s, 0)
    live = _ilv_steps(np.ones(n, bool), n, s, False)
    padded = np.zeros(max(words.shape[0], 2 * s), np.int64)
    padded[:words.shape[0]] = words
    x = padded[0:2 * s:2] | (padded[1:2 * s:2] << 16)
    pos = 2 * s
    vals = np.zeros(ch.shape, np.int64)
    for step in range(ch.shape[0]):
        c, a = ch[step], live[step]
        cum = x & (ILV_PROB_SCALE - 1)
        vals[step] = lut_v[c, cum]
        y = lut_f[c, cum] * (x >> ILV_PRECISION) + cum - lut_st[c, cum]
        need = a & (y < ILV_STATE_MIN)
        k = int(need.sum())
        take = np.zeros(s, np.int64)
        # a step's streams take their refill words in ascending order
        got = padded[pos:pos + k]
        take[need] = np.pad(got, (0, k - got.shape[0]))
        pos += k
        x = np.where(a, np.where(need, (y << 16) | take, y), x)
    out = vals.reshape(-1)[:n] + np.asarray(offsets, np.int64)[idx]
    return out.astype(np.int32)


# -- the pixel transport ----------------------------------------------------


def pixel_predict_zigzag(tiles_u8, mode: int = 0) -> np.ndarray:
    """(B, P, Q, C) uint8 -> zigzag residuals (uint8), per channel, mod
    256: mode 0 the hybrid predictor (left; up for column 0; (0, 0) raw),
    mode 1 the plane predictor in separable form (a vertical, then a
    horizontal difference), as ``csrc/rans.cpp:pixel_predict_zigzag``."""
    x = np.asarray(tiles_u8, np.uint8)
    if mode == 1:
        d = x.copy()
        d[:, 1:] = x[:, 1:] - x[:, :-1]              # uint8 wraps mod 256
        r = d.copy()
        r[:, :, 1:] = d[:, :, 1:] - d[:, :, :-1]
    else:
        pred = np.zeros_like(x)
        pred[:, :, 1:] = x[:, :, :-1]
        pred[:, 1:, 0] = x[:, :-1, 0]
        r = x - pred
    s = r.view(np.int8).astype(np.int32)
    return (((s << 1) ^ (s >> 7)) & 0xFF).astype(np.uint8)


def pixel_unpredict(z, mode: int = 0) -> np.ndarray:
    """Inverse of ``pixel_predict_zigzag``: two prefix sums mod 256."""
    zi = np.asarray(z).astype(np.int64)
    s = (zi >> 1) ^ -(zi & 1)
    if mode == 1:
        return (np.cumsum(np.cumsum(s, axis=2), axis=1) & 0xFF).astype(
            np.uint8)
    # column 0 sums down the rows, the rest of a row across it
    col0 = np.cumsum(s[:, :, :1], axis=1)
    return ((np.cumsum(s, axis=2) - s[:, :, :1] + col0) & 0xFF).astype(
        np.uint8)


def _pixel_table(freq, start):
    return (np.asarray(freq)[None], np.asarray(start)[None],
            np.array([256]), np.array([0]))


def pixel_rans_encode(tiles_u8, freq, start, num_streams: int,
                      mode: int = 0) -> np.ndarray:
    """(B, P, Q, C) uint8 -> the uint16 queue of their zigzag residuals,
    zero-padded to whole steps and coded with one 256-value table, as
    ``csrc/rans.cpp:pixel_rans_encode`` codes them."""
    z = pixel_predict_zigzag(tiles_u8, mode).reshape(-1)
    zs = _ilv_steps(z, z.shape[0], num_streams, 0).reshape(-1)
    return ilv_encode(zs, np.zeros(zs.shape, np.int32),
                      *_pixel_table(freq, start), num_streams)


def pixel_rans_decode(words, freq, start, shape, num_streams: int,
                      mode: int = 0) -> np.ndarray:
    """Inverse of ``pixel_rans_encode``: (B, P, Q, C) uint8 pixels."""
    n = int(np.prod(shape))
    z = ilv_decode(words, np.zeros(n, np.int32), *_pixel_table(freq, start),
                   num_streams)
    return pixel_unpredict(z.reshape(shape), mode)


def pixel_unpack_blocks(words, widths, shape) -> np.ndarray:
    """Inverse of the bit-plane packer (``coding/pixel_pack.py``): uint32
    ``words`` holding each 128-value block's ``widths[i]`` planes of 4
    words, in block order, -> (B, P, Q, C) uint8 pixels (mode-0
    residuals).  Planes past the end of ``words`` read as zero."""
    words = np.asarray(words).view(np.uint32).astype(np.int64)
    widths = np.asarray(widths, np.int64)
    z = np.zeros((widths.shape[0], 128), np.int64)
    off = 0
    lanes = np.arange(32)
    for i, w in enumerate(widths):
        for k in range(int(w)):
            plane = np.zeros(4, np.int64)
            got = words[off:off + 4]
            plane[:got.shape[0]] = got
            z[i] |= (((plane[:, None] >> lanes) & 1) << k).reshape(-1)
            off += 4
    return pixel_unpredict(z.reshape(shape), 0)

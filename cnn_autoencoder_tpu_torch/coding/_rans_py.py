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
"""

import struct
from bisect import bisect_right

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

// Host rANS entropy coder of the 'cae' / 'cae_bn' codecs (and of the
// 'cae_tpu' codec's escape fallback).
//
// 64-bit rANS with 16-bit probability precision and 4-bit bypass escape
// coding: the port's own copy of the JAX package's latent coder
// (cnn_autoencoder_tpu/coding/csrc/rans.cpp), bitstream-identical to it and
// to the Python coder in _rans_py.py.  Only the latent entries are copied;
// the interleaved and pixel-transport entries of that file are not.
//
// The hot entry points are the *_batch functions: they code many independent
// tiles in parallel with OpenMP, and the ctypes binding (rans.py) releases
// the interpreter lock around them.  All entries have C linkage.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRans64L = 1ull << 31;

// Precomputed per-(channel, value) encoder entry: division-free rANS state
// update via the round-up reciprocal (Alverson; the rans64 formulation).
// For freq >= 2:  rcp = ceil(2^(shift+63) / freq) fits 64 bits because
// 2^(shift-1) < freq;  q = floor(x / freq) = mulhi64(x, rcp) >> (shift-1)
// exactly, for all x < 2^64.  For freq == 1, q == x is folded into the
// bias (see build_enc_table).  State update x' = (q << 16) + (x % freq)
// + start  ==  x + q * (2^16 - freq) + start, so cmpl_freq = 2^16 - freq.
struct EncSymbol {
  uint64_t rcp_freq;
  uint32_t bias;
  uint16_t cmpl_freq;
  uint16_t rcp_shift;
  uint32_t freq;  // original freq, for the renorm threshold
};

inline uint64_t mulhi64(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
}

// Build the encoder fast-path table for every (channel, value) pair of the
// regular alphabet (the final escape slot included).  Layout mirrors the
// cdf rows: entry (idx, v) at enc_table[idx * cdf_stride + v], valid for
// v in [0, cdf_lengths[idx] - 1).
void build_enc_table(const uint32_t *cdfs, int64_t cdf_stride,
                     const int32_t *cdf_lengths, int64_t n_channels,
                     EncSymbol *table) {
  for (int64_t c = 0; c < n_channels; ++c) {
    const uint32_t *cdf = cdfs + c * cdf_stride;
    EncSymbol *row = table + c * cdf_stride;
    const int32_t n_sym = cdf_lengths[c] - 1;
    for (int32_t v = 0; v < n_sym; ++v) {
      const uint32_t start = cdf[v];
      const uint32_t freq = cdf[v + 1] - start;
      EncSymbol &s = row[v];
      s.freq = freq;
      if (freq < 2) {
        // q = x exactly: mulhi(x, 2^64-1) = x - 1 for x >= 1 (state is
        // always >= 2^31), and the +1 is folded into bias.
        s.rcp_freq = ~0ull;
        s.rcp_shift = 0;
        s.cmpl_freq = static_cast<uint16_t>((1u << kPrecision) - 1);
        s.bias = start + (1u << kPrecision) - 1;
      } else {
        uint32_t shift = 0;
        while (freq > (1u << shift)) ++shift;
        s.rcp_freq = static_cast<uint64_t>(
            ((static_cast<unsigned __int128>(1) << (shift + 63)) + freq - 1) /
            freq);
        s.rcp_shift = static_cast<uint16_t>(shift - 1);
        s.cmpl_freq = static_cast<uint16_t>((1u << kPrecision) - freq);
        s.bias = start;
      }
    }
  }
}

inline void enc_renorm(uint64_t &x, uint32_t *&ptr, uint32_t freq,
                       uint32_t prec) {
  const uint64_t x_max = ((kRans64L >> prec) << 32) * freq;
  if (x >= x_max) {
    *--ptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
}

inline void enc_put(uint64_t &x, uint32_t *&ptr, uint32_t start,
                    uint32_t freq) {
  enc_renorm(x, ptr, freq, kPrecision);
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t &x, uint32_t *&ptr, uint32_t val,
                         uint32_t nbits) {
  const uint64_t x_max = (kRans64L >> nbits) << 32;
  if (x >= x_max) {
    *--ptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  x = (x << nbits) | val;
}

inline void enc_flush(uint64_t x, uint32_t *&ptr) {
  ptr -= 2;
  ptr[0] = static_cast<uint32_t>(x >> 0);
  ptr[1] = static_cast<uint32_t>(x >> 32);
}

inline uint64_t dec_init(const uint32_t *&ptr, const uint32_t *end) {
  if (ptr + 2 > end) {
    ptr = end;
    return 0;
  }
  uint64_t x = (static_cast<uint64_t>(ptr[1]) << 32) | ptr[0];
  ptr += 2;
  return x;
}

// Bounds-checked renormalization word fetch: a truncated/corrupt stream
// yields garbage symbols (as any entropy coder must) but never reads past
// the caller's buffer.
inline uint32_t next_word(const uint32_t *&ptr, const uint32_t *end) {
  return (ptr < end) ? *ptr++ : 0u;
}

inline uint32_t dec_get(uint64_t x) {
  return static_cast<uint32_t>(x & ((1u << kPrecision) - 1));
}

inline void dec_advance(uint64_t &x, const uint32_t *&ptr,
                        const uint32_t *end, uint32_t start, uint32_t freq) {
  const uint32_t mask = (1u << kPrecision) - 1;
  x = freq * (x >> kPrecision) + (x & mask) - start;
  if (x < kRans64L) {
    x = (x << 32) | next_word(ptr, end);
  }
}

inline uint32_t dec_get_bits(uint64_t &x, const uint32_t *&ptr,
                             const uint32_t *end, uint32_t nbits) {
  const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
  x >>= nbits;
  if (x < kRans64L) {
    x = (x << 32) | next_word(ptr, end);
  }
  return val;
}

// Encode one tile.  Returns number of bytes written, or -1 on overflow.
//
// Single reverse pass: rANS encodes back-to-front, so instead of
// materializing a forward symbol list and replaying it reversed (two passes
// + a heap vector), each source symbol is visited once in reverse order and
// its bypass chunks are emitted in reversed sub-order.  Bitstream-identical to the two-pass formulation.
int64_t encode_one(const int32_t *symbols, const int32_t *indexes, int64_t n,
                   const uint32_t *cdfs, int64_t cdf_stride,
                   const int32_t *cdf_lengths, const int32_t *offsets,
                   uint8_t *out, int64_t capacity,
                   const EncSymbol *enc_table = nullptr) {
  // Worst case per source symbol: 1 regular + ~11 bypass renorm words.
  if (capacity < (n * 12 + 2) * 4) {
    return -1;
  }

  uint32_t *end = reinterpret_cast<uint32_t *>(out + (capacity & ~int64_t{3}));
  uint32_t *ptr = end;
  uint64_t state = kRans64L;

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    const uint32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    // 64-bit: symbol-offset can exceed int32 and the escape value
    // -2v-1 / 2(v-max) can exceed uint32/2 — avoid overflow UB
    const int64_t value64 =
        static_cast<int64_t>(symbols[i]) - offsets[idx];

    if (value64 >= 0 && value64 < max_value) {
      // fast path: in-range symbol, no bypass
      const int32_t value = static_cast<int32_t>(value64);
      if (enc_table != nullptr) {
        // division-free state update (bitstream-identical to enc_put)
        const EncSymbol &s = enc_table[idx * cdf_stride + value];
        enc_renorm(state, ptr, s.freq, kPrecision);
        const uint64_t q = mulhi64(state, s.rcp_freq) >> s.rcp_shift;
        state = state + s.bias + q * s.cmpl_freq;
      } else {
        enc_put(state, ptr, cdf[value], cdf[value + 1] - cdf[value]);
      }
      continue;
    }

    uint64_t raw_val;
    if (value64 < 0) {
      raw_val = static_cast<uint64_t>(-2 * value64 - 1);
    } else {
      raw_val = static_cast<uint64_t>(2 * (value64 - max_value));
    }
    const int32_t value = max_value;

    // raw_val < 2^33; shifting a 64-bit value by up to 4*9=36 bits is
    // well-defined (a 32-bit shift of 32+ bits is UB and loops on x86)
    int32_t n_bypass = 0;
    while ((raw_val >> (kBypassPrecision * n_bypass)) != 0) {
      ++n_bypass;
    }

    // Forward emission order is: regular sym, count chunks
    // ([15] * (n_bypass/15) then n_bypass%15), then raw chunks LSB-first.
    // Encoding runs reversed: raw chunks MSB-first, count chunks reversed,
    // then the regular symbol.
    for (int32_t j = n_bypass - 1; j >= 0; --j) {
      enc_put_bits(
          state, ptr,
          static_cast<uint32_t>(raw_val >> (j * kBypassPrecision))
              & kMaxBypassVal,
          kBypassPrecision);
    }
    enc_put_bits(state, ptr,
                 static_cast<uint32_t>(n_bypass)
                     % kMaxBypassVal,
                 kBypassPrecision);
    for (int32_t j = 0;
         j < n_bypass / static_cast<int32_t>(kMaxBypassVal); ++j) {
      enc_put_bits(state, ptr, kMaxBypassVal, kBypassPrecision);
    }

    enc_put(state, ptr, cdf[value], cdf[value + 1] - cdf[value]);
  }
  enc_flush(state, ptr);

  const int64_t nbytes =
      static_cast<int64_t>(reinterpret_cast<uint8_t *>(end) -
                           reinterpret_cast<uint8_t *>(ptr));
  std::memmove(out, ptr, static_cast<size_t>(nbytes));
  return nbytes;
}

// Per-channel cum -> value lookup table: 2^16 uint16 entries per channel.
// Collapses the per-symbol linear CDF scan into one L2-resident load (the
// decode loop visits channels in contiguous runs, so the working set is one
// channel's 128 KB slab at a time).  Build cost is ~n_channels * 65536
// writes, amortized over millions of symbols per batch call.
constexpr int64_t kLutSize = 1 << kPrecision;

void build_dec_lut(const uint32_t *cdfs, int64_t cdf_stride,
                   const int32_t *cdf_lengths, int64_t n_channels,
                   uint16_t *lut) {
  for (int64_t c = 0; c < n_channels; ++c) {
    const uint32_t *cdf = cdfs + c * cdf_stride;
    uint16_t *row = lut + c * kLutSize;
    const int32_t n_sym = cdf_lengths[c] - 1;
    int64_t pos = 0;
    for (int32_t v = 0; v < n_sym; ++v) {
      const int64_t hi = (v + 1 < n_sym)
                             ? static_cast<int64_t>(cdf[v + 1])
                             : kLutSize;
      for (; pos < hi && pos < kLutSize; ++pos) {
        row[pos] = static_cast<uint16_t>(v);
      }
    }
    for (; pos < kLutSize; ++pos) {
      row[pos] = static_cast<uint16_t>(n_sym > 0 ? n_sym - 1 : 0);
    }
  }
}

void decode_one(const uint8_t *data, int64_t data_len,
                const int32_t *indexes, int64_t n, const uint32_t *cdfs,
                int64_t cdf_stride, const int32_t *cdf_lengths,
                const int32_t *offsets, int32_t *out,
                const uint16_t *value_lut = nullptr) {
  const uint32_t *ptr = reinterpret_cast<const uint32_t *>(data);
  const uint32_t *end = ptr + (data_len / 4);
  uint64_t state = dec_init(ptr, end);

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t cdf_length = cdf_lengths[idx];
    const int32_t max_value = cdf_length - 2;

    const uint32_t cum = dec_get(state);
    int32_t value;
    if (value_lut != nullptr) {
      value = value_lut[idx * kLutSize + cum];
    } else {
      // Linear scan fallback: CDF tables are short (typically < 64 entries).
      value = 0;
      while (value + 1 < cdf_length && cdf[value + 1] <= cum) {
        ++value;
      }
    }

    const uint32_t start = cdf[value];
    const uint32_t freq = cdf[value + 1] - start;
    dec_advance(state, ptr, end, start, freq);

    if (value == max_value) {
      uint32_t val = dec_get_bits(state, ptr, end, kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec_get_bits(state, ptr, end, kBypassPrecision);
        n_bypass += val;
      }
      uint64_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass && j < 16; ++j) {
        raw_val |= static_cast<uint64_t>(
                       dec_get_bits(state, ptr, end, kBypassPrecision))
                   << (j * kBypassPrecision);
      }
      const int64_t v64 = static_cast<int64_t>(raw_val >> 1);
      int64_t out64;
      if (raw_val & 1) {
        out64 = -v64 - 1;
      } else {
        out64 = v64 + max_value;
      }
      value = static_cast<int32_t>(out64);
    }

    out[i] = value + offsets[idx];
  }
}

// K-way interleaved batch decode: K independent tile streams advance in
// lockstep through one pass over the (shared) index map.  Each tile's
// bitstream and decoded output are identical to decode_one's; interleaving
// only exists to overlap the K serial state-update dependency chains on one
// core (the rANS state update is a ~30-cycle chain; with K=4 the superscalar
// core retires ~3x more symbols/cycle).  Matters where the host has few
// cores, so OpenMP gives little tile parallelism.
template <int K>
void decode_interleaved(const uint8_t *data, const int64_t *data_offsets,
                        const int64_t *data_sizes, const int32_t *indexes,
                        int64_t n, const uint32_t *cdfs, int64_t cdf_stride,
                        const int32_t *cdf_lengths, const int32_t *offsets,
                        int32_t *out, int64_t out_stride,
                        const uint16_t *value_lut) {
  const uint32_t *ptr[K];
  const uint32_t *end[K];
  uint64_t state[K];
  for (int k = 0; k < K; ++k) {
    ptr[k] = reinterpret_cast<const uint32_t *>(data + data_offsets[k]);
    end[k] = ptr[k] + (data_sizes[k] / 4);
    state[k] = dec_init(ptr[k], end[k]);
  }
  constexpr uint32_t mask = (1u << kPrecision) - 1;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t *cdf = cdfs + idx * cdf_stride;
    const uint16_t *lrow = value_lut + idx * kLutSize;
    const int32_t max_value = cdf_lengths[idx] - 2;
    const int32_t off = offsets[idx];
#pragma GCC unroll 8
    for (int k = 0; k < K; ++k) {
      const uint32_t cum = static_cast<uint32_t>(state[k] & mask);
      int32_t value = lrow[cum];
      const uint32_t start = cdf[value];
      const uint32_t freq = cdf[value + 1] - start;
      dec_advance(state[k], ptr[k], end[k], start, freq);
      if (value == max_value) {  // rare: escape/bypass symbol
        uint32_t val = dec_get_bits(state[k], ptr[k], end[k],
                                    kBypassPrecision);
        uint32_t n_bypass = val;
        while (val == kMaxBypassVal) {
          val = dec_get_bits(state[k], ptr[k], end[k], kBypassPrecision);
          n_bypass += val;
        }
        uint64_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass && j < 16; ++j) {
          raw_val |= static_cast<uint64_t>(dec_get_bits(
                         state[k], ptr[k], end[k], kBypassPrecision))
                     << (j * kBypassPrecision);
        }
        const int64_t v64 = static_cast<int64_t>(raw_val >> 1);
        value = static_cast<int32_t>((raw_val & 1) ? -v64 - 1
                                                   : v64 + max_value);
      }
      out[k * out_stride + i] = value + off;
    }
  }
}

// K-way interleaved batch encode mirror (reverse pass; bitstreams per tile
// identical to encode_one's).  Returns false on any buffer overflow.
template <int K>
bool encode_interleaved(const int32_t *symbols, int64_t sym_stride,
                        const int32_t *indexes, int64_t n,
                        const uint32_t *cdfs, int64_t cdf_stride,
                        const int32_t *cdf_lengths, const int32_t *offsets,
                        uint8_t *out, int64_t out_capacity,
                        int64_t *out_sizes, const EncSymbol *enc_table) {
  if (out_capacity < (n * 12 + 2) * 4) {
    return false;
  }
  uint32_t *end[K];
  uint32_t *ptr[K];
  uint64_t state[K];
  for (int k = 0; k < K; ++k) {
    end[k] = reinterpret_cast<uint32_t *>(out + k * out_capacity +
                                          (out_capacity & ~int64_t{3}));
    ptr[k] = end[k];
    state[k] = kRans64L;
  }

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    const int64_t row = idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    const int32_t off = offsets[idx];
#pragma GCC unroll 8
    for (int k = 0; k < K; ++k) {
      const int64_t value64 =
          static_cast<int64_t>(symbols[k * sym_stride + i]) - off;
      if (value64 >= 0 && value64 < max_value) {
        const EncSymbol &s = enc_table[row + value64];
        enc_renorm(state[k], ptr[k], s.freq, kPrecision);
        const uint64_t q = mulhi64(state[k], s.rcp_freq) >> s.rcp_shift;
        state[k] = state[k] + s.bias + q * s.cmpl_freq;
        continue;
      }
      // rare: escape + bypass chunks (same emission order as encode_one)
      uint64_t raw_val = (value64 < 0)
                             ? static_cast<uint64_t>(-2 * value64 - 1)
                             : static_cast<uint64_t>(2 * (value64 - max_value));
      int32_t n_bypass = 0;
      while ((raw_val >> (kBypassPrecision * n_bypass)) != 0) {
        ++n_bypass;
      }
      for (int32_t j = n_bypass - 1; j >= 0; --j) {
        enc_put_bits(state[k], ptr[k],
                     static_cast<uint32_t>(raw_val >> (j * kBypassPrecision))
                         & kMaxBypassVal,
                     kBypassPrecision);
      }
      enc_put_bits(state[k], ptr[k],
                   static_cast<uint32_t>(n_bypass) % kMaxBypassVal,
                   kBypassPrecision);
      for (int32_t j = 0;
           j < n_bypass / static_cast<int32_t>(kMaxBypassVal); ++j) {
        enc_put_bits(state[k], ptr[k], kMaxBypassVal, kBypassPrecision);
      }
      const uint32_t *cdf = cdfs + row;
      enc_put(state[k], ptr[k], cdf[max_value],
              cdf[max_value + 1] - cdf[max_value]);
    }
  }
  for (int k = 0; k < K; ++k) {
    enc_flush(state[k], ptr[k]);
    const int64_t nbytes = static_cast<int64_t>(
        reinterpret_cast<uint8_t *>(end[k]) -
        reinterpret_cast<uint8_t *>(ptr[k]));
    std::memmove(out + k * out_capacity, ptr[k],
                 static_cast<size_t>(nbytes));
    out_sizes[k] = nbytes;
  }
  return true;
}

}  // namespace

extern "C" {

int64_t rans_encode_with_indexes(const int32_t *symbols,
                                 const int32_t *indexes, int64_t n,
                                 const uint32_t *cdfs, int64_t cdf_stride,
                                 const int32_t *cdf_lengths,
                                 const int32_t *offsets, uint8_t *out,
                                 int64_t capacity) {
  return encode_one(symbols, indexes, n, cdfs, cdf_stride, cdf_lengths,
                    offsets, out, capacity);
}

void rans_decode_with_indexes(const uint8_t *data, int64_t data_len,
                              const int32_t *indexes, int64_t n,
                              const uint32_t *cdfs, int64_t cdf_stride,
                              const int32_t *cdf_lengths,
                              const int32_t *offsets, int32_t *out) {
  decode_one(data, data_len, indexes, n, cdfs, cdf_stride, cdf_lengths,
             offsets, out);
}

// Batched tile encode: `batch` tiles, each of `n` symbols, sharing one index
// map (per-channel CDFs).  Output buffers are pre-sliced at `capacity` bytes
// per tile; per-tile byte counts land in `out_sizes`.  OpenMP-parallel.
int32_t rans_encode_batch(const int32_t *symbols, const int32_t *indexes,
                          int64_t batch, int64_t n, const uint32_t *cdfs,
                          int64_t cdf_stride, const int32_t *cdf_lengths,
                          const int32_t *offsets, uint8_t *out,
                          int64_t capacity, int64_t *out_sizes) {
  // channel count = 1 + max index over the (shared) index map
  int64_t n_channels = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (indexes[i] >= n_channels) n_channels = indexes[i] + 1;
  }
  std::vector<EncSymbol> enc_table(
      static_cast<size_t>(n_channels * cdf_stride));
  build_enc_table(cdfs, cdf_stride, cdf_lengths, n_channels,
                  enc_table.data());

  int32_t ok = 1;
  constexpr int64_t kWay = 4;
  const int64_t n_groups = (batch + kWay - 1) / kWay;
#pragma omp parallel for schedule(dynamic)
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t b0 = g * kWay;
    if (b0 + kWay <= batch) {
      if (!encode_interleaved<kWay>(symbols + b0 * n, n, indexes, n, cdfs,
                                    cdf_stride, cdf_lengths, offsets,
                                    out + b0 * capacity, capacity,
                                    out_sizes + b0, enc_table.data())) {
        ok = 0;
      }
    } else {
      for (int64_t b = b0; b < batch; ++b) {
        const int64_t sz = encode_one(symbols + b * n, indexes, n, cdfs,
                                      cdf_stride, cdf_lengths, offsets,
                                      out + b * capacity, capacity,
                                      enc_table.data());
        out_sizes[b] = sz;
        if (sz < 0) {
          ok = 0;
        }
      }
    }
  }
  return ok;
}

// Batched tile decode mirror of rans_encode_batch.
void rans_decode_batch(const uint8_t *data, const int64_t *data_offsets,
                       const int64_t *data_sizes, const int32_t *indexes,
                       int64_t batch, int64_t n, const uint32_t *cdfs,
                       int64_t cdf_stride, const int32_t *cdf_lengths,
                       const int32_t *offsets, int32_t *out) {
  int64_t n_channels = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (indexes[i] >= n_channels) n_channels = indexes[i] + 1;
  }
  // 128 KB per channel; batch decodes run over millions of symbols so the
  // build is amortized, and per-channel access runs keep it L2-resident.
  std::vector<uint16_t> lut(static_cast<size_t>(n_channels * kLutSize));
  build_dec_lut(cdfs, cdf_stride, cdf_lengths, n_channels, lut.data());

  constexpr int64_t kWay = 4;
  const int64_t n_groups = (batch + kWay - 1) / kWay;
#pragma omp parallel for schedule(dynamic)
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t b0 = g * kWay;
    if (b0 + kWay <= batch) {
      decode_interleaved<kWay>(data, data_offsets + b0, data_sizes + b0,
                               indexes, n, cdfs, cdf_stride, cdf_lengths,
                               offsets, out + b0 * n, n, lut.data());
    } else {
      for (int64_t b = b0; b < batch; ++b) {
        decode_one(data + data_offsets[b], data_sizes[b], indexes, n, cdfs,
                   cdf_stride, cdf_lengths, offsets, out + b * n, lut.data());
      }
    }
  }
}

int32_t rans_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

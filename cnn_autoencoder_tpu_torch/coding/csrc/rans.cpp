// Host rANS entropy coder of the 'cae' / 'cae_bn' codecs (and of the
// 'cae_tpu' codec's escape fallback).
//
// 64-bit rANS with 16-bit probability precision and 4-bit bypass escape
// coding: the port's own copy of the JAX package's latent coder
// (cnn_autoencoder_tpu/coding/csrc/rans.cpp), bitstream-identical to it and
// to the Python coder in _rans_py.py, with the interleaved (frame-v4 twin)
// and pixel-transport entries of that file, whose plain numpy versions are
// in _rans_py.py too.
//
// The hot entry points are the *_batch functions: they code many independent
// tiles in parallel with OpenMP, and the ctypes binding (rans.py) releases
// the interpreter lock around them.  All entries have C linkage.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

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

// ---------------------------------------------------------------------------
// Interleaved multi-stream rANS-32/16 at 12-bit precision — the host twin of
// coding/device_rans.py's frame-v4 layout (bit-identical).  S streams advance
// in lockstep over a step-major symbol layout (symbol i belongs to stream
// i % S at step i / S); the 16-bit words sit in one shared queue in global
// decode-consumption order: 2 flush words per stream (stream-major), then
// each refill word in (step, stream) order.  Sequential host code consumes
// streams in exactly that order, so encode is a single reverse pass and
// decode a single forward pass.  No escape coding: encode REJECTS symbols
// outside their channel's support (returns -1) and the caller falls back.

constexpr uint32_t kIlvPrecision = 12;
constexpr uint32_t kIlvProbScale = 1u << kIlvPrecision;
constexpr uint32_t kIlvMask = kIlvProbScale - 1;
constexpr uint32_t kIlvStateMin = 1u << 16;
constexpr uint32_t kIlvEmitShift = 20;

// The interleaved format packs the decoded value index as `v << 24` in a
// uint32 LUT entry, so alphabets are limited to 256 values per channel.
// Guarded here defensively (not only on the Python side) so direct native
// callers cannot produce silently corrupt streams.
constexpr int32_t kIlvMaxValues = 256;

// Returns total words written (including 2*S flush words), or -1 on an
// out-of-support symbol, or -2 on capacity overflow, or -3 on a channel
// alphabet larger than kIlvMaxValues.
int64_t ilv_encode(const int32_t *symbols, const int32_t *indexes, int64_t n,
                   const int32_t *freqs, const int32_t *starts,
                   int64_t table_stride, const int32_t *lengths,
                   const int32_t *offsets, int64_t n_streams, uint16_t *out,
                   int64_t capacity_words) {
  std::vector<uint32_t> state(static_cast<size_t>(n_streams), kIlvStateMin);
  std::vector<uint16_t> scratch(static_cast<size_t>(capacity_words));
  uint16_t *end = scratch.data() + capacity_words;
  uint16_t *ptr = end;

  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t s = i % n_streams;
    const int32_t c = indexes[i];
    // alphabet guard folded into the hot loop (a separate O(n) pre-pass
    // over indexes/lengths cost a full memory sweep per encode)
    if (lengths[c] > kIlvMaxValues) {
      return -3;
    }
    const int64_t v = static_cast<int64_t>(symbols[i]) - offsets[c];
    if (v < 0 || v >= lengths[c]) {
      return -1;  // out of support: no escape coding in this format
    }
    const uint32_t f = static_cast<uint32_t>(freqs[c * table_stride + v]);
    const uint32_t st = static_cast<uint32_t>(starts[c * table_stride + v]);
    uint32_t x = state[s];
    if ((x >> kIlvEmitShift) >= f) {
      if (ptr == scratch.data()) {
        return -2;
      }
      *--ptr = static_cast<uint16_t>(x & 0xFFFF);
      x >>= 16;
    }
    x = ((x / f) << kIlvPrecision) + (x % f) + st;
    state[s] = x;
  }
  for (int64_t s = n_streams - 1; s >= 0; --s) {
    if (ptr - scratch.data() < 2) {
      return -2;
    }
    *--ptr = static_cast<uint16_t>(state[s] >> 16);
    *--ptr = static_cast<uint16_t>(state[s] & 0xFFFF);
  }
  const int64_t total = end - ptr;
  std::memcpy(out, ptr, static_cast<size_t>(total) * 2);
  return total;
}

// Returns 0 on success, -3 on a channel alphabet larger than kIlvMaxValues
// (the packed LUT's value field is 8 bits).
int32_t ilv_decode(const uint16_t *words, int64_t total_words,
                   const int32_t *indexes, int64_t n, const int32_t *freqs,
                   const int32_t *starts, int64_t table_stride,
                   const int32_t *lengths, const int32_t *offsets,
                   int64_t n_channels, int64_t n_streams, int32_t *out) {
  for (int64_t c = 0; c < n_channels; ++c) {
    if (lengths[c] > kIlvMaxValues) {
      return -3;
    }
  }
  // cum -> packed(val<<24 | start<<12 | freq-1) LUT, one slab per channel
  std::vector<uint32_t> lut(
      static_cast<size_t>(n_channels) * kIlvProbScale, 0);
  for (int64_t c = 0; c < n_channels; ++c) {
    uint32_t *row = lut.data() + c * kIlvProbScale;
    for (int64_t v = 0; v < lengths[c]; ++v) {
      const uint32_t f = static_cast<uint32_t>(freqs[c * table_stride + v]);
      const uint32_t st = static_cast<uint32_t>(starts[c * table_stride + v]);
      const uint32_t packed = (static_cast<uint32_t>(v) << 24)
                              | (st << kIlvPrecision) | (f - 1);
      for (uint32_t k = 0; k < f && st + k < kIlvProbScale; ++k) {
        row[st + k] = packed;
      }
    }
  }

  std::vector<uint32_t> state(static_cast<size_t>(n_streams), 0);
  int64_t pos = 0;
  auto next_w = [&]() -> uint32_t {
    return (pos < total_words) ? words[pos++] : 0u;
  };
  for (int64_t s = 0; s < n_streams; ++s) {
    const uint32_t lo = next_w();
    const uint32_t hi = next_w();
    state[s] = lo | (hi << 16);
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = i % n_streams;
    const int32_t c = indexes[i];
    uint32_t x = state[s];
    const uint32_t cum = x & kIlvMask;
    const uint32_t p = lut[c * kIlvProbScale + cum];
    const uint32_t f = (p & kIlvMask) + 1;
    const uint32_t st = (p >> kIlvPrecision) & kIlvMask;
    x = f * (x >> kIlvPrecision) + cum - st;
    if (x < kIlvStateMin) {
      x = (x << 16) | next_w();
    }
    state[s] = x;
    out[i] = static_cast<int32_t>(p >> 24) + offsets[c];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Packed pixel transport: host-side inverse of coding/pixel_pack.py's
// device bit-plane packer.  Blocks of 128 zigzag residuals, each stored as
// `width` bit-planes of 4 uint32 words; after unpacking, un-zigzag and the
// left/up prefix reconstruct the uint8 pixels exactly (all mod-256).

// Spread one byte's 8 bits into 8 bytes (bit i -> byte i, value 0/1).
const uint64_t *bit_spread_lut() {
  static uint64_t lut[256];
  static bool init = false;
  if (!init) {
    for (uint32_t v = 0; v < 256; ++v) {
      uint64_t x = 0;
      for (int i = 0; i < 8; ++i) {
        x |= static_cast<uint64_t>((v >> i) & 1) << (8 * i);
      }
      lut[v] = x;
    }
    init = true;
  }
  return lut;
}

// Shared inverse-transform tail: un-zigzag + spatial prefix, per tile.
// All arithmetic is mod-256 (uint8 wraparound), the exact inverse of the
// device packers' left/up predictor.
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
// AVX-512 row kernel: un-zigzag all bytes, then a stride-c byte prefix
// sum (vpermb byte shifts by c*2^k inside each 64-byte block, one vpermb
// carry broadcast between blocks).  Bytewise adds wrap mod 256, exactly
// like the scalar loop.
struct UnpredictShifts {
  __m512i idx[6];
  __mmask64 mask[6];
  int n;
  __m512i carry_idx;
};

static UnpredictShifts make_unpredict_shifts(int64_t c) {
  UnpredictShifts sh;
  alignas(64) uint8_t buf[64];
  sh.n = 0;
  for (int64_t k = c; k < 64; k <<= 1) {
    for (int64_t j = 0; j < 64; ++j) {
      buf[j] = static_cast<uint8_t>(j >= k ? j - k : 0);
    }
    sh.idx[sh.n] = _mm512_load_si512(buf);
    sh.mask[sh.n] = ~((__mmask64{1} << k) - 1);
    ++sh.n;
  }
  for (int64_t j = 0; j < 64; ++j) {
    buf[j] = static_cast<uint8_t>(64 - c + (j % c));
  }
  sh.carry_idx = _mm512_load_si512(buf);
  return sh;
}

static void unpredict_row_avx512(const uint8_t *zr, uint8_t *orow,
                                 const uint8_t *prev_col0, int64_t len,
                                 int64_t c, const UnpredictShifts &sh) {
  alignas(64) uint8_t sbuf[64];
  const __m512i zero = _mm512_setzero_si512();
  const __m512i lsb = _mm512_set1_epi8(1);
  const __m512i m7f = _mm512_set1_epi8(0x7F);
  __m512i prev = zero;
  int64_t x = 0;
  for (; x + 64 <= len; x += 64) {
    const __m512i z = _mm512_loadu_si512(zr + x);
    // s = (z >> 1) ^ (-(z & 1)) per byte
    __m512i s = _mm512_xor_si512(
        _mm512_and_si512(_mm512_srli_epi16(z, 1), m7f),
        _mm512_sub_epi8(zero, _mm512_and_si512(z, lsb)));
    if (x == 0 && prev_col0 != nullptr) {
      // fold the up-predictor carry into the first c bytes
      _mm512_store_si512(sbuf, s);
      for (int64_t ch = 0; ch < c; ++ch) {
        sbuf[ch] = static_cast<uint8_t>(sbuf[ch] + prev_col0[ch]);
      }
      s = _mm512_load_si512(sbuf);
    }
    // in-block stride-c prefix: element i accumulates i-c, i-2c, ...
    for (int k = 0; k < sh.n; ++k) {
      s = _mm512_add_epi8(
          s, _mm512_maskz_permutexvar_epi8(sh.mask[k], sh.idx[k], s));
    }
    if (x > 0) {
      s = _mm512_add_epi8(s,
                          _mm512_permutexvar_epi8(sh.carry_idx, prev));
    }
    _mm512_storeu_si512(orow + x, s);
    prev = s;
  }
  // ragged tail: scalar, seeded from the last written block
  for (; x < len; ++x) {
    const uint8_t zz = zr[x];
    const uint8_t s =
        static_cast<uint8_t>((zz >> 1) ^ static_cast<uint8_t>(-(zz & 1)));
    const uint8_t left =
        (x >= c) ? orow[x - c]
                 : (prev_col0 != nullptr ? prev_col0[x] : 0);
    orow[x] = static_cast<uint8_t>(s + left);
  }
}
#endif  // __AVX512VBMI__ && __AVX512BW__

// Scalar twin of unpredict_row_avx512: un-zigzag + stride-c byte prefix,
// the first c bytes seeded from prev_col0 (nullptr = zero seed).
static void unpredict_row_scalar(const uint8_t *zr, uint8_t *orow,
                                 const uint8_t *prev_col0, int64_t len,
                                 int64_t c) {
  for (int64_t x = 0; x < len; ++x) {
    const uint8_t zz = zr[x];
    const uint8_t s =
        static_cast<uint8_t>((zz >> 1) ^ static_cast<uint8_t>(-(zz & 1)));
    const uint8_t left =
        (x >= c) ? orow[x - c] : (prev_col0 != nullptr ? prev_col0[x] : 0);
    orow[x] = static_cast<uint8_t>(s + left);
  }
}

// mode 0: hybrid predictor inverse (the original).  mode 1: plane
// predictor inverse — the same zero-seeded horizontal prefix per row,
// then a bytewise add of the previous OUTPUT row (the vertical prefix of
// the separable Dh∘Dv transform; see pixel_predict_zigzag).
static void unzigzag_unpredict_tiles(const uint8_t *z, int64_t b, int64_t p,
                                     int64_t q, int64_t c, uint8_t *out,
                                     int64_t mode) {
  const int64_t tile = p * q * c;
  const int64_t len = q * c;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
  const bool vec_rows = (len >= 64 && c >= 1 && c <= 32);
  const UnpredictShifts sh =
      vec_rows ? make_unpredict_shifts(c) : UnpredictShifts{};
#else
  const bool vec_rows = false;
#endif
  for (int64_t t = 0; t < b; ++t) {
    const uint8_t *zt = z + t * tile;
    uint8_t *ot = out + t * tile;
    for (int64_t y = 0; y < p; ++y) {
      const uint8_t *zr = zt + y * len;
      uint8_t *orow = ot + y * len;
      const uint8_t *prev_out = (y > 0) ? ot + (y - 1) * len : nullptr;
      const uint8_t *seed = (mode == 1) ? nullptr : prev_out;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
      if (vec_rows) {
        unpredict_row_avx512(zr, orow, seed, len, c, sh);
      } else {
        unpredict_row_scalar(zr, orow, seed, len, c);
      }
#else
      unpredict_row_scalar(zr, orow, seed, len, c);
#endif
      if (mode == 1 && prev_out != nullptr) {
        for (int64_t j = 0; j < len; ++j) {  // Cv: bytewise, autovec
          orow[j] = static_cast<uint8_t>(orow[j] + prev_out[j]);
        }
      }
    }
  }
}

// Returns the number of bit-planes that fell past the end of `words`
// (0 = complete buffer).  A truncated buffer still advances the running
// offset by 4 words per declared plane, so every in-range block decodes
// from its correct position; callers must treat a nonzero return as an
// under-sized fetch (the affected planes read as zero).
int64_t pixel_unpack_blocks(const uint32_t *words, int64_t n_words,
                            const uint8_t *widths, int64_t n_blocks,
                            int64_t b, int64_t p, int64_t q, int64_t c,
                            uint8_t *out) {
  const uint64_t *lut = bit_spread_lut();
  const int64_t n = n_blocks * 128;
  std::vector<uint8_t> z(static_cast<size_t>(n), 0);

  int64_t off = 0;
  int64_t truncated = 0;
  for (int64_t i = 0; i < n_blocks; ++i) {
    uint64_t *dst = reinterpret_cast<uint64_t *>(z.data() + i * 128);
    const int w = widths[i];
    for (int k = 0; k < w; ++k) {
      if (off + 4 > n_words) {
        ++truncated;  // plane past the buffer: reads as zero
        off += 4;
        continue;
      }
      for (int m = 0; m < 4; ++m) {
        const uint32_t word = words[off + m];
        // 32 bits -> 32 bytes, each shifted into bit position k
        dst[m * 4 + 0] |= lut[word & 0xFF] << k;
        dst[m * 4 + 1] |= lut[(word >> 8) & 0xFF] << k;
        dst[m * 4 + 2] |= lut[(word >> 16) & 0xFF] << k;
        dst[m * 4 + 3] |= lut[(word >> 24) & 0xFF] << k;
      }
      off += 4;
    }
  }

  unzigzag_unpredict_tiles(z.data(), b, p, q, c, out, 0);
  return truncated;
}

// ---------------------------------------------------------------------------
// rANS pixel transport: entropy-coded form of the same zigzag residuals.
// The device side (coding/pixel_rans.py) computes the left/up-predictor
// residuals, zigzags them and rANS-encodes them with the interleaved
// multi-stream layout (frame-v4 word order, single shared 256-value table);
// this host side decodes the word queue and reconstructs the exact uint8
// pixels in one fused pass.  The mirror direction (compress uploads) runs
// predict+zigzag+encode here and the rANS decode kernel (csrc/rans.cu)
// decodes on the device.

#if defined(__AVX512F__)
// AVX-512 inner loop for the interleaved single-table decode: 16 streams
// per vector, per-step queue refills resolved with a masked expand-load
// (a step consumes its refill words in ascending stream order, exactly
// like the scalar loop, so groups processed in ascending order preserve
// the global word order).  The queue is widened to 32-bit once with a
// 16-element zero slack, which both feeds the expand-load element size
// and keeps truncated-buffer reads in bounds (scalar semantics: reads
// past the end decode as zero words).
static void ilv_pixel_decode_avx512(const uint16_t *words,
                                    int64_t total_words,
                                    const uint32_t *lut, int64_t n,
                                    int64_t n_streams, uint8_t *z) {
  std::vector<uint32_t> w32(static_cast<size_t>(total_words) + 16, 0u);
  for (int64_t k = 0; k < total_words; ++k) w32[k] = words[k];
  std::vector<uint32_t> state(static_cast<size_t>(n_streams));
  int64_t pos = 0;
  for (int64_t s = 0; s < n_streams; ++s) {
    const uint32_t lo = (pos < total_words) ? words[pos++] : 0u;
    const uint32_t hi = (pos < total_words) ? words[pos++] : 0u;
    state[s] = lo | (hi << 16);
  }
  const __m512i vmask = _mm512_set1_epi32(static_cast<int>(kIlvMask));
  const __m512i vone = _mm512_set1_epi32(1);
  const __m512i vmin = _mm512_set1_epi32(static_cast<int>(kIlvStateMin));
  const int64_t full = (n / n_streams) * n_streams;
  const int64_t groups = n_streams / 16;
  int64_t i = 0;
  while (i < full) {
    for (int64_t g = 0; g < groups; ++g, i += 16) {
      __m512i x = _mm512_loadu_si512(state.data() + g * 16);
      const __m512i cum = _mm512_and_si512(x, vmask);
      const __m512i pk = _mm512_i32gather_epi32(cum, lut, 4);
      const __m512i f =
          _mm512_add_epi32(_mm512_and_si512(pk, vmask), vone);
      const __m512i st =
          _mm512_and_si512(_mm512_srli_epi32(pk, 12), vmask);
      x = _mm512_add_epi32(
          _mm512_mullo_epi32(f, _mm512_srli_epi32(x, 12)),
          _mm512_sub_epi32(cum, st));
      const __mmask16 m = _mm512_cmplt_epu32_mask(x, vmin);
      const int64_t rd = (pos < total_words) ? pos : total_words;
      const __m512i w =
          _mm512_maskz_expandloadu_epi32(m, w32.data() + rd);
      x = _mm512_mask_mov_epi32(
          x, m, _mm512_or_si512(_mm512_slli_epi32(x, 16), w));
      pos += _mm_popcnt_u32(static_cast<unsigned>(m));
      _mm512_storeu_si512(state.data() + g * 16, x);
      _mm_storeu_si128(reinterpret_cast<__m128i *>(z + i),
                       _mm512_cvtepi32_epi8(_mm512_srli_epi32(pk, 24)));
    }
  }
  for (int64_t s = 0; i < n; ++i, ++s) {  // ragged tail: scalar
    uint32_t x = state[s];
    const uint32_t cum = x & kIlvMask;
    const uint32_t pk = lut[cum];
    x = ((pk & kIlvMask) + 1) * (x >> kIlvPrecision) + cum
        - ((pk >> kIlvPrecision) & kIlvMask);
    if (x < kIlvStateMin) {
      x = (x << 16) | ((pos < total_words) ? words[pos++] : 0u);
    }
    state[s] = x;
    z[i] = static_cast<uint8_t>(pk >> 24);
  }
}
#endif  // __AVX512F__

// Decode an interleaved single-channel queue straight into pixels:
// rANS decode (LUT in L1) -> un-zigzag -> spatial prefix.  Returns 0, or
// -3 if length > kIlvMaxValues.
int32_t pixel_rans_decode(const uint16_t *words, int64_t total_words,
                          const int32_t *freqs, const int32_t *starts,
                          int32_t length, int64_t n_streams,
                          int64_t b, int64_t p, int64_t q, int64_t c,
                          uint8_t *out, int64_t mode) {
  if (length > kIlvMaxValues) {
    return -3;
  }
  std::vector<uint32_t> lut(kIlvProbScale, 0);
  for (int32_t v = 0; v < length; ++v) {
    const uint32_t f = static_cast<uint32_t>(freqs[v]);
    const uint32_t st = static_cast<uint32_t>(starts[v]);
    const uint32_t packed =
        (static_cast<uint32_t>(v) << 24) | (st << kIlvPrecision) | (f - 1);
    for (uint32_t k = 0; k < f && st + k < kIlvProbScale; ++k) {
      lut[st + k] = packed;
    }
  }

  const int64_t n = b * p * q * c;
  std::vector<uint8_t> z(static_cast<size_t>(n));
#if defined(__AVX512F__)
  if (n_streams % 16 == 0 && n_streams >= 16) {
    ilv_pixel_decode_avx512(words, total_words, lut.data(), n, n_streams,
                            z.data());
    unzigzag_unpredict_tiles(z.data(), b, p, q, c, out, mode);
    return 0;
  }
#endif
  std::vector<uint32_t> state(static_cast<size_t>(n_streams), 0);
  int64_t pos = 0;
  auto next_w = [&]() -> uint32_t {
    return (pos < total_words) ? words[pos++] : 0u;
  };
  for (int64_t s = 0; s < n_streams; ++s) {
    const uint32_t lo = next_w();
    const uint32_t hi = next_w();
    state[s] = lo | (hi << 16);
  }
  int64_t s = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x = state[s];
    const uint32_t cum = x & kIlvMask;
    const uint32_t pk = lut[cum];
    x = ((pk & kIlvMask) + 1) * (x >> kIlvPrecision) + cum
        - ((pk >> kIlvPrecision) & kIlvMask);
    if (x < kIlvStateMin) {
      x = (x << 16) | next_w();
    }
    state[s] = x;
    z[i] = static_cast<uint8_t>(pk >> 24);
    if (++s == n_streams) s = 0;
  }
  unzigzag_unpredict_tiles(z.data(), b, p, q, c, out, mode);
  return 0;
}

// Forward predictor + zigzag (the host mirror of the device packer's
// residual pass), for the upload direction.
#if defined(__AVX512BW__)
// AVX-512 row kernel: r[i] = p[i] - p[i-c] (up-predictor for the first c
// bytes), zigzagged bytewise.  No loop-carried dependency, so this is a
// straight streaming pass.
static void predict_row_avx512(const uint8_t *prow,
                               const uint8_t *prev_col0, uint8_t *zrow,
                               int64_t len, int64_t c) {
  alignas(64) uint8_t head[64];
  const __m512i zero = _mm512_setzero_si512();
  int64_t x = 0;
  for (; x + 64 <= len; x += 64) {
    const __m512i cur = _mm512_loadu_si512(prow + x);
    __m512i left;
    if (x == 0) {
      for (int64_t j = 0; j < c; ++j) {
        head[j] = (prev_col0 != nullptr) ? prev_col0[j] : 0;
      }
      for (int64_t j = c; j < 64; ++j) {
        head[j] = prow[j - c];
      }
      left = _mm512_load_si512(head);
    } else {
      left = _mm512_loadu_si512(prow + x - c);
    }
    const __m512i r = _mm512_sub_epi8(cur, left);
    const __m512i sign =
        _mm512_movm_epi8(_mm512_cmplt_epi8_mask(r, zero));
    const __m512i zz =
        _mm512_xor_si512(_mm512_add_epi8(r, r), sign);
    _mm512_storeu_si512(zrow + x, zz);
  }
  for (; x < len; ++x) {
    const uint8_t left =
        (x >= c) ? prow[x - c]
                 : (prev_col0 != nullptr ? prev_col0[x] : 0);
    const uint8_t r = static_cast<uint8_t>(prow[x] - left);
    zrow[x] = static_cast<uint8_t>(
        (r << 1) ^ static_cast<uint8_t>(static_cast<int8_t>(r) >> 7));
  }
}
#endif  // __AVX512BW__

// Scalar twin of predict_row_avx512: left-diff + zigzag of one row, the
// first c bytes predicted from prev_col0 (nullptr = zero seed).
static void predict_row_scalar(const uint8_t *prow, const uint8_t *prev_col0,
                               uint8_t *zrow, int64_t len, int64_t c) {
  for (int64_t x = 0; x < len; ++x) {
    const uint8_t left =
        (x >= c) ? prow[x - c] : (prev_col0 != nullptr ? prev_col0[x] : 0);
    const uint8_t r = static_cast<uint8_t>(prow[x] - left);
    zrow[x] = static_cast<uint8_t>(
        (r << 1) ^ static_cast<uint8_t>(static_cast<int8_t>(r) >> 7));
  }
}

// mode 0: hybrid predictor (left; up for column 0) — the original wire
// transform.  mode 1: plane predictor (left + up - upleft), computed in
// SEPARABLE form as a vertical byte-diff followed by the horizontal
// left-diff of the SAME row kernels: r = Dh(Dv(x)) mod 256 — the 2-D
// gradient residual whose inverse is two mod-256 prefix sums (so the
// device can invert it with two cumsums, no wavefront recurrence).
void pixel_predict_zigzag(const uint8_t *pixels, int64_t b, int64_t p,
                          int64_t q, int64_t c, uint8_t *z, int64_t mode) {
  const int64_t tile = p * q * c;
  const int64_t len = q * c;
  std::vector<uint8_t> drow;
  if (mode == 1) {
    drow.resize(static_cast<size_t>(len));
  }
#if defined(__AVX512BW__)
  const bool vec_rows = (len >= 64 && c >= 1 && c <= 32);
#else
  const bool vec_rows = false;
#endif
  for (int64_t t = 0; t < b; ++t) {
    const uint8_t *pt = pixels + t * tile;
    uint8_t *zt = z + t * tile;
    for (int64_t y = 0; y < p; ++y) {
      const uint8_t *prow = pt + y * len;
      const uint8_t *prev = (y > 0) ? pt + (y - 1) * len : nullptr;
      uint8_t *zrow = zt + y * len;
      const uint8_t *src = prow;
      const uint8_t *seed = prev;
      if (mode == 1) {
        if (prev != nullptr) {
          for (int64_t j = 0; j < len; ++j) {  // Dv: bytewise, autovec
            drow[j] = static_cast<uint8_t>(prow[j] - prev[j]);
          }
          src = drow.data();
        }
        seed = nullptr;  // Dh runs zero-seeded on the vertical diff
      }
#if defined(__AVX512BW__)
      if (vec_rows) {
        predict_row_avx512(src, seed, zrow, len, c);
        continue;
      }
#endif
      predict_row_scalar(src, seed, zrow, len, c);
    }
  }
}

#if defined(__AVX512F__)
// AVX-512 inner loop for the interleaved single-table encode (reversed
// order): 16 streams per vector, groups processed in DESCENDING order so
// compress-stores land emitted words in exact scalar order (scalar walks
// streams high-to-low writing back-to-front, i.e. ascending lanes at
// ascending addresses within a group).  Two gathers per 16 symbols:
// packed (freq | start<<13 | shift<<25) and the round-up reciprocal,
// with the +1-overshoot correction vectorized.  Words stage as 32-bit
// and narrow once at the end.  Returns total words or -2 on overflow.
static int64_t ilv_pixel_encode_avx512(const uint8_t *zz, int64_t n,
                                       int64_t n_streams,
                                       const uint32_t *fr,
                                       const uint32_t *st_tab,
                                       const uint32_t *rcp,
                                       const uint32_t *sh,
                                       const uint32_t *packed_tab,
                                       uint16_t *out,
                                       int64_t capacity_words) {
  std::vector<uint32_t> state(static_cast<size_t>(n_streams),
                              kIlvStateMin);
  std::vector<uint32_t> stage(static_cast<size_t>(capacity_words));
  int64_t wp = capacity_words;           // exclusive write end
  const int64_t full = (n / n_streams) * n_streams;
  // zero pads first: the device/numpy encoders pad the symbol plane to a
  // multiple of n_streams with zigzag value 0 and CODE those pads, so the
  // ragged-tile bitstream is identical across all three encoders (and the
  // decoder's pad-step consumption is real coded data, not clamped
  // garbage).  Pads occupy streams n_streams-1 .. n % n_streams of the
  // top (reversed-first) step.
  if (n % n_streams != 0) {
    const uint32_t f0 = fr[0];
    for (int64_t k = n_streams - 1; k >= n % n_streams; --k) {
      uint32_t x = state[k];
      if ((x >> kIlvEmitShift) >= f0) {
        if (wp == 0) return -2;
        stage[--wp] = x & 0xFFFF;
        x >>= 16;
      }
      uint32_t q32 = (f0 == 1) ? x
          : static_cast<uint32_t>(
                (static_cast<uint64_t>(x) * rcp[0]) >> (32 + sh[0] - 1));
      uint32_t r = x - q32 * f0;
      if (static_cast<int32_t>(r) < 0) {
        --q32;
        r += f0;
      }
      state[k] = (q32 << kIlvPrecision) + r + st_tab[0];
    }
  }
  int64_t i = n - 1;
  int64_t s = (n - 1) % n_streams;
  for (; i >= full; --i) {               // ragged head: scalar
    const uint8_t v = zz[i];
    const uint32_t f = fr[v];
    uint32_t x = state[s];
    if ((x >> kIlvEmitShift) >= f) {
      if (wp == 0) return -2;
      stage[--wp] = x & 0xFFFF;
      x >>= 16;
    }
    uint32_t q32 = (f == 1) ? x
        : static_cast<uint32_t>(
              (static_cast<uint64_t>(x) * rcp[v]) >> (32 + sh[v] - 1));
    uint32_t r = x - q32 * f;
    if (static_cast<int32_t>(r) < 0) {
      --q32;
      r += f;
    }
    state[s] = (q32 << kIlvPrecision) + r + st_tab[v];
    if (--s < 0) s = n_streams - 1;
  }
  const int64_t groups = n_streams / 16;
  const __m512i vone = _mm512_set1_epi32(1);
  const __m512i vzero = _mm512_setzero_si512();
  const __m512i low16 = _mm512_set1_epi32(0xFFFF);
  const __m512i m13 = _mm512_set1_epi32(0x1FFF);
  const __m512i m12 = _mm512_set1_epi32(0xFFF);
  for (int64_t t = full / n_streams - 1; t >= 0; --t) {
    for (int64_t g = groups - 1; g >= 0; --g) {
      __m512i x = _mm512_loadu_si512(state.data() + g * 16);
      const __m512i v = _mm512_cvtepu8_epi32(_mm_loadu_si128(
          reinterpret_cast<const __m128i *>(zz + t * n_streams + g * 16)));
      const __m512i pk = _mm512_i32gather_epi32(v, packed_tab, 4);
      const __m512i m = _mm512_i32gather_epi32(v, rcp, 4);
      const __m512i f = _mm512_and_si512(pk, m13);
      const __m512i stv =
          _mm512_and_si512(_mm512_srli_epi32(pk, 13), m12);
      const __m512i shv = _mm512_srli_epi32(pk, 25);
      const __mmask16 em = _mm512_cmp_epu32_mask(
          _mm512_srli_epi32(x, kIlvEmitShift), f, _MM_CMPINT_NLT);
      const int cnt = _mm_popcnt_u32(static_cast<unsigned>(em));
      if (wp < cnt) return -2;
      wp -= cnt;
      _mm512_mask_compressstoreu_epi32(stage.data() + wp, em,
                                       _mm512_and_si512(x, low16));
      x = _mm512_mask_srli_epi32(x, em, x, 16);
      // q = x // f exactly: mulhi32 (vpmuludq pairs) >> (shift-1), then
      // the +1-overshoot correction; f == 1 (shift 0) means q = x
      const __m512i pe = _mm512_mul_epu32(x, m);
      const __m512i po = _mm512_mul_epu32(_mm512_srli_epi64(x, 32),
                                          _mm512_srli_epi64(m, 32));
      const __m512i mh = _mm512_mask_blend_epi32(
          0xAAAA, _mm512_srli_epi64(pe, 32), po);
      const __m512i sh1 =
          _mm512_sub_epi32(_mm512_max_epu32(shv, vone), vone);
      __m512i qv = _mm512_srlv_epi32(mh, sh1);
      qv = _mm512_mask_mov_epi32(
          qv, _mm512_cmp_epi32_mask(shv, vzero, _MM_CMPINT_EQ), x);
      __m512i r = _mm512_sub_epi32(x, _mm512_mullo_epi32(qv, f));
      const __mmask16 over =
          _mm512_cmp_epi32_mask(r, vzero, _MM_CMPINT_LT);
      qv = _mm512_mask_sub_epi32(qv, over, qv, vone);
      r = _mm512_mask_add_epi32(r, over, r, f);
      x = _mm512_add_epi32(
          _mm512_add_epi32(_mm512_slli_epi32(qv, kIlvPrecision), r), stv);
      _mm512_storeu_si512(state.data() + g * 16, x);
    }
  }
  if (wp < 2 * n_streams) return -2;
  for (int64_t k = n_streams - 1; k >= 0; --k) {
    stage[--wp] = state[k] >> 16;
    stage[--wp] = state[k] & 0xFFFF;
  }
  const int64_t total = capacity_words - wp;
  for (int64_t k = 0; k < total; ++k) {
    out[k] = static_cast<uint16_t>(stage[wp + k]);
  }
  return total;
}
#endif  // __AVX512F__

// Fused predict + zigzag + interleaved encode of ONE tile batch member
// (single-channel 256-value table).  Returns total words (flush included),
// -2 on overflow, -3 on a too-large alphabet.
int64_t pixel_rans_encode(const uint8_t *pixels, int64_t b, int64_t p,
                          int64_t q, int64_t c, const int32_t *freqs,
                          const int32_t *starts, int32_t length,
                          int64_t n_streams, uint16_t *out,
                          int64_t capacity_words, int64_t mode) {
  if (length > kIlvMaxValues || length < 256) {
    return -3;  // residual alphabet must cover all 256 zigzag values
  }
  const int64_t n = b * p * q * c;
  std::vector<uint8_t> z(static_cast<size_t>(n));
  pixel_predict_zigzag(pixels, b, p, q, c, z.data(), mode);

  // division-free state update: per-value round-up reciprocals (exact for
  // states < 2^31, with a +1-overshoot correction beyond that — the same
  // formulation as the JAX package's Pallas encode kernel)
  uint32_t rcp[256], sh[256], fr[256], st_tab[256];
  for (int32_t v = 0; v < 256; ++v) {
    const uint32_t f = static_cast<uint32_t>(freqs[v]);
    fr[v] = f;
    st_tab[v] = static_cast<uint32_t>(starts[v]);
    uint32_t shift = 0;
    while ((1u << shift) < f) ++shift;
    sh[v] = shift;
    rcp[v] = static_cast<uint32_t>(
        ((static_cast<uint64_t>(1) << (31 + shift)) + f - 1) / f);
  }

#if defined(__AVX512F__)
  if (n_streams % 16 == 0 && n_streams >= 16) {
    uint32_t packed_tab[256];
    for (int32_t v = 0; v < 256; ++v) {
      packed_tab[v] = fr[v] | (st_tab[v] << 13) | (sh[v] << 25);
    }
    return ilv_pixel_encode_avx512(z.data(), n, n_streams, fr, st_tab,
                                   rcp, sh, packed_tab, out,
                                   capacity_words);
  }
#endif

  std::vector<uint32_t> state(static_cast<size_t>(n_streams), kIlvStateMin);
  std::vector<uint16_t> scratch(static_cast<size_t>(capacity_words));
  uint16_t *end = scratch.data() + capacity_words;
  uint16_t *ptr = end;
  // zero pads first (see the AVX path): identical ragged-tile bitstreams
  // across the C++/numpy/device encoders
  if (n % n_streams != 0) {
    const uint32_t f0 = fr[0];
    for (int64_t k = n_streams - 1; k >= n % n_streams; --k) {
      uint32_t x = state[k];
      if ((x >> kIlvEmitShift) >= f0) {
        if (ptr == scratch.data()) {
          return -2;
        }
        *--ptr = static_cast<uint16_t>(x & 0xFFFF);
        x >>= 16;
      }
      uint32_t q32 = (f0 == 1) ? x
          : static_cast<uint32_t>(
                (static_cast<uint64_t>(x) * rcp[0]) >> (32 + sh[0] - 1));
      uint32_t r = x - q32 * f0;
      if (static_cast<int32_t>(r) < 0) {
        --q32;
        r += f0;
      }
      state[k] = (q32 << kIlvPrecision) + r + st_tab[0];
    }
  }
  int64_t s = static_cast<int64_t>((n - 1) % n_streams);
  for (int64_t i = n - 1; i >= 0; --i) {
    const uint8_t v = z[i];
    const uint32_t f = fr[v];
    uint32_t x = state[s];
    if ((x >> kIlvEmitShift) >= f) {
      if (ptr == scratch.data()) {
        return -2;
      }
      *--ptr = static_cast<uint16_t>(x & 0xFFFF);
      x >>= 16;
    }
    uint32_t q32 =
        (f == 1) ? x
                 : static_cast<uint32_t>(
                       (static_cast<uint64_t>(x) * rcp[v]) >> (32 + sh[v] - 1));
    uint32_t r = x - q32 * f;
    // The 2^(31+shift) round-up reciprocal is exact only for x < 2^31;
    // states reach f<<20, which exceeds that once f > 2^11 (peaked tables
    // on smooth content).  The overshoot is at most +1 — detect it from
    // the wrapped remainder and step back.
    if (static_cast<int32_t>(r) < 0) {
      --q32;
      r += f;
    }
    x = (q32 << kIlvPrecision) + r + st_tab[v];
    state[s] = x;
    if (--s < 0) s = n_streams - 1;
  }
  for (int64_t k = n_streams - 1; k >= 0; --k) {
    if (ptr - scratch.data() < 2) {
      return -2;
    }
    *--ptr = static_cast<uint16_t>(state[k] >> 16);
    *--ptr = static_cast<uint16_t>(state[k] & 0xFFFF);
  }
  const int64_t total = end - ptr;
  std::memcpy(out, ptr, static_cast<size_t>(total) * 2);
  return total;
}


int32_t rans_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

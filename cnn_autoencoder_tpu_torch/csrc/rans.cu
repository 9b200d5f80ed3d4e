// Interleaved rANS-32/16 encode and decode of cae_tpu frame v4, for the
// H100 (sm_90a), at any stream count S from 1 to 65535 (the frame's u16
// field).
//
// Replaces: cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:_make_encode_kernel
// (pallas_call in encode_interleaved_pallas) and _make_decode_kernel
// (pallas_call in decode_interleaved_pallas).  Bit-identical to the plain
// versions in ops/kernels/rans_kernel.py and to the JAX package's
// encode_device_interleaved / decode_device_interleaved.
//
// Format: 12-bit probabilities, uint32 state in [2^16, 2^32), at most one
// 16-bit word per symbol.  S streams per tile advance in lockstep over T
// steps; stream s codes symbol (t, s).  A tile's words form one queue in
// decode order: the 2S flush words (low, high half of each final state,
// stream-major), then for each step t the refill words of the streams that
// renormalise at t, in stream order.  Words are uint16 in and out.
//
// What bounds them here: the bytes are few (4 bytes per symbol in or out,
// 2 per coded word), so each direction is bound by its chain of T serial
// steps, not by memory.  The designs shorten that chain and take the rest
// off it:
//
// Encode (K6) is two passes.  A stream's state never depends on another
// stream's; only the words' queue positions do.  So the state pass runs one
// thread per (tile, stream), over as many blocks as B x S needs, walking
// t = T-1 .. 0 with no barrier in its loop.  Symbols and channels come
// kEncGroup steps ahead of the chain; the table entry (start and freq
// packed in one word, beside a reciprocal that makes the exact division one
// multiply and one correction, above 2^31 too) from a copy staged in shared
// memory where the table fits.  Each step leaves its candidate word (uint16)
// and one flag bit per (step, stream) (a warp's ballot); a count kernel sums
// the flags per chunk of the bit rows.  The compaction, which the caller
// may re-run alone at a larger capacity, places every flagged word at 2S +
// its rank in (t, s) order (the chunks' counts, then a scan over a warp's
// bit words), drops words at or past the capacity, and writes the flush
// words, zeros past the total and the per-tile totals.
//
// Decode (K5): a step's refill ranks couple every stream of a tile, so a
// tile is one block: up to kDecWarps decoding warps, each taking 32 x per
// consecutive streams (per = 1, 2, 4, 8 or 16 in registers; above 4096
// streams the states live in a scratch row in device memory and the step's
// ballots in shared memory), and a copier warp.  The copier stages what the
// steps ahead read by bulk copies on per-step mbarriers (the channel map's
// rows, the LUT rows of the channels ahead, the queue's words in a ring
// window ahead of the read position) and publishes each step's plan of what
// has landed; what has not is read from device memory, and reads past a cut
// or corrupt queue's end take its last word.  A warp whose channels are all
// staged reads its LUT entries without a branch between them, so its
// sub-steps' chains overlap.  One barrier per step: the per-warp refill
// counts and the plans are double-buffered by step parity.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "smem_copy.cuh"

namespace {

constexpr uint32_t kPrecision = 12;
constexpr uint32_t kMask = (1u << kPrecision) - 1u;
constexpr uint32_t kStateMin = 1u << 16;
constexpr uint32_t kEmitShift = 20;
constexpr int kMaxStreams = 0xFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Diagnostics (csrc/probes/rans_probe.cu, RANS_PROBE): thread 0 of each
// block records clock64 and the global nanosecond timer at the start and
// the end of its serial loop ([0]: the encode state pass, [1]: the decode),
// and the decode's cycles by part of its steps (Laps).
constexpr int kProbeBlocks = 4096;
constexpr int kLaps = 4;
#ifdef RANS_PROBE
__device__ unsigned long long g_rans_probe[2][kProbeBlocks][4];
__device__ unsigned long long g_rans_laps[kProbeBlocks][kLaps];
__device__ __forceinline__ void probe_mark(int which, int at) {
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_rans_probe[which][blockIdx.x][at] = clock64();
    g_rans_probe[which][blockIdx.x][at + 2] = ns;
  }
}
struct Laps {
  unsigned long long last, acc[kLaps];
  __device__ void begin() {
    last = clock64();
    for (int k = 0; k < kLaps; ++k) acc[k] = 0;
  }
  __device__ void lap(int k) {
    if (threadIdx.x != 0) return;
    const unsigned long long now = clock64();
    acc[k] += now - last;
    last = now;
  }
  __device__ void store() const {
    if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks)
      for (int k = 0; k < kLaps; ++k) g_rans_laps[blockIdx.x][k] = acc[k];
  }
};
#else
__device__ __forceinline__ void probe_mark(int, int) {}
struct Laps {
  __device__ void begin() {}
  __device__ void lap(int) {}
  __device__ void store() const {}
};
#endif

// Bulk copies of the tensor memory accelerator into shared memory, which
// complete on an mbarrier: one arrival that expects the step's bytes, then
// the copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- encode: state pass -----------------------------------------------------

constexpr int kEncThreads = 256;
constexpr int kEncGroup = 8;             // steps whose loads fly together
constexpr int kEncSmemMax = 200 * 1024;  // the staged table's limit

// A table entry: start << 12 | (freq - 1), and m = floor((2^32 - 1) / freq)
// for the division below.
__device__ __forceinline__ uint2 enc_entry(int32_t start, int32_t freq) {
  return make_uint2((static_cast<uint32_t>(start) << kPrecision) |
                        static_cast<uint32_t>(freq - 1),
                    0xFFFFFFFFu / static_cast<uint32_t>(freq));
}

// x = q f + r exactly, from m = floor((2^32 - 1) / f): with 2^32 - 1 =
// m f + rho (rho < f), x m / 2^32 = x / f - (x / f)(1 + rho) / 2^32 and the
// last term is below x / 2^32 < 1, so umulhi(x, m) is q or q - 1.
__device__ __forceinline__ uint32_t div_rem(uint32_t x, uint32_t f,
                                            uint32_t m, uint32_t& r) {
  uint32_t q = __umulhi(x, m);
  r = x - q * f;
  if (r >= f) {
    ++q;
    r -= f;
  }
  return q;
}

// One thread per (tile, stream); blocks_per_tile blocks cover a tile's
// 32 * w stream slots (w = ceil(S / 32)).  kStaged: the table (C * L
// entries, then C offsets) is copied into shared memory first.
template <bool kStaged>
__global__ void __launch_bounds__(kEncThreads) rans_encode_state_kernel(
    const int32_t* __restrict__ symbols, const int32_t* __restrict__ ch_map,
    const int32_t* __restrict__ freq, const int32_t* __restrict__ start,
    const int32_t* __restrict__ offset, int channels, int support,
    int blocks_per_tile, uint16_t* __restrict__ words,
    uint32_t* __restrict__ flags, uint32_t* __restrict__ xfin, int t_steps,
    int s, int w) {
  extern __shared__ __align__(16) uint2 s_tab[];
  const int tile = blockIdx.x / blocks_per_tile;
  const int st = (blockIdx.x % blocks_per_tile) * kEncThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int wg = st >> 5;  // the warp's 32-stream group in the tile
  const bool active = st < s;
  const int n_tab = channels * support;
  const int64_t row0 = static_cast<int64_t>(tile) * t_steps;
  // lanes past S load stream S - 1's values and store nothing
  const int32_t* sym_col = symbols + row0 * s + min(st, s - 1);
  const int32_t* ch_col = ch_map + min(st, s - 1);

  int32_t nsym[kEncGroup], nch[kEncGroup];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kEncGroup; ++j) {
      const int64_t t = max(t0 - j, 0);
      nsym[j] = __ldg(sym_col + t * s);
      nch[j] = __ldg(ch_col + t * s);
    }
  };
  load(t_steps - 1);  // in flight while the table is staged

  const int32_t* s_off = reinterpret_cast<const int32_t*>(s_tab + n_tab);
  if constexpr (kStaged) {
    // four entries a load where the tables are 16-byte aligned
    const bool vec = ((reinterpret_cast<uintptr_t>(freq) |
                       reinterpret_cast<uintptr_t>(start)) & 15) == 0;
    const int n_vec = vec ? n_tab / 4 : 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < n_vec; i += kEncThreads) {
      const int4 f = __ldg(reinterpret_cast<const int4*>(freq) + i);
      const int4 c = __ldg(reinterpret_cast<const int4*>(start) + i);
      s_tab[4 * i] = enc_entry(c.x, f.x);
      s_tab[4 * i + 1] = enc_entry(c.y, f.y);
      s_tab[4 * i + 2] = enc_entry(c.z, f.z);
      s_tab[4 * i + 3] = enc_entry(c.w, f.w);
    }
#pragma unroll 4
    for (int i = 4 * n_vec + threadIdx.x; i < n_tab; i += kEncThreads)
      s_tab[i] = enc_entry(__ldg(start + i), __ldg(freq + i));
    for (int i = threadIdx.x; i < channels; i += kEncThreads)
      reinterpret_cast<int32_t*>(s_tab + n_tab)[i] = __ldg(offset + i);
    __syncthreads();
  }
  if (wg >= w) return;  // whole warps past the tile's last stream group

  auto entry = [&](int ch, int sym) -> uint2 {
    if constexpr (kStaged) {
      const int v = min(max(sym - s_off[ch], 0), support - 1);
      return s_tab[ch * support + v];
    } else {
      const int v = min(max(sym - __ldg(offset + ch), 0), support - 1);
      return enc_entry(__ldg(start + ch * support + v),
                       __ldg(freq + ch * support + v));
    }
  };

  // the chain over n steps of a group (n = kEncGroup in the main loop),
  // each step's word and flags stored as it goes
  uint32_t x = kStateMin;
  uint16_t* word_p = words + (row0 + t_steps - 1) * s + st;
  uint32_t* flag_p = flags + (row0 + t_steps - 1) * w + wg;
  auto lookup = [&](uint2 (&e)[kEncGroup]) {
#pragma unroll
    for (int j = 0; j < kEncGroup; ++j) e[j] = entry(nch[j], nsym[j]);
  };
  auto chain = [&](const uint2 (&e)[kEncGroup], int n) {
#pragma unroll
    for (int j = 0; j < kEncGroup; ++j) {
      if (j >= n) break;
      const uint32_t f = (e[j].x & kMask) + 1u;
      const bool emit = active && (x >> kEmitShift) >= f;
      const uint32_t word = x & 0xFFFFu;
      x = emit ? x >> 16 : x;
      uint32_t r;
      const uint32_t q = div_rem(x, f, e[j].y, r);
      x = (q << kPrecision) + r + (e[j].x >> kPrecision);
      if (active) *word_p = static_cast<uint16_t>(word);
      const unsigned bal = __ballot_sync(kFull, emit);
      if (lane == 0) *flag_p = bal;
      word_p -= s;
      flag_p -= w;
    }
  };
  probe_mark(0, 0);
  int t0 = t_steps - 1;
  for (; t0 >= kEncGroup - 1; t0 -= kEncGroup) {
    uint2 e[kEncGroup];
    lookup(e);
    load(t0 - kEncGroup);  // the next group's loads fly during this chain
    chain(e, kEncGroup);
  }
  if (t0 >= 0) {
    uint2 e[kEncGroup];
    lookup(e);
    chain(e, t0 + 1);
  }
  probe_mark(0, 1);
  if (active) xfin[static_cast<int64_t>(tile) * s + st] = x;
}

// -- encode: flag counts and compaction -------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kChunkWords = 1024;  // bit words (32 flags each) per block
constexpr int kWarpWords = kChunkWords / kScanWarps;

int chunks_for(int t_steps, int s) {
  const int64_t n_words = static_cast<int64_t>(t_steps) * ((s + 31) / 32);
  return static_cast<int>((n_words + kChunkWords - 1) / kChunkWords);
}

// the block's sum of v, in every thread; s_red holds kScanWarps ints
__device__ __forceinline__ int block_sum(int v, int* s_red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanWarps; ++i) sum += s_red[i];
  __syncthreads();  // s_red is rewritten by the next call
  return sum;
}

// counts[tile, k] = flags set in chunk k of the tile's bit words
__global__ void __launch_bounds__(kScanThreads) rans_count_kernel(
    const uint32_t* __restrict__ flags, int n_words, int nchunk,
    int32_t* __restrict__ counts) {
  __shared__ int s_red[kScanWarps];
  const int tile = blockIdx.x / nchunk, k = blockIdx.x % nchunk;
  const uint32_t* f = flags + static_cast<int64_t>(tile) * n_words;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kChunkWords / kScanThreads; ++j) {
    const int i = k * kChunkWords + j * kScanThreads + threadIdx.x;
    if (i < n_words) c += __popc(__ldg(f + i));
  }
  c = block_sum(c, s_red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// One block per (tile, chunk of kChunkWords bit words); warp wp takes
// kWarpWords of them, 32 at a time: lane l holds bit word l, and for each
// bit word the 32 lanes move its flagged words (one stream each) to
// consecutive queue positions, reading and writing coalesced.
__global__ void __launch_bounds__(kScanThreads) rans_compact_kernel(
    const uint16_t* __restrict__ words, const uint32_t* __restrict__ flags,
    const uint32_t* __restrict__ xfin, const int32_t* __restrict__ counts,
    int nchunk, int n_words, int t_steps, int s, int w,
    uint16_t* __restrict__ out, int64_t capacity,
    int32_t* __restrict__ totals) {
  __shared__ int s_red[kScanWarps];
  __shared__ int s_wsum[kScanWarps];
  const int tile = blockIdx.x / nchunk, k = blockIdx.x % nchunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;

  // flags before this chunk, and in the whole tile
  int pre = 0, all = 0;
  for (int i = threadIdx.x; i < nchunk; i += kScanThreads) {
    const int v = __ldg(counts + static_cast<int64_t>(tile) * nchunk + i);
    all += v;
    pre += i < k ? v : 0;
  }
  pre = block_sum(pre, s_red);
  all = block_sum(all, s_red);
  const int64_t total = 2LL * s + all;
  uint16_t* o = out + static_cast<int64_t>(tile) * capacity;
  if (k == 0 && threadIdx.x == 0) totals[tile] = static_cast<int32_t>(total);

  // the flush words, then zeros past the total, spread over the chunks
  const int64_t stride = static_cast<int64_t>(nchunk) * kScanThreads;
  const int64_t first = static_cast<int64_t>(k) * kScanThreads + threadIdx.x;
  for (int64_t i = first; i < s; i += stride) {
    const uint32_t x = __ldg(xfin + static_cast<int64_t>(tile) * s + i);
    o[2 * i] = static_cast<uint16_t>(x & 0xFFFFu);
    o[2 * i + 1] = static_cast<uint16_t>(x >> 16);
  }
  for (int64_t p = total + first; p < capacity; p += stride) o[p] = 0;

  const uint32_t* fl = flags + static_cast<int64_t>(tile) * n_words;
  const uint16_t* wd = words + static_cast<int64_t>(tile) * t_steps * s;
  const int w0 = k * kChunkWords + warp * kWarpWords;
  uint32_t bm[kWarpWords / 32];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kWarpWords / 32; ++r) {
    const int i = w0 + r * 32 + lane;
    bm[r] = i < n_words ? __ldg(fl + i) : 0u;
    cnt += __popc(bm[r]);
  }
  int wsum = cnt;
#pragma unroll
  for (int d = 16; d; d >>= 1) wsum += __shfl_xor_sync(kFull, wsum, d);
  if (lane == 0) s_wsum[warp] = wsum;
  __syncthreads();
  int64_t base = 2LL * s + pre;
  for (int i = 0; i < warp; ++i) base += s_wsum[i];

#pragma unroll
  for (int r = 0; r < kWarpWords / 32; ++r) {
    const int c = __popc(bm[r]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int excl = incl - c;
    // lane l's bit word as (step, stream group), handed to the other lanes;
    // the flagged words' loads all fly before the first store
    const int i = w0 + r * 32 + lane;
    const int t_l = i / w;
    const int g_l = i - t_l * w;
    uint32_t val[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t b = __shfl_sync(kFull, bm[r], j);
      const int tj = __shfl_sync(kFull, t_l, j);
      const int gj = __shfl_sync(kFull, g_l, j);
      val[j] = (b >> lane) & 1u
                   ? wd[static_cast<int64_t>(tj) * s + gj * 32 + lane]
                   : 0u;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t b = __shfl_sync(kFull, bm[r], j);
      const int bj = __shfl_sync(kFull, excl, j);
      const int64_t pos = base + bj + __popc(b & lt);
      if (((b >> lane) & 1u) && pos < capacity)
        o[pos] = static_cast<uint16_t>(val[j]);
    }
    base += __shfl_sync(kFull, incl, 31);
  }
}

// -- decode -----------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kRegPerMax = 16;      // streams per lane held in registers
constexpr int kMaxPer = (kMaxStreams + kDecThreads - 1) / kDecThreads;
constexpr int kLutSlots = 4;        // staged LUT rows (a power of two)
constexpr int kLutRow = 1 << kPrecision;
constexpr int kWinWords = 8192;     // queue ring window (a power of two)
constexpr int kChBytes = 64 * 1024; // staged channel-map rows
constexpr int kChRowsMax = 16;
constexpr int kLag = 2;             // steps of copies in flight at a step end
constexpr int kLutBytes = kLutSlots * kLutRow * 4;
constexpr int kWinBytes = kWinWords * 2;
// the steps' mbarriers (one per step in flight, and the prologue's), two
// step plans, the per-warp counts by step parity, and (PER == 0) a step's
// ballots
constexpr int kBarBytes = ((kLag + 2) * 8 + 15) / 16 * 16;
constexpr int kDecSmem = kLutBytes + kWinBytes + kChBytes + kBarBytes +
                         2 * 32 + 2 * kDecWarps * 4 + kMaxPer * kDecWarps * 4;

// Channel-map rows staged at once for S streams: a power of two, at least
// kLag + 2 (a row is read kLag + 1 steps after its request at the
// earliest), else 0 (rows read from device memory).
int ch_rows_for(int s) {
  int rows = kChRowsMax;
  while (rows >= kLag + 2 && rows * s * 4 > kChBytes) rows /= 2;
  return rows >= kLag + 2 ? rows : 0;
}

// What the copier has requested: LUT rows of channels [0, lut), queue words
// [win_first, win), channel-map rows [0, rows); each in increasing order,
// channel c into LUT slot c % kLutSlots, word p into window slot
// p % kWinWords, row r into row slot r % ch_rows.
struct Staged {
  int lut, win, rows;
};

// What the decoding warps read at a step, published by the copier: the LUT
// channels and queue words staged and landed, and whether the next step's
// map row is.
struct StepPlan {
  int lut_lo, lut_hi, win_lo, win_hi, row_next, pad[3];
};

// One block per tile: decoding warps and, last, a copier warp.  The
// copier's lane 0 keeps the staging (bulk copies onto the step's mbarrier)
// one step ahead of the decoding warps and publishes each step's plan.
// PER > 0: each decoding lane holds PER states in registers; PER == 0:
// per_rt states a lane in states (a (B, S) scratch).  Stream of warp wp,
// sub-step i, lane l: (wp * per + i) * 32 + l, so stream order is (warp,
// sub-step, lane) order.  window: the queue rows are 16-byte aligned
// (qlen % 8 == 0, aligned base), so they can be staged; ch_rows: channel-map
// rows staged (0: none; needs S % 4 == 0 and an aligned map).
template <int PER>
__global__ void __launch_bounds__(kDecThreads + 32) rans_decode_kernel(
    const uint16_t* __restrict__ queues, int qlen, bool window,
    const int32_t* __restrict__ ch_map, int ch_rows,
    const int32_t* __restrict__ lut, int channels,
    int32_t* __restrict__ out, uint32_t* __restrict__ states, int t_steps,
    int s, int per_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_lut = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_win = reinterpret_cast<uint16_t*>(smem + kLutBytes);
  int32_t* s_ch = reinterpret_cast<int32_t*>(smem + kLutBytes + kWinBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kLutBytes + kWinBytes + kChBytes);
  StepPlan* s_plan = reinterpret_cast<StepPlan*>(
      smem + kLutBytes + kWinBytes + kChBytes + kBarBytes);
  int* s_warp = reinterpret_cast<int*>(s_plan + 2);
  uint32_t* s_bal = reinterpret_cast<uint32_t*>(s_warp + 2 * kDecWarps);

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool copier = warp == blockDim.x / 32 - 1;
  const uint16_t* q = queues + static_cast<int64_t>(tile) * qlen;
  const int win_first = (2 * s) & ~7;
  if (threadIdx.x < 2 * kDecWarps) s_warp[threadIdx.x] = 0;
  if (copier && lane == 0) {
    for (int j = 0; j < kLag + 2; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(bars + j)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (copier) {  // lane 0 issues and publishes, all lanes keep the books
    const bool lead = lane == 0;
    // What a step's request leaves staged, from what was before it: LUT
    // rows of channels below lo + kLutSlots (the step reads channels >= lo,
    // so the slots' channels below lo are free), queue words below upto,
    // map rows below row_to; nothing that a read of this or the previous
    // step may still take is overwritten.
    const int win_end = window ? qlen : win_first;
    auto plan = [&](Staged st, int lo, int upto, int row_to) {
      return Staged{max(st.lut, min(channels, lo + kLutSlots)),
                    max(st.win, min(win_end, upto & ~7)),
                    ch_rows > 0 ? max(st.rows, min(t_steps, row_to)) : 0};
    };
    auto issue = [&](Staged from, Staged to, uint64_t* bar) {
      if (!lead) return;
      const int lut_from = max(from.lut, to.lut - kLutSlots);
      const int win_from = max(from.win, to.win - kWinWords);
      const int rows_from = max(from.rows, to.rows - ch_rows);
      // earlier steps' reads of the slots come before these writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, (to.lut - lut_from) * kLutRow * 4 +
                           (to.win - win_from) * 2 +
                           (to.rows - rows_from) * s * 4);
      for (int c = lut_from; c < to.lut; ++c)
        bulk_copy(s_lut + (c & (kLutSlots - 1)) * kLutRow, lut + c * kLutRow,
                  kLutRow * 4, bar);
      for (int p = win_from; p < to.win;) {  // the ring may wrap once
        const int n = min(to.win - p, kWinWords - (p & (kWinWords - 1)));
        bulk_copy(s_win + (p & (kWinWords - 1)), q + p, n * 2, bar);
        p += n;
      }
      for (int r = rows_from; r < to.rows; ++r)
        bulk_copy(s_ch + (r & (ch_rows - 1)) * s,
                  ch_map + static_cast<int64_t>(r) * s, s * 4, bar);
    };
    // step t's plan: what may be read without a race (below the request of
    // step t, `next`) and has landed (the request of step t - kLag - 1,
    // `ready`)
    auto publish = [&](int t, Staged next, Staged ready) {
      StepPlan pl;
      pl.lut_lo = max(0, next.lut - kLutSlots);
      pl.lut_hi = max(pl.lut_lo, ready.lut);
      pl.win_lo = max(win_first, next.win - kWinWords);
      pl.win_hi = max(pl.win_lo, ready.win);
      pl.row_next = t + 1 >= max(0, next.rows - ch_rows) && t + 1 < ready.rows;
      if (lead) s_plan[t & 1] = pl;
    };
    Staged st = plan(Staged{0, win_first, 0}, __ldg(ch_map),
                     win_first + kWinWords, ch_rows);
    issue(Staged{0, win_first, 0}, st, bars + kLag + 1);
    Staged hist[kLag + 1];  // after the requests of steps t, t - 1, ...
#pragma unroll
    for (int j = 0; j <= kLag; ++j) hist[j] = st;
    int base = 2 * s, prev_base = 2 * s;
    int lo_next = t_steps > 1 ? __ldg(ch_map + s) : 0;
    Staged next = plan(st, __ldg(ch_map), prev_base + kWinWords,
                       ch_rows + 1);
    publish(0, next, st);
    __syncthreads();
    for (int t = 0; t < t_steps; ++t) {
      issue(st, next, bars + t % (kLag + 1));
      st = next;
#pragma unroll
      for (int j = kLag; j > 0; --j) hist[j] = hist[j - 1];
      hist[0] = st;
      if (t + 1 < t_steps) {  // plan step t + 1 (its words: past base_t)
        const int lo = lo_next;
        lo_next = t + 2 < t_steps
                      ? __ldg(ch_map + static_cast<int64_t>(t + 2) * s)
                      : 0;
        next = plan(st, lo, base + kWinWords, t + 1 + ch_rows + 1);
        publish(t + 1, next, hist[kLag]);
      }
      __syncthreads();
      int k = 0;
#pragma unroll
      for (int j = 0; j < kDecWarps; ++j) k += s_warp[(t & 1) * kDecWarps + j];
      prev_base = base;
      base += k;
    }
    return;
  }

  // the decoding warps
  const int per = PER > 0 ? PER : per_rt;
  const uint32_t lt = (1u << lane) - 1u;
  const int s0 = warp * per * 32 + lane;
  int32_t* orow = out + static_cast<int64_t>(tile) * t_steps * s + s0;
  uint32_t* xs = states + static_cast<int64_t>(tile) * s;
  auto queue_at = [&](int pos) -> uint32_t {
    return __ldg(q + min(pos, qlen - 1));
  };
  // initial states from the flush words; step 0's channels
  uint32_t x[PER > 0 ? PER : 1];
  int chn[PER > 0 ? PER : 1];
  if constexpr (PER > 0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int si = s0 + 32 * i;
      const bool act = si < s;
      x[i] = act ? (queue_at(2 * si) | (queue_at(2 * si + 1) << 16)) : 0u;
      chn[i] = act ? __ldg(ch_map + si) : 0;
    }
  } else {
    for (int i = 0; i < per; ++i) {
      const int si = s0 + 32 * i;
      if (si < s) xs[si] = queue_at(2 * si) | (queue_at(2 * si + 1) << 16);
    }
  }
  mbar_wait(bars + kLag + 1, 0);
  __syncthreads();

  int base = 2 * s;
  Laps laps;  // cycles by part of the steps (probe builds)
  laps.begin();
  probe_mark(1, 0);
  for (int t = 0; t < t_steps; ++t) {
    const StepPlan pl = s_plan[t & 1];
    auto lut_at = [&](int ch, uint32_t cum) -> uint32_t {
      return static_cast<unsigned>(ch - pl.lut_lo) <
                     static_cast<unsigned>(pl.lut_hi - pl.lut_lo)
                 ? s_lut[((ch & (kLutSlots - 1)) << kPrecision) | cum]
                 : static_cast<uint32_t>(
                       __ldg(lut + ((ch << kPrecision) | cum)));
    };
    auto word_at = [&](int base_rank) -> uint32_t {
      const int pos = min(base_rank, qlen - 1);
      return static_cast<unsigned>(pos - pl.win_lo) <
                     static_cast<unsigned>(pl.win_hi - pl.win_lo)
                 ? s_win[pos & (kWinWords - 1)]
                 : __ldg(q + pos);
    };
    const bool next = t + 1 < t_steps;
    const int32_t* nrow = pl.row_next
                              ? s_ch + ((t + 1) & (ch_rows - 1)) * s
                              : ch_map + static_cast<int64_t>(t + 1) * s;

    int wsum = 0;
    uint32_t bal[PER > 0 ? PER : 1];
    if constexpr (PER > 0) {
      int cur[PER];
      bool lut_staged = true;  // every channel of the warp's streams
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        cur[i] = chn[i];
        lut_staged &= static_cast<unsigned>(cur[i] - pl.lut_lo) <
                      static_cast<unsigned>(pl.lut_hi - pl.lut_lo);
        chn[i] = next && s0 + 32 * i < s ? nrow[s0 + 32 * i] : 0;
      }
      // the entries first, without a branch between them, so that the
      // sub-steps' chains overlap
      uint32_t p[PER];
      if (__all_sync(kFull, lut_staged)) {
#pragma unroll
        for (int i = 0; i < PER; ++i)
          p[i] = s_lut[((cur[i] & (kLutSlots - 1)) << kPrecision) |
                       (x[i] & kMask)];
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) p[i] = lut_at(cur[i], x[i] & kMask);
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const bool act = s0 + 32 * i < s;
        const uint32_t cum = x[i] & kMask;
        x[i] = ((p[i] & kMask) + 1u) * (x[i] >> kPrecision) + cum -
               ((p[i] >> kPrecision) & kMask);
        bal[i] = __ballot_sync(kFull, act && x[i] < kStateMin);
        wsum += __popc(bal[i]);
        if (act) orow[32 * i] = static_cast<int32_t>(p[i] >> 24);
      }
    } else {
      const int32_t* row = ch_map + static_cast<int64_t>(t) * s;
#pragma unroll 4
      for (int i = 0; i < per; ++i) {
        const int si = s0 + 32 * i;
        const bool act = si < s;
        uint32_t xv = act ? xs[si] : 0u;
        const uint32_t cum = xv & kMask;
        const uint32_t p = lut_at(act ? __ldg(row + si) : 0, cum);
        xv = ((p & kMask) + 1u) * (xv >> kPrecision) + cum -
             ((p >> kPrecision) & kMask);
        const uint32_t b = __ballot_sync(kFull, act && xv < kStateMin);
        if (act) {
          xs[si] = xv;
          orow[32 * i] = static_cast<int32_t>(p >> 24);
        }
        if (lane == 0) s_bal[i * kDecWarps + warp] = b;
        wsum += __popc(b);
      }
    }
    laps.lap(0);
    if (lane == 0) s_warp[(t & 1) * kDecWarps + warp] = wsum;
    if (t >= kLag)  // the copies of step t - kLag have landed
      mbar_wait(bars + (t - kLag) % (kLag + 1),
                ((t - kLag) / (kLag + 1)) & 1);
    __syncthreads();
    laps.lap(1);

    // refills: the exclusive count of refilling streams before this warp
    int before = 0, k = 0;
#pragma unroll
    for (int j = 0; j < kDecWarps; j += 4) {
      const int4 v =
          reinterpret_cast<const int4*>(s_warp + (t & 1) * kDecWarps + j)[0];
      k += v.x + v.y + v.z + v.w;
      before += (j < warp ? v.x : 0) + (j + 1 < warp ? v.y : 0) +
                (j + 2 < warp ? v.z : 0) + (j + 3 < warp ? v.w : 0);
    }
    laps.lap(2);
    int run = base + before;
    // the usual step: every word it takes is in the window, none past the
    // queue's end
    const bool win_staged =
        base >= pl.win_lo && base + k <= pl.win_hi && base + k <= qlen;
    if constexpr (PER > 0) {
      if (win_staged) {  // no branch: every lane reads a word of the window
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const uint32_t w =
              s_win[(run + __popc(bal[i] & lt)) & (kWinWords - 1)];
          x[i] = (bal[i] >> lane) & 1u ? (x[i] << 16) | w : x[i];
          run += __popc(bal[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if ((bal[i] >> lane) & 1u)
            x[i] = (x[i] << 16) | word_at(run + __popc(bal[i] & lt));
          run += __popc(bal[i]);
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < per; ++i) {
        const uint32_t b = s_bal[i * kDecWarps + warp];
        if ((b >> lane) & 1u) {
          const int si = s0 + 32 * i;
          xs[si] = (xs[si] << 16) | word_at(run + __popc(b & lt));
        }
        run += __popc(b);
      }
    }
    base += k;
    orow += s;
    laps.lap(3);
  }
  probe_mark(1, 1);
  laps.store();
  // no copy may still be writing when the block's shared memory goes
  for (int t = max(0, t_steps - kLag); t < t_steps; ++t)
    mbar_wait(bars + t % (kLag + 1), (t / (kLag + 1)) & 1);
}

bool bad_geometry(int t_steps, int s) {
  return s < 1 || s > kMaxStreams || t_steps < 1 ||
         static_cast<int64_t>(t_steps) * s > INT_MAX / 2;
}

}  // namespace

// Chunks of the state pass's flag counts (the counts buffer: (B, chunks)).
extern "C" int64_t cae_rans_encode_chunks(int t_steps, int s) {
  return bad_geometry(t_steps, s) ? 0 : chunks_for(t_steps, s);
}

// The state pass and the flag counts: symbols (B, T, S) and ch_map (T, S)
// int32, tables freq/start (C, L) and offset (C,) int32 -> words (B, T, S)
// uint16, flags (B, T * ceil(S / 32)) bit words, final states xfin (B, S),
// counts (B, cae_rans_encode_chunks(T, S)).
extern "C" int cae_rans_encode_states(
    const int32_t* symbols, const int32_t* ch_map, const int32_t* freq,
    const int32_t* start, const int32_t* offset, int channels, int support,
    int bsz, int t_steps, int s, uint16_t* words, uint32_t* flags,
    uint32_t* xfin, int32_t* counts, cudaStream_t stream) {
  if (bad_geometry(t_steps, s) || channels < 1 || support < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0) return 0;
  const int w = (s + 31) / 32;
  const int blocks_per_tile = (w * 32 + kEncThreads - 1) / kEncThreads;
  const int64_t smem =
      static_cast<int64_t>(channels) * support * sizeof(uint2) +
      static_cast<int64_t>(channels) * sizeof(int32_t);
  cudaError_t err;
  if (smem <= kEncSmemMax) {
    err = opt_in_smem(
        reinterpret_cast<const void*>(rans_encode_state_kernel<true>),
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rans_encode_state_kernel<true>
        <<<bsz * blocks_per_tile, kEncThreads, static_cast<int>(smem),
           stream>>>(symbols, ch_map, freq, start, offset, channels, support,
                     blocks_per_tile, words, flags, xfin, t_steps, s, w);
  } else {
    rans_encode_state_kernel<false>
        <<<bsz * blocks_per_tile, kEncThreads, 0, stream>>>(
            symbols, ch_map, freq, start, offset, channels, support,
            blocks_per_tile, words, flags, xfin, t_steps, s, w);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunk = chunks_for(t_steps, s);
  rans_count_kernel<<<bsz * nchunk, kScanThreads, 0, stream>>>(
      flags, t_steps * w, nchunk, counts);
  return static_cast<int>(cudaGetLastError());
}

// The compaction: the state pass's buffers -> out (B, capacity) uint16 words
// in decode order (words at or past capacity dropped, zeros past the total)
// and totals (B,) int32, the words each tile needs.
extern "C" int cae_rans_compact(const uint16_t* words, const uint32_t* flags,
                                const uint32_t* xfin, const int32_t* counts,
                                int bsz, int t_steps, int s, uint16_t* out,
                                int64_t capacity, int32_t* totals,
                                cudaStream_t stream) {
  if (bad_geometry(t_steps, s) || capacity < 2LL * s)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0) return 0;
  const int w = (s + 31) / 32;
  const int nchunk = chunks_for(t_steps, s);
  rans_compact_kernel<<<bsz * nchunk, kScanThreads, 0, stream>>>(
      words, flags, xfin, counts, nchunk, t_steps * w, t_steps, s, w, out,
      capacity, totals);
  return static_cast<int>(cudaGetLastError());
}

// The decode: queues (B, qlen) uint16, ch_map (T, S) int32, lut (C, 4096)
// int32, 16-byte aligned -> out (B, T, S) int32 value indices; states is a
// (B, S) scratch.
extern "C" int cae_rans_decode(const uint16_t* queues, int bsz, int64_t qlen,
                               const int32_t* ch_map, const int32_t* lut,
                               int channels, int32_t* out, uint32_t* states,
                               int t_steps, int s, cudaStream_t stream) {
  // the LUT rows are staged by 16-byte copies
  if (bad_geometry(t_steps, s) || qlen < 1 || qlen > INT_MAX / 2 ||
      channels < 1 || (reinterpret_cast<uintptr_t>(lut) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0) return 0;
  const bool window =
      qlen % 8 == 0 && (reinterpret_cast<uintptr_t>(queues) & 15) == 0;
  const int q = static_cast<int>(qlen);
  const int ch_rows =
      s % 4 == 0 && (reinterpret_cast<uintptr_t>(ch_map) & 15) == 0
          ? ch_rows_for(s)
          : 0;
  int per = 1;
  while (per < kRegPerMax && s > kDecThreads * per) per *= 2;
  if (s > kDecThreads * per) per = (s + kDecThreads - 1) / kDecThreads;
  const int threads = 32 * ((s + 32 * per - 1) / (32 * per));
  const auto launch = [&](auto kernel) {
    const cudaError_t err =
        opt_in_smem(reinterpret_cast<const void*>(kernel), kDecSmem);
    if (err != cudaSuccess) return err;
    kernel<<<bsz, threads + 32, kDecSmem, stream>>>(
        queues, q, window, ch_map, ch_rows, lut, channels, out, states,
        t_steps, s, per);
    return cudaGetLastError();
  };
  cudaError_t err;
  switch (s > kDecThreads * kRegPerMax ? 0 : per) {
    case 1: err = launch(rans_decode_kernel<1>); break;
    case 2: err = launch(rans_decode_kernel<2>); break;
    case 4: err = launch(rans_decode_kernel<4>); break;
    case 8: err = launch(rans_decode_kernel<8>); break;
    case 16: err = launch(rans_decode_kernel<16>); break;
    default: err = launch(rans_decode_kernel<0>);
  }
  return static_cast<int>(err);
}

// Interleaved rANS-32/16 encode and decode of cae_tpu frame v4, for the
// H100 (sm_90a).
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
// renormalise at t, in stream order.
//
// What bounds them here: the bytes they must move are small (4 bytes per
// symbol in or out, plus about 2 bytes per coded word), but each tile is a
// chain of T serial steps, each ending in a block-wide scan.  With one
// block per tile a batch of B tiles fills only B of the 132 SMs, so latency
// of the serial chain, not bandwidth, sets the time.  Kept simple on
// purpose; the design records it rather than hiding it.
//
// Design: one thread block per tile, one thread per stream (S <= 1024,
// rounded up to a warp multiple, the extra threads masked).  A step's
// refill or emit ranks come from a block-wide exclusive count of the flags
// (warp __ballot_sync + __popc, warp totals through shared memory), which
// replaces the TPU kernel's lane shuffles, 9-row windows and butterfly
// compaction.  The decoder reads the LUT entry and its refill word straight
// from device memory; refill reads are clamped to the queue, so a corrupt or
// truncated frame reads no memory out of bounds.  The encoder divides
// exactly with the hardware (q = x / f), so it needs neither reciprocals nor
// the TPU kernel's +1 overshoot correction once f > 2^11.  It walks t from
// T-1 down to 0 and writes each step's words back-aligned into a
// worst-case (T * S word) queue; the wrapper front-aligns them and
// prepends the flush words.  The per-step channel map is taken in full
// (T, S), so every geometry runs: planes that are not a multiple of S,
// steps that span two channels, any S up to 1024.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr uint32_t kPrecision = 12;
constexpr uint32_t kMask = (1u << kPrecision) - 1u;
constexpr uint32_t kStateMin = 1u << 16;
constexpr uint32_t kEmitShift = 20;

// reads past a (corrupt or truncated) queue's end take its last word
__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t qlen) {
  return i < qlen ? i : qlen - 1;
}

__global__ void rans_encode_kernel(const int32_t* __restrict__ symbols,
                                   const int32_t* __restrict__ ch_map,
                                   const int32_t* __restrict__ freq,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ offset,
                                   int support, int32_t* __restrict__ queue,
                                   int64_t capw, int32_t* __restrict__ backs,
                                   int32_t* __restrict__ xfin, int t_steps,
                                   int s) {
  __shared__ int s_warp[32];
  const int tile = blockIdx.x;
  const int st = threadIdx.x;
  const bool active = st < s;
  const int32_t* sym = symbols + static_cast<int64_t>(tile) * t_steps * s;
  int32_t* q = queue + static_cast<int64_t>(tile) * capw;
  uint32_t x = kStateMin;
  int64_t back = 0;  // words written so far, back-aligned
  for (int t = t_steps - 1; t >= 0; --t) {
    bool emit = false;
    uint32_t word = 0;
    if (active) {
      const int ch = ch_map[static_cast<int64_t>(t) * s + st];
      int v = sym[static_cast<int64_t>(t) * s + st] - offset[ch];
      v = min(max(v, 0), support - 1);
      const uint32_t f = static_cast<uint32_t>(freq[ch * support + v]);
      const uint32_t c = static_cast<uint32_t>(start[ch * support + v]);
      emit = (x >> kEmitShift) >= f;
      word = x & 0xFFFFu;
      if (emit) x >>= 16;
      const uint32_t quot = x / f;
      x = (quot << kPrecision) + (x - quot * f) + c;
    }
    int k;
    const int rank = block_exclusive_count(emit, s_warp, &k);
    if (emit) q[capw - back - k + rank] = static_cast<int32_t>(word);
    back += k;
  }
  if (active) xfin[static_cast<int64_t>(tile) * s + st] =
      static_cast<int32_t>(x);
  if (st == 0) backs[tile] = static_cast<int32_t>(back);
}

__global__ void rans_decode_kernel(const int32_t* __restrict__ queues,
                                   int64_t qlen,
                                   const int32_t* __restrict__ ch_map,
                                   const int32_t* __restrict__ lut,
                                   int32_t* __restrict__ out, int t_steps,
                                   int s) {
  __shared__ int s_warp[32];
  const int tile = blockIdx.x;
  const int st = threadIdx.x;
  const bool active = st < s;
  const int32_t* q = queues + static_cast<int64_t>(tile) * qlen;
  int32_t* o = out + static_cast<int64_t>(tile) * t_steps * s;
  uint32_t x = 0;
  if (active) {
    const uint32_t lo = static_cast<uint32_t>(q[clamp_index(2 * st, qlen)]);
    const uint32_t hi =
        static_cast<uint32_t>(q[clamp_index(2 * st + 1, qlen)]);
    x = lo | (hi << 16);
  }
  int64_t base = 2 * static_cast<int64_t>(s);  // next unread queue word
  for (int t = 0; t < t_steps; ++t) {
    bool need = false;
    uint32_t val = 0;
    if (active) {
      const int ch = ch_map[static_cast<int64_t>(t) * s + st];
      const uint32_t cum = x & kMask;
      const uint32_t p = static_cast<uint32_t>(lut[ch * 4096 + cum]);
      const uint32_t f = (p & kMask) + 1u;
      const uint32_t c = (p >> kPrecision) & kMask;
      val = p >> 24;
      x = f * (x >> kPrecision) + cum - c;
      need = x < kStateMin;
    }
    int k;
    const int rank = block_exclusive_count(need, s_warp, &k);
    if (need)
      x = (x << 16) | static_cast<uint32_t>(q[clamp_index(base + rank, qlen)]);
    base += k;
    if (active) o[static_cast<int64_t>(t) * s + st] = static_cast<int32_t>(val);
  }
}

int threads_for(int s) { return ((s + 31) / 32) * 32; }

}  // namespace

extern "C" int cae_rans_encode(const int32_t* symbols, const int32_t* ch_map,
                               const int32_t* freq, const int32_t* start,
                               const int32_t* offset, int support, int bsz,
                               int32_t* queue, int64_t capw, int32_t* backs,
                               int32_t* xfin, int t_steps, int s,
                               cudaStream_t stream) {
  if (s < 1 || s > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0) return 0;
  rans_encode_kernel<<<bsz, threads_for(s), 0, stream>>>(
      symbols, ch_map, freq, start, offset, support, queue, capw, backs,
      xfin, t_steps, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cae_rans_decode(const int32_t* queues, int bsz, int64_t qlen,
                               const int32_t* ch_map, const int32_t* lut,
                               int32_t* out, int t_steps, int s,
                               cudaStream_t stream) {
  if (s < 1 || s > 1024 || qlen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0) return 0;
  rans_decode_kernel<<<bsz, threads_for(s), 0, stream>>>(
      queues, qlen, ch_map, lut, out, t_steps, s);
  return static_cast<int>(cudaGetLastError());
}

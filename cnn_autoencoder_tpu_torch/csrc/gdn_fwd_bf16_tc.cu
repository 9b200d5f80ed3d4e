// K2, the GDN / IGDN forward of the bf16 training mode, and K1 on bf16
// rows, the bf16 serving mode's GDN, on the H100's bf16 tensor cores
// (sm_90a).
//
// K2 replaces cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:
// _gdn_train_fwd_kernel (pallas_call in _gdn_train_fwd_pallas).  From bf16
// rows x (N, C), gamma (C, C) and beta (C,), both float32:
//   norm[n, o] = beta[o] + sum_i bf16(x[n, i]^2) * bf16(gamma[o, i])
//   r = norm^(-1/2)   (IGDN: norm^(+1/2)),   y = bf16(x r),   rb = bf16(r)
// the pool at ops/gdn.py:norm_pool_precision for bf16 rows: x^2 and gamma
// rounded to bf16, the products summed in float32.  rb is the backward's
// residual (K3, csrc/gdn_bf16_tc.cu).  Float32 rows take K1's kernel with
// r (csrc/gdn_tc.cu), with its float32-accurate pool.
//
// K1 on bf16 rows (cae_gdn_fwd_bf16) replaces _gdn_kernel (pallas_call in
// _gdn_pallas) given bf16 blocks: the same y, without rb.  It is the same
// kernels instantiated with kWantR = false, which leaves out the r tile,
// its staging and its stores; float32 rows of K1 take csrc/gdn_tc.cu.
//
// What bounds it: at C = 128 the pool is 2 C = 256 operations per element
// against 6 bytes read and written once (x in, y and r out).  Both
// multiplicands are bf16, so their products are exact in float32 and one
// bf16 mma.sync pass with float32 accumulators computes the pool: at the
// bf16 tensor-core rate (989 TFLOP/s) it is 0.009 ms at (262144, 128)
// against 0.060 ms of bytes, so the function is bound by memory.  What
// keeps the kernel above that bound is the latency of each tile's chain on
// the SM (copies, x^2, product, epilogue, three barriers), not the
// instructions it issues: the design moves every byte once and runs as
// many tiles at once as the SM holds.
//
// Design.  A prep kernel launched by the same C entry rounds gamma to bf16
// once per call into a wrapper-owned workspace, as stored (row o holds
// gamma[o, .], the column-major B operand) and zero-padded to whole tiles.
//
// C <= 128 (the flagship's layers; gdn_fwd_tc_resident): one persistent
// block per SM holds the whole bf16 gamma and beta in shared memory, loaded
// once, and kGroups groups of 8 warps that take tiles of 32 rows x all C
// channels in turn, each with its own named barrier and kStages stage
// buffers.  A tile of x is one contiguous span in device memory; it comes
// by 16-byte cp.async into rows padded to 128 + 8 channels (so ldmatrix and
// the epilogue's reads hit 32 banks), the next kStages - 1 tiles' copies in
// flight while one is computed.  Each thread squares 8 elements at a time
// in float32, rounds them once to bf16 and writes them into the A tile; the
// warps multiply A by gamma with ldmatrix and m16n8k16 bf16 mma (2 x 4
// warps of 16 rows x 32 channels); each thread's accumulators hold two
// adjacent channels of two rows, which it finishes where they are (beta,
// the root, x from the stage buffer), writing y in place of x and r into a
// tile of its own; the group then stores both tiles 16 bytes at a time.
// (Storing the fragments' bf16 pairs straight to device memory, 4 bytes a
// thread, saves the shared-memory round trip and a barrier, and was 2.4
// times slower on the H100; PERF.md.)  Every input byte is read from device
// memory once and every output byte written once.  Channels past C are zero
// in A, in gamma and in the stage buffers, so no product is guarded.
//
// C > 128 (gdn_fwd_tc_streamed, one group a block): for each chunk of 128
// output channels of a tile of 32 rows, 64-deep slices of x^2 (from device
// memory or L2) and of the bf16 gamma are staged and multiplied the same
// way, the sums held in registers; the epilogue reads x again.  It takes any
// C; it is not on the flagship's path.
//
// Any row count, GDN and IGDN.  Rows that are not 16-byte aligned, or whose
// width is not a multiple of 8, are staged element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bf16_mma.cuh"
#include "smem_copy.cuh"
#include "tf32_mma.cuh"

// Probe builds only (csrc/probes/gdn_fwd_probe.cu, built by chip_smoke.py):
// GDN_FWD_NO_IO 1 neither copies the tiles in nor stores y and r (it stores
// only NaNs, which keeps them live), to time what the SM spends;
// GDN_FWD_LAPS 1 has thread 0 of every block add the clock64 cycles of each
// part of a tile (gdn_fwd_tc_resident) into g_fwd_laps.  The library builds
// with the defaults.
#ifndef GDN_FWD_NO_IO
#define GDN_FWD_NO_IO 0
#endif
#ifndef GDN_FWD_LAPS
#define GDN_FWD_LAPS 0
#endif

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kGroups = 4;  // groups of a resident block
constexpr int kBlockThreads = kGroups * kGroupThreads;
constexpr int kStages = 3;  // stage buffers of x per group
constexpr int kLd = kChunk + 8;  // pitch of the resident layout's tiles
// a group moves a tile's rows 16 bytes at a time: thread gt takes channels
// 8 (gt % kRowChunks) .. + 7 of rows gt / kRowChunks + kPassRows k
constexpr int kRowChunks = kChunk / 8;
constexpr int kPassRows = kGroupThreads / kRowChunks;
static_assert(kRows % kPassRows == 0, "a group moves a tile in whole passes");
constexpr bool kNoIO = GDN_FWD_NO_IO;

#if GDN_FWD_LAPS
// cycles by part of a tile, summed over blocks and tiles: the wait for the
// tile's copies (with the next copies issued), x^2, the product (thread 0's
// warp), the epilogue
__device__ unsigned long long g_fwd_laps[4];
#endif

// add the cycles since `last` to part `part` (probe builds only)
__device__ __forceinline__ void lap(long long& last, int part) {
#if GDN_FWD_LAPS
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&g_fwd_laps[part], static_cast<unsigned long long>(now - last));
    last = now;
  }
#endif
}

// The roots of a thread's 16 norms, in place: rsqrtf (GDN) and sqrtf
// (IGDN), torch.rsqrt's and torch.sqrt's own (no fast-math).  IGDN takes
// the branch-free square root of tf32_mma.cuh, bit-identical to sqrtf,
// when every norm lies in its range (norms of beta >= 2^-100 and finite
// sums do), with one branch a thread.
template <bool kInverse>
__device__ __forceinline__ void roots(float (&v)[4][4]) {
  if (!kInverse) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = rsqrtf(v[j][q]);
    return;
  }
  bool in_range = true;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) in_range = in_range && root_in_range(v[j][q]);
  if (in_range) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = sqrt_rn_in_range(v[j][q]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = sqrtf(v[j][q]);
  }
}

// a bf16 value to device memory.  Probe builds without traffic store only
// NaNs, which keeps the work feeding them.
__device__ __forceinline__ void store_one(bf16* p, float a) {
  if (kNoIO && a == a) return;
  *p = __float2bfloat16(a);
}

// bytes of one group's shared memory in the resident layout: A, the r
// tile (where r is wanted) and kStages padded tiles of x
template <bool kWantR>
__host__ __device__ constexpr int group_smem() {
  return (1 + kWantR + kStages) * kRows * kLd * 2;
}

template <bool kWantR>
constexpr int resident_smem() {
  return kChunk * kLd * 2 + kChunk * 4 + kGroups * group_smem<kWantR>();
}
constexpr int kStreamedSmem = (kRows + kChunk) * (kSliceK + 8) * 2;

// rows [0, rows) of x (pitch c; 16-byte aligned when aligned) into the
// padded tile dst (pitch kLd) by the threads gt of a group: 16-byte
// cp.async copies where rows are whole 16-byte chunks, element by element
// else
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* x, int rows,
                                           int c, bool aligned, int gt) {
  if (aligned && c % 8 == 0) {
    const int col = 8 * (gt % kRowChunks);
    if (col >= c) return;
#pragma unroll
    for (int k = 0; k < kRows / kPassRows; ++k) {
      const int r = gt / kRowChunks + kPassRows * k;
      if (r < rows) cp_async16(dst + r * kLd + col, x + r * c + col);
    }
  } else {
    for (int e = gt; e < rows * c; e += kGroupThreads) {
      const int r = e / c;
      dst[r * kLd + e - r * c] = x[e];
    }
  }
}

// rows [0, rows) of the padded tile src into dst (pitch c; 16-byte aligned)
__device__ __forceinline__ void unstage_rows(bf16* dst, const bf16* src,
                                             int rows, int c, int gt) {
  if (c % 8 == 0) {
    const int col = 8 * (gt % kRowChunks);
    if (col >= c) return;
#pragma unroll
    for (int k = 0; k < kRows / kPassRows; ++k) {
      const int r = gt / kRowChunks + kPassRows * k;
      if (r < rows) {
        *reinterpret_cast<uint4*>(dst + r * c + col) =
            *reinterpret_cast<const uint4*>(src + r * kLd + col);
      }
    }
  } else {
    for (int e = gt; e < rows * c; e += kGroupThreads) {
      const int r = e / c;
      dst[e] = src[r * kLd + e - r * c];
    }
  }
}

// C <= 128, K padded to kChunk.  Shared memory: gamma [kChunk][kLd] bf16,
// beta [kChunk] float, then for each of the kGroups groups A [kRows][kLd],
// r [kRows][kLd] (kWantR only) and kStages stage buffers of x
// [kRows][kLd], all bf16.
template <bool kInverse, bool kWantR>
__global__ void __launch_bounds__(kBlockThreads, 1)
gdn_fwd_tc_resident(const bf16* __restrict__ x, const bf16* __restrict__ gb,
                    const float* __restrict__ beta, bf16* __restrict__ y,
                    bf16* __restrict__ rb, int64_t n, int c, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = kRows * kLd;  // elements of a padded tile
  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  const int warp = gtid >> 5, lane = gtid & 31;
  const int wm = warp % kWarpRows, wn = warp / kWarpRows;
  bf16* s_gamma = reinterpret_cast<bf16*>(smem);
  float* s_beta = reinterpret_cast<float*>(s_gamma + kChunk * kLd);
  bf16* s_a = reinterpret_cast<bf16*>(s_beta + kChunk) +
              group * group_smem<kWantR>() / 2;
  bf16* s_r = s_a + kTile;  // kWantR only
  bf16* s_stage = s_a + (1 + kWantR) * kTile;

  // gamma and beta once per block, before any group starts
  for (int q = threadIdx.x; q < kChunk * kRowChunks; q += kBlockThreads) {
    const int row = q / kRowChunks, col = 8 * (q % kRowChunks);
    cp_async16(s_gamma + row * kLd + col, gb + row * kChunk + col);
  }
  cp_async_commit();
  // beta, and 1 past C (finite roots of channels that are not stored)
  for (int o = threadIdx.x; o < kChunk; o += kBlockThreads)
    s_beta[o] = o < c ? beta[o] : 1.f;
  // A and the stage buffers start zero: channels past C stay zero, and rows
  // past a ragged tile's end hold finite values
  for (int q = gtid; q < (1 + kWantR + kStages) * kTile / 8;
       q += kGroupThreads)
    reinterpret_cast<uint4*>(s_a)[q] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  __syncthreads();

  const int64_t ntiles = (n + kRows - 1) / kRows;
  const int64_t first = kGroups * static_cast<int64_t>(blockIdx.x) + group;
  const int64_t stride = kGroups * static_cast<int64_t>(gridDim.x);
  auto issue = [&](int64_t t, int buf) {
    if (t < ntiles && !kNoIO)
      stage_rows(s_stage + buf * kTile, x + t * kRows * c, tile_rows(n, t),
                 c, aligned, gtid);
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  for (int s = 0; s < kStages - 1; ++s) issue(first + s * stride, s);

  const bool has_cols = kWarpCols * wn < c;  // else this warp's are all past C
  const int g = lane >> 2, tq = lane & 3;
  int buf = 0;
  long long last = GDN_FWD_LAPS ? clock64() : 0;
  for (int64_t t = first; t < ntiles; t += stride) {
    cp_async_wait<kStages - 2>();  // this tile has landed
    group_sync(group);  // ... for every thread; the previous tile is done
    // the previous tile's buffer takes the tile kStages - 1 ahead
    issue(t + (kStages - 1) * stride, (buf + kStages - 1) % kStages);
    lap(last, 0);
    bf16* sx = s_stage + buf * kTile;
    const int rows = tile_rows(n, t);
    const int64_t base = t * kRows * c;

    // x^2 in float32, rounded once to bf16, into A: all kChunk channels of
    // the tile (channels past C are zero and stay zero)
#pragma unroll
    for (int k = 0; k < kRows / kPassRows; ++k) {
      const int row = gtid / kRowChunks + kPassRows * k;
      const int col = 8 * (gtid % kRowChunks);
      float v[8];
      load8(sx + row * kLd + col, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= v[i];
      *reinterpret_cast<uint4*>(s_a + row * kLd + col) = pack8(v);
    }
    group_sync(group);
    lap(last, 1);

    if (has_cols) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      warp_mma_bf16<4, kChunk / 16>(s_a, kLd, s_gamma, kLd, 16 * wm,
                                    kWarpCols * wn, acc);
      lap(last, 2);
      // the norms and their roots in place: acc[j][2 hr + h] is row
      // 16 wm + g + 8 hr, channel kWarpCols wn + 8 j + 2 (lane % 4) + h
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bt = *reinterpret_cast<const float2*>(
            s_beta + kWarpCols * wn + 8 * j + 2 * tq);
        acc[j][0] += bt.x;
        acc[j][1] += bt.y;
        acc[j][2] += bt.x;
        acc[j][3] += bt.y;
      }
      roots<kInverse>(acc);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * wm + g + 8 * hr;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kWarpCols * wn + 8 * j + 2 * tq;
          if (col >= c) continue;
          bf16* xs = sx + row * kLd + col;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const bf162*>(xs));
          const float r0 = acc[j][2 * hr], r1 = acc[j][2 * hr + 1];
          const float y0 = xv.x * r0, y1 = xv.y * r1;
          // y in place of x, r into its tile; nothing past C, where the
          // padding stays zero
          bf16* rs = s_r + row * kLd + col;
          if (c % 2 == 0 || col + 1 < c) {
            *reinterpret_cast<bf162*>(xs) = __floats2bfloat162_rn(y0, y1);
            if (kWantR)
              *reinterpret_cast<bf162*>(rs) = __floats2bfloat162_rn(r0, r1);
          } else {
            *xs = __float2bfloat16(y0);
            if (kWantR) *rs = __float2bfloat16(r0);
          }
        }
      }
    }
    group_sync(group);
    if (!kNoIO) {
      unstage_rows(y + base, sx, rows, c, gtid);
      if (kWantR) unstage_rows(rb + base, s_r, rows, c, gtid);
    }
    lap(last, 3);
    buf = (buf + 1) % kStages;
  }
  cp_async_wait<0>();
}

// C > 128, one group a block.  Shared memory: A [kRows][kSliceK + 8] bf16,
// gamma [kChunk][kSliceK + 8] bf16.
template <bool kInverse, bool kWantR>
__global__ void __launch_bounds__(kGroupThreads)
gdn_fwd_tc_streamed(const bf16* __restrict__ x, const bf16* __restrict__ gb,
                    const float* __restrict__ beta, bf16* __restrict__ y,
                    bf16* __restrict__ rb, int64_t n, int c, int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kSliceK + 8;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_gamma = s_a + kRows * ld;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWarpRows, wn = warp / kWarpRows;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t ntiles = (n + kRows - 1) / kRows;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int rows = tile_rows(n, t);
    const bf16* xt = x + t * kRows * c;
    for (int n0 = 0; n0 < c; n0 += kChunk) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      for (int k0 = 0; k0 < kp; k0 += kSliceK) {
        for (int q = tid; q < kChunk * (kSliceK / 8); q += kGroupThreads) {
          const int row = q / (kSliceK / 8), col = 8 * (q % (kSliceK / 8));
          cp_async16(s_gamma + row * ld + col,
                     gb + static_cast<int64_t>(n0 + row) * kp + k0 + col);
        }
        cp_async_commit();
        for (int e = tid; e < kRows * kSliceK; e += kGroupThreads) {
          const int r = e / kSliceK, k = e - r * kSliceK;
          const float v = (r < rows && k0 + k < c && !kNoIO)
                              ? __bfloat162float(xt[r * c + k0 + k])
                              : 0.f;
          s_a[r * ld + k] = __float2bfloat16(v * v);
        }
        cp_async_wait<0>();
        __syncthreads();
        warp_mma_bf16<4, kSliceK / 16>(s_a, ld, s_gamma, ld, 16 * wm,
                                       kWarpCols * wn, acc);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = n0 + kWarpCols * wn + 8 * j + 2 * tq + h;
          const float bt = o < c ? __ldg(beta + o) : 1.f;
          acc[j][h] += bt;
          acc[j][2 + h] += bt;
        }
      roots<kInverse>(acc);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * wm + g + 8 * hr;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = n0 + kWarpCols * wn + 8 * j + 2 * tq + h;
            if (row >= rows || o >= c) continue;
            const int64_t e = t * kRows * c + row * c + o;
            const float r = acc[j][2 * hr + h];
            store_one(y + e, __bfloat162float(x[e]) * r);
            if (kWantR) store_one(rb + e, r);
          }
      }
    }
  }
}

// rb is written only with kWantR (null without)
template <bool kInverse, bool kWantR>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta,
                   bf16* y, bf16* rb, bf16* gb, int64_t n, int c,
                   cudaStream_t stream) {
  cudaError_t err = launch_gamma_bf16_prep(gamma, gb, c, 0, stream);
  if (err != cudaSuccess) return err;
  const bool resident = c <= kChunk;
  const int64_t ntiles = (n + kRows - 1) / kRows;
  const void* kernel =
      resident ? reinterpret_cast<const void*>(
                     gdn_fwd_tc_resident<kInverse, kWantR>)
               : reinterpret_cast<const void*>(
                     gdn_fwd_tc_streamed<kInverse, kWantR>);
  const int threads = resident ? kBlockThreads : kGroupThreads;
  const int smem = resident ? resident_smem<kWantR>() : kStreamedSmem;
  int blocks = 0;
  err = opt_in_smem(kernel, smem);
  if (err == cudaSuccess) err = resident_blocks(kernel, threads, smem, &blocks);
  if (err != cudaSuccess) return err;
  // a resident block's groups take kGroups tiles at a time
  const unsigned grid = static_cast<unsigned>(std::min<int64_t>(
      resident ? (ntiles + kGroups - 1) / kGroups : ntiles, blocks));
  if (resident) {
    const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    gdn_fwd_tc_resident<kInverse, kWantR><<<grid, threads, smem, stream>>>(
        x, gb, beta, y, rb, n, c, aligned);
  } else {
    gdn_fwd_tc_streamed<kInverse, kWantR><<<grid, threads, smem, stream>>>(
        x, gb, beta, y, rb, n, c, gamma_bf16_kp(c));
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace cae_gdn_train_fwd takes for C channels: the bf16
// gamma, padded.
extern "C" int64_t cae_gdn_train_fwd_workspace(int c) {
  return gamma_bf16_bytes(c);
}

// x, y and rb are bf16 (N, C) rows, y and rb 16-byte aligned; gamma is
// float32 (C, C), beta float32 (C,); work holds
// cae_gdn_train_fwd_workspace(c) bytes, 16-byte aligned.
extern "C" int cae_gdn_train_fwd(const void* x, const float* gamma,
                                 const float* beta, void* y, void* rb,
                                 void* work, int64_t n, int c, int inverse,
                                 cudaStream_t stream) {
  if (n == 0 || c == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(rb) |
       reinterpret_cast<uintptr_t>(work)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  bf16* r = static_cast<bf16*>(rb);
  bf16* gb = static_cast<bf16*>(work);
  const cudaError_t err =
      inverse ? launch<true, true>(xb, gamma, beta, yb, r, gb, n, c, stream)
              : launch<false, true>(xb, gamma, beta, yb, r, gb, n, c, stream);
  return static_cast<int>(err);
}

// Bytes of the workspace cae_gdn_fwd_bf16 takes for C channels: the bf16
// gamma, padded.
extern "C" int64_t cae_gdn_fwd_bf16_workspace(int c) {
  return gamma_bf16_bytes(c);
}

// K1 on bf16 rows: y alone.  x and y are bf16 (N, C) rows, y 16-byte
// aligned; gamma is float32 (C, C), beta float32 (C,); work holds
// cae_gdn_fwd_bf16_workspace(c) bytes, 16-byte aligned.
extern "C" int cae_gdn_fwd_bf16(const void* x, const float* gamma,
                                const float* beta, void* y, void* work,
                                int64_t n, int c, int inverse,
                                cudaStream_t stream) {
  if (n == 0 || c == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(work)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  bf16* gb = static_cast<bf16*>(work);
  const cudaError_t err =
      inverse
          ? launch<true, false>(xb, gamma, beta, yb, nullptr, gb, n, c, stream)
          : launch<false, false>(xb, gamma, beta, yb, nullptr, gb, n, c,
                                 stream);
  return static_cast<int>(err);
}

// K4: fused reflect-pad + 3x3 stride-2 convolution + GDN on the H100's
// tensor cores (sm_90a), its serving variant and its training (want_y)
// variant, for float32 and bf16 x.
//
// Replaces: cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel (its
// pallas_call in _fused_conv_gdn_pallas, entry fused_conv_gdn).  Computes,
// for NHWC x (B, H, W, Cin), HWIO weights (3, 3, Cin, Cout) and even H, W:
//   y[b, r, c, o]   = sum_{dy, dx, i} w[dy, dx, i, o] * x[b, R(2r+dy-1), R(2c+dx-1), i]
//   out[b, r, c, o] = y * (beta[o] + sum_i gamma[o, i] * y[b, r, c, i]^2)^(-1/2)
// with R the reflect index (-1 -> 1).  The training variant also writes
// the pre-GDN y in float32, the backward's residual.  Two compute types,
// chosen by x's type:
//   float32 x: float32-accurate products (the JAX package's HIGHEST);
//   bf16 x:    bf16 multiplicands (w rounded to bf16) and float32 sums
//              (DEFAULT on the matrix unit).
// The GDN pool is float32-accurate in both, and out is stored in x's type.
//
// What bounds it: 2 * (9 * Cin + Cout) * Cout FLOP per output pixel
// against Cin * 16 + Cout * 4 bytes (float32 x), far above the ridge.  On
// the tensor cores a float32 product takes three TF32 passes (below), so
// at the flagship's (16, 256, 256, 128) -> 128 its 85.9 GFLOP are 257.7
// G TF32 operations, 0.521 ms at the 495 TFLOP/s TF32 rate and about 0.83
// ms at the 310 TFLOP/s that mma.sync reaches on an H100 80GB HBM3 at 700
// W (K1's mma probe, csrc/probes); its bytes take 0.200 ms.  A bf16 conv
// is one pass.
//
// Arithmetic.  A product of float32 values takes three TF32 passes, as in
// K1 (csrc/gdn_tc.cu): both operands split into hi = rna(v) and lo =
// rna(v - hi) (tf32_split), and part += a_lo b_hi + a_hi b_lo + a_hi b_hi,
// small terms first; only a_lo b_lo (below 2^-22 of the product) is lost.
// bf16 values are exact in TF32, so the bf16 conv is one pass with exact
// products.  The tensor core's float32 accumulation rounds less closely
// than an FADD, so each k-step (8 channels of one tap, or of the pool)
// sums its passes into its own fragments, added to the float32
// accumulator after them: a chain of three products in the tensor core.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin, on
// m16n8k8 TF32 mma.sync.  A block of 8 warps owns 128 output pixels; its
// warps are 4 (pixels) x 2 (channels), each with a 32 x 64 tile of
// accumulators (64 floats a thread), so a block covers 128 channels at a
// time.  The weights are split once per call, not once per block: a prep
// kernel launched first writes w (and gamma^T, the pool's B) as hi/lo
// pairs in mma fragment order, 32-channel K-slices of 128 output channels
// each, zero past Cin and Cout; a lane then reads its B values for an
// n-tile and k-step with one 16-byte load.  Each K-slice goes through a
// ring of shared-memory stages: x's 32 channels of one tap for the tile's
// 128 pixels by cp.async (the reflect index comes from a per-block table
// of each pixel's nine source pixels, so there is no padded copy and no
// nine-tap stack), the matching weight slice by one bulk copy of the
// tensor memory accelerator onto the stage's mbarrier.  The conv's ring
// has four stages, the fourth in the y tile's place (free until y is
// written), so three slices load while one is multiplied.  x is split in
// registers as its fragments are loaded.
//
// The GDN pool needs each pixel's whole channel row.  Where Cout <= 128
// the block holds it: y goes from the accumulators into a shared-memory
// tile, the pool (y^2 from the tile, gamma^T slices through the same
// ring) runs on the tensor cores in three passes, and out = y * rsqrt
// (norm) is written over the tile and stored with 16-byte streaming
// stores.  Wider Cout takes the 128-channel chunks in turn: each chunk's
// conv writes its y to device memory (the y output, or a row store in the
// workspace), and after all chunks the pool stages y^2's slices
// through the ring from there (the block reads back only the rows it
// wrote), chunk by chunk, and writes out.  The epilogue's square root and
// reciprocal are K1's correctly rounded ones.
//
// Cin and Cout take any value: channels are padded in shared memory and
// the prep buffer only (channels past Cout multiply zero weights, so no
// product is guarded), stores are masked, and x rows that are not 16-byte
// aligned are staged element by element.  The flagship's Cin = Cout = 128
// has its own instantiation with every offset a constant.
//
// Budget (ptxas -v, sm_90a, CUDA 12.8; chip_smoke.py logs it): 255
// registers in every instantiation, no spills but in the float32 one for
// Cout > 128 (164 bytes stored, 356 loaded; 8 and 32 in its bf16 twin).
// The float32 adds after every k-step cost 17 % at the flagship (a
// 32-channel slice per add ran in 1.41 ms where this runs in 1.66 ms on an
// H100 80GB HBM3 at 700 W) and keep the float32 train step's losses within
// 2.5e-7 of the plain versions', where one add a slice read 8.6e-6 (the
// limit is 1e-5): the tensor core's truncating sums biased y.
// Shared memory at Cout <= 128 in float32: three
// stages of 18 KB of x (10 KB in bf16) and 32 KB of weights, the 66 KB y
// tile, a 4.5 KB tap table and the stages' mbarriers, 225824 bytes: one
// block of 8 warps on each SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

// Probe builds only (csrc/probes/conv_gdn_probe.cu, built by
// chip_smoke.py): CONV_GDN_PASSES 1 multiplies the float32 conv in one
// TF32 pass (hi x hi, no split of x); CONV_GDN_NO_IO 1 copies nothing into
// the ring (the products run on whatever shared memory holds), to time the
// kernel without its loads; CONV_GDN_NO_LDS 1 also takes every mma operand
// from registers (no fragment loads, no split), to time the products,
// barriers and epilogue alone.  The library builds with the defaults.
#ifndef CONV_GDN_PASSES
#define CONV_GDN_PASSES 3
#endif
#ifndef CONV_GDN_NO_IO
#define CONV_GDN_NO_IO 0
#endif
#ifndef CONV_GDN_NO_LDS
#define CONV_GDN_NO_LDS 0
#endif

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (pixels) x 2 (channels)
constexpr int kTileM = 128;    // output pixels of a block
constexpr int kChunkN = 128;   // output channels of a block at a time
constexpr int kSliceK = 32;    // K-slice staged per ring stage
constexpr int kStages = 3;     // ring stages beside the y tile
constexpr int kConvDepth = 4;  // the conv's ring: a fourth stage in the
                               // y tile's place (free until y is written)
constexpr int kF32Passes = CONV_GDN_PASSES;
constexpr bool kNoIO = CONV_GDN_NO_IO;
constexpr bool kNoLds = CONV_GDN_NO_LDS;
constexpr int kWarpsN = 2;     // warps side by side over a chunk
constexpr int kWarpRows = kTileM / (kThreads / 32 / kWarpsN);  // 32
constexpr int kMI = kWarpRows / 16;          // m16 tiles of a warp: 2
constexpr int kNJ = kChunkN / kWarpsN / 8;  // n8 tiles of a warp: 8
constexpr int kPitchF = kSliceK + 4;  // float32 rows of a staged slice
constexpr int kPitchH = kSliceK + 8;  // bf16 rows of a staged slice
constexpr int kPitchY = kChunkN + 4;  // rows of the y tile
// a K-slice of B for one 128-channel chunk, in fragment order: float4
// {hi[k], hi[k+4], lo[k], lo[k+4]} (three passes) or float2 {hi[k],
// hi[k+4]} (one pass) at ((j * 4 + ks) * 32 + lane), n = 8 j + lane / 4,
// k = 8 ks + lane % 4
constexpr int kEntries = (kChunkN / 8) * (kSliceK / 8) * 32;
constexpr int kTripleBytes = kEntries * 16;
constexpr int kSingleBytes = kEntries * 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// A stage's weight slice arrives by one bulk copy of the tensor memory
// accelerator, which completes on the stage's mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bytes of the prep buffer: per 128-channel chunk, 9 ceil(Cin / 32) conv
// slices (three-pass or, for bf16 x, one-pass entries), then, after every
// chunk's conv slices, ceil(Cout / 32) pool slices per chunk.
__host__ __device__ int64_t conv_region_bytes(int cin, int cout, int bf) {
  return static_cast<int64_t>((cout + kChunkN - 1) / kChunkN) * 9 *
         ((cin + kSliceK - 1) / kSliceK) * (bf ? kSingleBytes : kTripleBytes);
}

__host__ __device__ int64_t workspace_bytes(int cin, int cout, int bf) {
  return conv_region_bytes(cin, cout, bf) +
         static_cast<int64_t>((cout + kChunkN - 1) / kChunkN) *
             ((cout + kSliceK - 1) / kSliceK) * kTripleBytes;
}

// One thread per fragment entry: w (and gamma^T) into the prep buffer.
// Conv slice s of chunk nc is tap s / ceil(Cin / 32), input channels
// 32 (s % ceil(Cin / 32)) + [0, 32); B[k][n] = w[tap][k][n].  Pool slice g
// holds B[k][n] = gamma[n][k], k in 32 g + [0, 32).  bf16 (bf = 1) rounds
// the conv's weights to bf16 and keeps hi alone.
__global__ void conv_gdn_prep_kernel(const float* __restrict__ w,
                                     const float* __restrict__ gamma,
                                     unsigned char* __restrict__ work,
                                     int cin, int cout, int bf) {
  const int skt = (cin + kSliceK - 1) / kSliceK;
  const int sg = (cout + kSliceK - 1) / kSliceK;
  const int nch = (cout + kChunkN - 1) / kChunkN;
  const int64_t conv_n = static_cast<int64_t>(nch) * 9 * skt * kEntries;
  const int64_t total = conv_n + static_cast<int64_t>(nch) * sg * kEntries;
  const int64_t conv_bytes = conv_region_bytes(cin, cout, bf);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool pool = e >= conv_n;
    const int64_t f = pool ? e - conv_n : e;
    const int lane = static_cast<int>(f & 31);
    const int ks = static_cast<int>((f >> 5) & 3);
    const int j = static_cast<int>((f >> 7) & 15);
    const int64_t slice = f >> 11;  // nc * slices + s
    const int per = pool ? sg : 9 * skt;
    const int nc = static_cast<int>(slice / per);
    const int s = static_cast<int>(slice - static_cast<int64_t>(nc) * per);
    const int n = nc * kChunkN + 8 * j + lane / 4;
    const int kk = 8 * ks + lane % 4;
    float v0 = 0.f, v4 = 0.f;
    if (pool) {
      const int k = kSliceK * s + kk;
      const float* g = gamma + static_cast<int64_t>(n) * cout;
      if (n < cout && k < cout) v0 = g[k];
      if (n < cout && k + 4 < cout) v4 = g[k + 4];
    } else {
      const int tap = s / skt;
      const int k = kSliceK * (s - tap * skt) + kk;
      const float* wt = w + static_cast<int64_t>(tap) * cin * cout + n;
      if (n < cout && k < cin) v0 = wt[static_cast<int64_t>(k) * cout];
      if (n < cout && k + 4 < cin) v4 = wt[static_cast<int64_t>(k + 4) * cout];
    }
    if (!pool && bf) {
      reinterpret_cast<float2*>(work)[f] =
          make_float2(__bfloat162float(__float2bfloat16(v0)),
                      __bfloat162float(__float2bfloat16(v4)));
    } else {
      uint32_t h0, l0, h4, l4;
      tf32_split(v0, h0, l0);
      tf32_split(v4, h4, l4);
      float4* dst = reinterpret_cast<float4*>(work + (pool ? conv_bytes : 0));
      dst[f] = make_float4(__uint_as_float(h0), __uint_as_float(h4),
                           __uint_as_float(l0), __uint_as_float(l4));
    }
  }
}

// One K-slice of 32 on the tensor cores: acc += A[:, 0:32] B (A's rows
// from `a` with row pitch `pitch`, squared first where kSquare; B the
// slice's fragments at `b`: hi alone where A is bf16, else hi and lo),
// each k-step of 8 in kPasses TF32 passes into its own fragments, added
// to acc in float32 after them.  One pass on float32 A (probe builds)
// multiplies the rounded hi parts alone.
// Channels past Cout multiply zero weights: no product is guarded.
template <int kPasses, bool kSquare, typename AT>
__device__ __forceinline__ void slice_mma(float (&acc)[kMI][kNJ][4],
                                          const AT* __restrict__ a,
                                          int pitch,
                                          const unsigned char* __restrict__ b,
                                          int wm, int wn, int lane) {
  constexpr bool kBf16A = std::is_same<AT, bf16>::value;
  static_assert(!kBf16A || kPasses == 1, "bf16 slices hold hi alone");
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kSliceK / 8; ++ks) {
    uint32_t bh[kNJ][2], bl[kNJ][2];
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int e = ((wn * kNJ + jj) * (kSliceK / 8) + ks) * 32 + lane;
      if constexpr (kNoLds) {
        bh[jj][0] = bl[jj][1] = lane + 3u * jj;
        bh[jj][1] = bl[jj][0] = lane * 5u + ks;
      } else if constexpr (!kBf16A) {
        const float4 v = reinterpret_cast<const float4*>(b)[e];
        bh[jj][0] = __float_as_uint(v.x);
        bh[jj][1] = __float_as_uint(v.y);
        bl[jj][0] = __float_as_uint(v.z);
        bl[jj][1] = __float_as_uint(v.w);
      } else {
        const float2 v = reinterpret_cast<const float2*>(b)[e];
        bh[jj][0] = __float_as_uint(v.x);
        bh[jj][1] = __float_as_uint(v.y);
        bl[jj][0] = bl[jj][1] = 0u;
      }
    }
    uint32_t ah[kMI][4], al[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      if constexpr (kNoLds) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ah[mi][q] = al[mi][q] = lane * 7u + 16 * mi + 4 * ks + q;
        continue;
      }
      const AT* ap = a + (wm * kWarpRows + mi * 16 + gq) * pitch + ks * 8 + tq;
      const float v[4] = {widen(ap[0]), widen(ap[8 * pitch]), widen(ap[4]),
                          widen(ap[8 * pitch + 4])};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float t = kSquare ? v[q] * v[q] : v[q];
        if constexpr (kPasses == 3) {
          tf32_split(t, ah[mi][q], al[mi][q]);
        } else {  // bf16 values are exact in TF32; float32 ones round
          ah[mi][q] = kBf16A ? __float_as_uint(t) : tf32_rna(t);
          al[mi][q] = 0u;
        }
      }
    }
    // the passes, small terms first (lo hi, hi lo, hi hi), into the
    // k-step's own fragments; each pass runs over every sub-tile, so
    // consecutive products are independent
    float part[kMI][kNJ][4] = {};
#pragma unroll
    for (int pass = 3 - kPasses; pass < 3; ++pass)
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const uint32_t(&av)[4] = pass == 0 ? al[mi] : ah[mi];
          const uint32_t(&bv)[2] = pass == 1 ? bl[jj] : bh[jj];
          mma_tf32(part[mi][jj], av, bv[0], bv[1]);
        }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][jj][q] += part[mi][jj][q];
  }
}

// Slices [0, n) through a ring of kDepth stages: issue(t, stage) starts
// slice t's copies (x by cp.async, the weights by a bulk copy on
// bars[stage]), compute(t, stage) multiplies it.  Slices t + 1 ..
// t + kDepth - 1 load while t is multiplied; one barrier a slice.  Bit st
// of `phase` is the parity of stage st's next completion.  Returns with
// every copy landed and every warp past its last compute.
template <int kDepth, typename Issue, typename Compute>
__device__ __forceinline__ void run_ring(int n, uint64_t* bars,
                                         uint32_t& phase, Issue&& issue,
                                         Compute&& compute) {
#pragma unroll
  for (int s = 0; s < kDepth - 1; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    const int st = t % kDepth;
    cp_async_wait<kDepth - 2>();  // slice t's own copies of x
    __syncthreads();  // everyone's; stage (t - 1) % kDepth is free
    const int nt = t + kDepth - 1;
    if (nt < n) issue(nt, nt % kDepth);
    cp_async_commit();
    if (!kNoIO) mbar_wait(bars + st, (phase >> st) & 1u);  // the weights
    phase ^= 1u << st;
    compute(t, st);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[kMI][kNJ][4]) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][jj][q] = 0.f;
}

// acc (the pool of chunk nc) becomes rsqrt(pool + beta), correctly rounded
// (K1's epilogue)
__device__ __forceinline__ void gdn_factor(float (&acc)[kMI][kNJ][4],
                                           const float* __restrict__ beta,
                                           int cout, int nc, int wn,
                                           int lane) {
  const int tq = lane & 3;
  bool in_range = true;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = min(nc * kChunkN + 8 * (wn * kNJ + jj) + 2 * tq +
                              (q & 1), cout - 1);
        acc[mi][jj][q] += __ldg(beta + o);
        in_range = in_range && root_in_range(acc[mi][jj][q]);
      }
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = acc[mi][jj][q];
        acc[mi][jj][q] = in_range ? rcp_rn_in_range(sqrt_rn_in_range(v))
                                  : 1.0f / sqrtf(v);
      }
}

// T is x's and out's type.  kCi, kCo: Cin and Cout known when compiled (0:
// taken at run time).  kYTile: Cout <= 128, y held in shared memory; else
// y (never null then: the caller's, or a part of the workspace) is the row
// store between the conv and the pool.  y is written when it is not null.  vec_x: x rows and pointer 16-byte
// aligned; vec_y, vec_out: the same for y's and out's rows.
template <typename T, int kCi, int kCo, bool kYTile>
__global__ void __launch_bounds__(kThreads, 1)
conv_gdn_mma_kernel(const T* __restrict__ x,
                   const unsigned char* __restrict__ work,
                   const float* __restrict__ beta, T* __restrict__ out,
                   float* __restrict__ y, int h, int wd, int64_t npix,
                   int cin_run, int cout_run, int vec_x, int vec_y,
                   int vec_out) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kConvPasses = kBf16 ? 1 : kF32Passes;
  constexpr int kConvSliceBytes = kBf16 ? kSingleBytes : kTripleBytes;
  constexpr int kPitchX = kBf16 ? kPitchH : kPitchF;
  // a stage's x part: the conv's slice of x, or (row-store layout) a
  // float32 slice of y
  constexpr int kABytes = (kBf16 && kYTile) ? kTileM * kPitchH * 2
                                             : kTileM * kPitchF * 4;
  constexpr int kStageBytes = kABytes + kTripleBytes;
  static_assert(kCo == 0 || (kYTile && kCo <= kChunkN), "constant Cout");
  const int cin = kCi ? kCi : cin_run;
  const int cout = kCo ? kCo : cout_run;
  const int skt = (cin + kSliceK - 1) / kSliceK;  // conv slices per tap
  const int sc = 9 * skt;
  const int sg = (cout + kSliceK - 1) / kSliceK;  // pool slices
  const int nch = kYTile ? 1 : (cout + kChunkN - 1) / kChunkN;
  const int h2 = h / 2, w2 = wd / 2;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int rows = static_cast<int>(npix - p0 < kTileM ? npix - p0 : kTileM);
  const unsigned char* pool_b = work + conv_region_bytes(cin, cout, kBf16);

  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  // three stages, then the y tile (or, in the row-store layout, a fourth
  // stage), then the tap table
  float* ytile = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  int* taps = reinterpret_cast<int*>(
      ring + kStages * kStageBytes +
      (kYTile ? kTileM * kPitchY * 4 : kStageBytes));
  static_assert(kTileM * kPitchY * 4 >= kStageBytes, "a stage in the y tile");
  uint64_t* bars = reinterpret_cast<uint64_t*>(taps + 9 * kTileM);
  uint32_t phase = 0;
  constexpr int kPoolDepth = kYTile ? kStages : kConvDepth;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int gq = lane >> 2, tq = lane & 3;

  // each pixel's nine source pixels (b, R(2r + dy - 1), R(2c + dx - 1)) as
  // flat indices (B H W < 2^31, checked by the launcher); -1 past npix
  for (int e = tid; e < 9 * kTileM; e += kThreads) {
    const int tap = e / kTileM, p = e - tap * kTileM;
    int v = -1;
    if (p < rows) {
      const int pix = static_cast<int>(p0) + p;  // npix < 2^31
      const int b = pix / (h2 * w2);
      const int rem = pix - b * h2 * w2;
      const int oy = rem / w2, ox = rem - (rem / w2) * w2;
      const int iy = reflect(2 * oy + tap / 3 - 1, h);
      const int ix = reflect(2 * ox + tap % 3 - 1, wd);
      v = (b * h + iy) * wd + ix;
    }
    taps[e] = v;
  }
  if (tid == 0) {
    for (int i = 0; i < kConvDepth; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kMI][kNJ][4];

  // -- the conv, one 128-channel chunk at a time ---------------------------
  for (int nc = 0; nc < nch; ++nc) {
    zero(acc);
    auto issue = [&](int s, int st) {
      if (kNoIO) return;
      unsigned char* stage = ring + st * kStageBytes;  // st == 3: y tile
      const int tap = s / skt, c0 = kSliceK * (s - tap * skt);
      const int* tp = taps + tap * kTileM;
      T* sa = reinterpret_cast<T*>(stage);
      if (vec_x) {  // Cin * sizeof(T) % 16 == 0: a 16-byte group lies
                    // wholly inside or past Cin
        constexpr int kPer = 16 / sizeof(T);     // elements a copy
        constexpr int kGroups = kSliceK / kPer;  // copies a row
#pragma unroll
        for (int i = 0; i < kTileM * kGroups / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int r = e / kGroups, q = e - r * kGroups;
          const int c = c0 + q * kPer;
          const int pix = tp[r];
          const bool ok = pix >= 0 && c < cin;
          cp_async16_zfill(sa + r * kPitchX + q * kPer,
                           ok ? x + static_cast<int64_t>(pix) * cin + c : x,
                           ok);
        }
      } else {
        for (int e = tid; e < kTileM * kSliceK; e += kThreads) {
          const int r = e / kSliceK, k = e - r * kSliceK;
          const int c = c0 + k;
          const int pix = tp[r];
          sa[r * kPitchX + k] =
              (pix >= 0 && c < cin) ? x[static_cast<int64_t>(pix) * cin + c]
                                    : T(0.f);
        }
      }
      if (tid == 0)
        bulk_copy(stage + kABytes,
                  work + (static_cast<int64_t>(nc) * sc + s) * kConvSliceBytes,
                  kConvSliceBytes, bars + st);
    };
    auto compute = [&](int, int st) {
      const unsigned char* stage = ring + st * kStageBytes;
      slice_mma<kConvPasses, false>(acc, reinterpret_cast<const T*>(stage),
                                    kPitchX, stage + kABytes, wm, wn, lane);
    };
    run_ring<kConvDepth>(sc, bars, phase, issue, compute);

    // y: into the tile, or into the row store
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * kWarpRows + mi * 16 + gq + 8 * hh;
          const int o = 8 * (wn * kNJ + jj) + 2 * tq;
          const float y0 = acc[mi][jj][2 * hh], y1 = acc[mi][jj][2 * hh + 1];
          if constexpr (kYTile) {
            *reinterpret_cast<float2*>(ytile + r * kPitchY + o) =
                make_float2(y0, y1);
          } else {
            const int og = nc * kChunkN + o;
            if (r >= rows || og >= cout) continue;
            float* yp = y + (p0 + r) * cout + og;
            yp[0] = y0;
            if (og + 1 < cout) yp[1] = y1;
          }
        }
  }
  __syncthreads();  // y complete (tile or row store)
  if (kYTile && y != nullptr) {  // the training variant's residual
    if (vec_y) {
      const int per = cout / 4;
      for (int e = tid; e < rows * per; e += kThreads) {
        const int r = e / per, q = 4 * (e - r * per);
        __stcs(reinterpret_cast<float4*>(y + (p0 + r) * cout + q),
               *reinterpret_cast<const float4*>(ytile + r * kPitchY + q));
      }
    } else {
      for (int e = tid; e < rows * cout; e += kThreads) {
        const int r = e / cout, k = e - r * cout;
        y[(p0 + r) * cout + k] = ytile[r * kPitchY + k];
      }
    }
  }

  // -- the GDN pool, norm = y^2 gamma^T + beta, and out -------------------
  for (int nc = 0; nc < nch; ++nc) {
    zero(acc);
    auto issue = [&](int g, int st) {
      if (kNoIO) return;
      unsigned char* stage = ring + st * kStageBytes;
      if constexpr (!kYTile) {  // y's channels 32 g + [0, 32), float32
        float* sa = reinterpret_cast<float*>(stage);
        if (vec_y) {
#pragma unroll
          for (int i = 0; i < kTileM * 8 / kThreads; ++i) {
            const int e = tid + i * kThreads;
            const int r = e / 8, q = 4 * (e - r * 8);
            const int c = kSliceK * g + q;
            const bool ok = r < rows && c < cout;
            cp_async16_zfill(sa + r * kPitchF + q,
                             ok ? y + (p0 + r) * cout + c : y, ok);
          }
        } else {
          for (int e = tid; e < kTileM * kSliceK; e += kThreads) {
            const int r = e / kSliceK, k = e - r * kSliceK;
            const int c = kSliceK * g + k;
            sa[r * kPitchF + k] =
                (r < rows && c < cout) ? y[(p0 + r) * cout + c] : 0.f;
          }
        }
      }
      if (tid == 0)
        bulk_copy(stage + kABytes,
                  pool_b + (static_cast<int64_t>(nc) * sg + g) * kTripleBytes,
                  kTripleBytes, bars + st);
    };
    auto compute = [&](int g, int st) {
      const unsigned char* stage = ring + st * kStageBytes;
      if constexpr (kYTile)
        slice_mma<3, true>(acc, ytile + kSliceK * g, kPitchY,
                           stage + kABytes, wm, wn, lane);
      else
        slice_mma<3, true>(acc, reinterpret_cast<const float*>(stage),
                           kPitchF, stage + kABytes, wm, wn, lane);
    };
    run_ring<kPoolDepth>(sg, bars, phase, issue, compute);
    gdn_factor(acc, beta, cout, nc, wn, lane);

#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * kWarpRows + mi * 16 + gq + 8 * hh;
          const int o = 8 * (wn * kNJ + jj) + 2 * tq;
          const float f0 = acc[mi][jj][2 * hh], f1 = acc[mi][jj][2 * hh + 1];
          if constexpr (kYTile) {  // out over y: this thread alone reads
                                   // and writes these places
            float2* yp = reinterpret_cast<float2*>(ytile + r * kPitchY + o);
            const float2 v = *yp;
            *yp = make_float2(v.x * f0, v.y * f1);
          } else {
            const int og = nc * kChunkN + o;
            if (r >= rows || og >= cout) continue;
            const int64_t at = (p0 + r) * cout + og;
            put(out + at, y[at] * f0);
            if (og + 1 < cout) put(out + at + 1, y[at + 1] * f1);
          }
        }
  }

  if constexpr (kYTile) {  // the tile's rows of out
    __syncthreads();
    if (vec_out) {  // 16 bytes a store
      constexpr int kPer = 16 / sizeof(T);
      const int per = cout / kPer;
      for (int e = tid; e < rows * per; e += kThreads) {
        const int r = e / per, q = kPer * (e - r * per);
        const float* src = ytile + r * kPitchY + q;
        uint4 v;
        if constexpr (kBf16) {
          uint32_t u[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 p =
                __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
            u[i] = *reinterpret_cast<const uint32_t*>(&p);
          }
          v = make_uint4(u[0], u[1], u[2], u[3]);
        } else {
          v = *reinterpret_cast<const uint4*>(src);
        }
        __stcs(reinterpret_cast<uint4*>(out + (p0 + r) * cout + q), v);
      }
    } else {
      for (int e = tid; e < rows * cout; e += kThreads) {
        const int r = e / cout, k = e - r * cout;
        put(out + (p0 + r) * cout + k, ytile[r * kPitchY + k]);
      }
    }
  }
}

using Kernel = const void*;  // a conv_gdn_mma_kernel instantiation

template <typename T, int kCi, int kCo, bool kYTile>
Kernel kernel_ptr() {
  return reinterpret_cast<Kernel>(conv_gdn_mma_kernel<T, kCi, kCo, kYTile>);
}

int smem_bytes(bool bf, bool ytile) {
  const int a = (bf && ytile) ? kTileM * kPitchH * 2 : kTileM * kPitchF * 4;
  return kStages * (a + kTripleBytes) +
         (ytile ? kTileM * kPitchY * 4 : a + kTripleBytes) +
         9 * kTileM * 4 + kConvDepth * 8;
}

Kernel kernel_for(bool bf, int cin, int cout) {
  const bool flagship = cin == 128 && cout == 128;
  if (cout <= kChunkN) {
    if (bf)
      return flagship ? kernel_ptr<bf16, 128, 128, true>()
                      : kernel_ptr<bf16, 0, 0, true>();
    return flagship ? kernel_ptr<float, 128, 128, true>()
                    : kernel_ptr<float, 0, 0, true>();
  }
  return bf ? kernel_ptr<bf16, 0, 0, false>() : kernel_ptr<float, 0, 0, false>();
}

// The y row store's place in the workspace, after the split weights
int64_t row_store_offset(int cin, int cout, int bf) {
  return (workspace_bytes(cin, cout, bf) + 255) / 256 * 256;
}

}  // namespace

// Bytes of the scratch buffer cae_conv_gdn_fwd takes as `work`, for npix
// output pixels: the split weights and, where Cout > 128 and y is not
// wanted, the y row store.
extern "C" int64_t cae_conv_gdn_workspace(int64_t npix, int cin, int cout,
                                          int is_bf16, int want_y) {
  if (cout <= kChunkN || want_y) return workspace_bytes(cin, cout, is_bf16);
  return row_store_offset(cin, cout, is_bf16) + npix * cout * 4;
}

// x and out are float32 (is_bf16 = 0) or bf16 (is_bf16 = 1); w is HWIO
// (3, 3, Cin, Cout), gamma (Cout, Cout) with gamma[o, i] at o * Cout + i,
// beta (Cout,).  y (float32, the pre-GDN conv output) is written where it
// is not null.  work: cae_conv_gdn_workspace bytes (want_y = y != null).
extern "C" int cae_conv_gdn_fwd(const void* x, const float* w,
                                const float* gamma, const float* beta,
                                void* out, float* y, void* work, int bsz,
                                int h, int wd, int cin, int cout, int is_bf16,
                                cudaStream_t stream) {
  if ((h % 2) || (wd % 2) || h < 2 || wd < 2 || cin < 1 || cout < 1 ||
      bsz < 0 || static_cast<int64_t>(bsz) * h * wd > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t npix = static_cast<int64_t>(bsz) * (h / 2) * (wd / 2);
  if (npix == 0) return 0;
  const int bf = is_bf16 ? 1 : 0;
  if (y == nullptr && cout > kChunkN)  // the row store, in the workspace
    y = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                 row_store_offset(cin, cout, bf));
  const bool ytile = cout <= kChunkN;
  const Kernel k = kernel_for(bf, cin, cout);
  const int smem = smem_bytes(bf, ytile);
  cudaError_t err = opt_in_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t entries = workspace_bytes(cin, cout, bf) / 8;  // >= threads
  const int prep_grid = static_cast<int>(
      entries / 256 + 1 < 4096 ? entries / 256 + 1 : 4096);
  conv_gdn_prep_kernel<<<prep_grid, 256, 0, stream>>>(
      w, gamma, static_cast<unsigned char*>(work), cin, cout, bf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int size = bf ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  int vec_x = (cin * size) % 16 == 0 && xa % 16 == 0;
  int vec_y = cout % 4 == 0 && ya % 16 == 0;
  int vec_out = (cout * size) % 16 == 0 && oa % 16 == 0;
  const unsigned grid = static_cast<unsigned>((npix + kTileM - 1) / kTileM);
  const unsigned char* work_c = static_cast<const unsigned char*>(work);
  void* args[] = {&x,   &work_c, &beta, &out,  &y,     &h,     &wd,
                  &npix, &cin,   &cout, &vec_x, &vec_y, &vec_out};
  return static_cast<int>(
      cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, smem, stream));
}

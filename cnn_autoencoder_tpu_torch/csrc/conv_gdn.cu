// K4: fused reflect-pad + 3x3 stride-2 convolution + GDN on the H100's
// tensor cores (sm_90a), its serving variant and its training (want_y)
// variant, for float32 and bf16 x, in six modes (below).
//
// Replaces: cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel (its
// pallas_call in _fused_conv_gdn_pallas, entry fused_conv_gdn).  Computes,
// for NHWC x (B, H, W, Cin), HWIO weights (3, 3, Cin, Cout) and even H, W:
//   y[b, r, c, o]   = sum_{dy, dx, i} w[dy, dx, i, o] * x[b, R(2r+dy-1), R(2c+dx-1), i]
//   out[b, r, c, o] = y * (beta[o] + sum_i gamma[o, i] * y[b, r, c, i]^2)^(-1/2)
// with R the reflect index (-1 -> 1).  The training variant also writes
// the pre-GDN y, the backward's residual.  The modes (cae_conv_gdn_fwd's
// `mode`), each a function of the JAX package:
//   0 float32 x, float32-accurate products (HIGHEST), float32 y, the pool
//     float32-accurate: the highest precision, either route;
//   1 bf16 x, bf16 multiplicands (w rounded to bf16) and float32 sums, the
//     float32 y and pool of mode 0, out rounded once: the Pallas kernel
//     (CAE_TPU_PALLAS=1) in the bf16 mode;
//   2 bf16 x, the JAX default route in the bf16 mode (Conv2dReflect, then
//     GDN): mode 1's conv sums rounded to bf16 (the conv's bf16 output),
//     then the pool on bf16(y^2) and bf16(gamma) in one pass with float32
//     sums (norm_pool_precision), out = bf16(y r); y and r = norm^(-1/2)
//     as bf16 for the backward: one rounding of y, the reflect+VALID form
//     (CAE_TPU_BORDER_CONV=0, CAE_TPU_NATIVE_CONV_OUT=0);
//   3 mode 2 with the border form's roundings (conv_s2_reflect_border, the
//     default): y = bf16(I), then bf16(y + bf16(dr)) on output row 0 and
//     bf16(y + bf16(dc)) on output column 0, where I sums the taps that
//     read no reflected row or column, dr the three taps of row 0 that read
//     the reflected row -1 (the corner's column -1 reflected too) and dc
//     the taps of column 0 that read the reflected column -1 (row -1 zero);
//     a prep kernel computes dr and dc into the workspace;
//   4 float32 x rounded to bf16, bf16 w, float32 sums, mode 0's float32 y
//     and pool: the default precision on float32 activations, and the bf16
//     mode with CAE_TPU_BF16_ACTIVATIONS=0 (conv_mixed's rule);
//   5 float32 x and w each split into bf16 hi + lo, the products
//     hi hi + hi lo + lo hi with float32 sums (bf16_3x, the TPU's HIGH),
//     mode 0's y and pool: the high precision.
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
// products, and mode 5's bf16_3x is the same three passes over bf16 hi/lo
// parts (bf16_split).  The tensor core's float32 accumulation rounds less closely
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
// tile (modes 2 and 3 round it there, mode 3 adding its corrections),
// the pool (y^2 from the tile, gamma^T slices through the same ring) runs
// on the tensor cores in three passes (one bf16 pass in modes 2 and 3),
// and out = y * rsqrt(norm) is written over the tile and stored with 16-byte streaming
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
// tile, a 4.5 KB tap table, 1 KB of border offsets (mode 3) and the
// stages' mbarriers, 226848 bytes: one block of 8 warps on each SM.
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

// the weights' fragments in the prep buffer, by how a product multiplies:
// three TF32 passes (hi/lo TF32 parts), one bf16 pass (hi alone, bf16), or
// three bf16 passes (hi/lo bf16 parts)
enum Split : int { kTf32x3 = 0, kBf16x1 = 1, kBf16x3 = 2 };

__host__ __device__ constexpr int slice_bytes(int split) {
  return split == kBf16x1 ? kSingleBytes : kTripleBytes;
}

// the conv's and the pool's splits, and x's type, of each mode
__host__ __device__ constexpr int conv_split(int mode) {
  return mode == 0 ? kTf32x3 : (mode == 5 ? kBf16x3 : kBf16x1);
}
__host__ __device__ constexpr int pool_split(int mode) {
  return (mode == 2 || mode == 3) ? kBf16x1 : kTf32x3;
}
__host__ __device__ constexpr bool mode_bf16_x(int mode) {
  return mode >= 1 && mode <= 3;
}

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
// slices (of the mode's conv split), then, after every chunk's conv
// slices, ceil(Cout / 32) pool slices per chunk (of its pool split).
__host__ __device__ int64_t conv_region_bytes(int cin, int cout, int mode) {
  return static_cast<int64_t>((cout + kChunkN - 1) / kChunkN) * 9 *
         ((cin + kSliceK - 1) / kSliceK) * slice_bytes(conv_split(mode));
}

__host__ __device__ int64_t workspace_bytes(int cin, int cout, int mode) {
  return conv_region_bytes(cin, cout, mode) +
         static_cast<int64_t>((cout + kChunkN - 1) / kChunkN) *
             ((cout + kSliceK - 1) / kSliceK) * slice_bytes(pool_split(mode));
}

// One thread per fragment entry: w (and gamma^T) into the prep buffer.
// Conv slice s of chunk nc is tap s / ceil(Cin / 32), input channels
// 32 (s % ceil(Cin / 32)) + [0, 32); B[k][n] = w[tap][k][n].  Pool slice g
// holds B[k][n] = gamma[n][k], k in 32 g + [0, 32).  Each is split as the
// mode's conv and pool multiply (Split): kBf16x1 rounds to bf16 and keeps
// hi alone.
__device__ __forceinline__ void put_entry(unsigned char* base, int64_t f,
                                          int split, float v0, float v4) {
  if (split == kBf16x1) {
    reinterpret_cast<float2*>(base)[f] =
        make_float2(bf16_rne(v0), bf16_rne(v4));
    return;
  }
  uint32_t h0, l0, h4, l4;
  if (split == kBf16x3) {
    bf16_split(v0, h0, l0);
    bf16_split(v4, h4, l4);
  } else {
    tf32_split(v0, h0, l0);
    tf32_split(v4, h4, l4);
  }
  reinterpret_cast<float4*>(base)[f] =
      make_float4(__uint_as_float(h0), __uint_as_float(h4),
                  __uint_as_float(l0), __uint_as_float(l4));
}

__global__ void conv_gdn_prep_kernel(const float* __restrict__ w,
                                     const float* __restrict__ gamma,
                                     unsigned char* __restrict__ work,
                                     int cin, int cout, int mode) {
  const int skt = (cin + kSliceK - 1) / kSliceK;
  const int sg = (cout + kSliceK - 1) / kSliceK;
  const int nch = (cout + kChunkN - 1) / kChunkN;
  const int64_t conv_n = static_cast<int64_t>(nch) * 9 * skt * kEntries;
  const int64_t total = conv_n + static_cast<int64_t>(nch) * sg * kEntries;
  const int64_t conv_bytes = conv_region_bytes(cin, cout, mode);
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
    if (pool)
      put_entry(work + conv_bytes, f, pool_split(mode), v0, v4);
    else
      put_entry(work, f, conv_split(mode), v0, v4);
  }
}

// Mode 3's border corrections, one thread an output: corr[(b w2 + j) Cout
// + o] = bf16(dr) of output (b, 0, j) and, after those, corr[B w2 Cout +
// (b h2 + i) Cout + o] = bf16(dc) of output (b, i, 0), each a float32 sum
// of bf16 x times bf16(w) (conv_s2_reflect_border's two thin convs, their
// outputs stored as bf16).
__global__ void conv_gdn_border_kernel(const bf16* __restrict__ x,
                                       const float* __restrict__ w,
                                       float* __restrict__ corr, int bsz,
                                       int h, int wd, int cin, int cout) {
  const int h2 = h / 2, w2 = wd / 2;
  const int64_t nr = static_cast<int64_t>(bsz) * w2 * cout;
  const int64_t total = nr + static_cast<int64_t>(bsz) * h2 * cout;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool row = e < nr;
    const int64_t f = row ? e : e - nr;
    const int o = static_cast<int>(f % cout);
    const int64_t q = f / cout;  // b w2 + j (row) or b h2 + i (column)
    const int span = row ? w2 : h2;
    const int b = static_cast<int>(q / span), at = static_cast<int>(q % span);
    float sum = 0.f;
    for (int t = 0; t < 3; ++t) {
      // dr: tap (0, t) reads x[b, 1, R(2 j - 1 + t)]; dc: tap (t, 0) reads
      // x[b, 2 i - 1 + t, 1], zero above the top row
      int iy = 1, ix = 2 * at - 1 + t;
      if (!row) {
        iy = 2 * at - 1 + t;
        ix = 1;
        if (iy < 0) continue;
      }
      ix = ix < 0 ? -ix : ix;
      const bf16* xp = x + ((static_cast<int64_t>(b) * h + iy) * wd + ix) * cin;
      const float* wp =
          w + static_cast<int64_t>(row ? t : 3 * t) * cin * cout + o;
      for (int c = 0; c < cin; ++c)
        sum = fmaf(__bfloat162float(xp[c]),
                   bf16_rne(wp[static_cast<int64_t>(c) * cout]), sum);
    }
    corr[e] = bf16_rne(sum);
  }
}

// One K-slice of 32 on the tensor cores: acc += A[:, 0:32] B (A's rows
// from `a` with row pitch `pitch`, squared first where kSquare; B the
// slice's fragments at `b`: hi alone where kBTriple is false, else hi and
// lo), each k-step of 8 in kPasses TF32 passes into its own fragments,
// added to acc in float32 after them.  A is split or rounded as B was: in
// bf16 parts where kBfA, else in TF32 parts (bf16 A is exact either way).
// One pass on float32 A with TF32 B (probe builds) multiplies the rounded
// hi parts alone.
// Channels past Cout multiply zero weights: no product is guarded.
template <int kPasses, bool kSquare, bool kBfA, bool kBTriple, typename AT>
__device__ __forceinline__ void slice_mma(float (&acc)[kMI][kNJ][4],
                                          const AT* __restrict__ a,
                                          int pitch,
                                          const unsigned char* __restrict__ b,
                                          int wm, int wn, int lane) {
  constexpr bool kBf16A = std::is_same<AT, bf16>::value;
  static_assert(kBTriple || kPasses == 1, "one-part slices hold hi alone");
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
      } else if constexpr (kBTriple) {
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
          if constexpr (kBfA)
            bf16_split(t, ah[mi][q], al[mi][q]);
          else
            tf32_split(t, ah[mi][q], al[mi][q]);
        } else {  // bf16 values are exact in TF32; float32 ones round
          ah[mi][q] = (kBf16A && !kSquare) ? __float_as_uint(t)
                      : kBfA             ? __float_as_uint(bf16_rne(t))
                                         : tf32_rna(t);
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

// T is x's and out's type, kMode the mode (its conv split and epilogue;
// T is bf16 in modes 1-3).  kCi, kCo: Cin and Cout known when compiled (0:
// taken at run time).  kYTile: Cout <= 128, y held in shared memory; else
// y (never null then: the caller's, or a part of the workspace) is the row
// store between the conv and the pool.  Modes 0, 1, 4, 5 write y (float32)
// when it is not null; modes 2 and 3 (kRound) write y, rounded, and r as
// bf16 to yb and rb when they are not null, the row store being the
// workspace's.  corr: mode 3's border corrections.  vec_x: x rows and
// pointer 16-byte aligned; vec_y, vec_out, vec_yb: the same for y's,
// out's and yb's rows.
template <typename T, int kCi, int kCo, bool kYTile, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv_gdn_mma_kernel(const T* __restrict__ x,
                   const unsigned char* __restrict__ work,
                   const float* __restrict__ beta,
                   const float* __restrict__ corr, T* __restrict__ out,
                   float* __restrict__ y, bf16* __restrict__ yb,
                   bf16* __restrict__ rb, int h, int wd, int64_t npix,
                   int cin_run, int cout_run, int vec_x, int vec_y,
                   int vec_out, int vec_yb) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static_assert(kBf16 == mode_bf16_x(kMode), "x's type follows the mode");
  constexpr int kSplit = conv_split(kMode);
  constexpr bool kRound = pool_split(kMode) == kBf16x1;  // modes 2, 3
  constexpr bool kBorder = kMode == 3;
  constexpr int kConvPasses =
      kSplit == kBf16x1 ? 1 : (kSplit == kBf16x3 ? 3 : kF32Passes);
  constexpr int kConvSliceBytes = slice_bytes(kSplit);
  constexpr int kPoolSliceBytes = slice_bytes(pool_split(kMode));
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
  const unsigned char* pool_b = work + conv_region_bytes(cin, cout, kMode);

  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  // three stages, then the y tile (or, in the row-store layout, a fourth
  // stage), then the tap table, each pixel's border corrections (mode 3)
  float* ytile = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  int* taps = reinterpret_cast<int*>(
      ring + kStages * kStageBytes +
      (kYTile ? kTileM * kPitchY * 4 : kStageBytes));
  static_assert(kTileM * kPitchY * 4 >= kStageBytes, "a stage in the y tile");
  int* corr_at = taps + 9 * kTileM;  // dr's, then dc's offset in corr, or -1
  uint64_t* bars = reinterpret_cast<uint64_t*>(corr_at + 2 * kTileM);
  uint32_t phase = 0;
  constexpr int kPoolDepth = kYTile ? kStages : kConvDepth;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int gq = lane >> 2, tq = lane & 3;

  // each pixel's nine source pixels (b, R(2r + dy - 1), R(2c + dx - 1)) as
  // flat indices (B H W < 2^31, checked by the launcher); -1 past npix and,
  // in mode 3, where the tap reads the reflected row or column -1 (the
  // border form's zero padding, its corrections added after)
  for (int e = tid; e < 9 * kTileM; e += kThreads) {
    const int tap = e / kTileM, p = e - tap * kTileM;
    int v = -1;
    if (p < rows) {
      const int pix = static_cast<int>(p0) + p;  // npix < 2^31
      const int b = pix / (h2 * w2);
      const int rem = pix - b * h2 * w2;
      const int oy = rem / w2, ox = rem - (rem / w2) * w2;
      const int sy = 2 * oy + tap / 3 - 1, sx = 2 * ox + tap % 3 - 1;
      if (!kBorder || (sy >= 0 && sx >= 0))
        v = (b * h + reflect(sy, h)) * wd + reflect(sx, wd);
    }
    taps[e] = v;
  }
  if constexpr (kBorder) {
    for (int p = tid; p < kTileM; p += kThreads) {
      int dr = -1, dc = -1;
      if (p < rows) {
        const int pix = static_cast<int>(p0) + p;
        const int b = pix / (h2 * w2);
        const int rem = pix - b * h2 * w2;
        const int oy = rem / w2, ox = rem - (rem / w2) * w2;
        const int nr = (npix / (h2 * w2)) * w2;  // dr rows before dc's
        if (oy == 0) dr = (b * w2 + ox) * cout;
        if (ox == 0) dc = (nr + b * h2 + oy) * cout;
      }
      corr_at[p] = dr;
      corr_at[kTileM + p] = dc;
    }
  }
  if (tid == 0) {
    for (int i = 0; i < kConvDepth; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // mode 2 and 3's y from the conv's sums: rounded to bf16, and in mode 3
  // each border correction added with a rounding (row's first, as there)
  auto y_of = [&](float acc_v, int r, int og) -> float {
    if constexpr (!kRound) {
      return acc_v;
    } else {
      float v = bf16_rne(acc_v);
      if constexpr (kBorder) {
        if (og < cout) {
          const int dr = corr_at[r], dc = corr_at[kTileM + r];
          if (dr >= 0) v = bf16_rne(v + __ldg(corr + dr + og));
          if (dc >= 0) v = bf16_rne(v + __ldg(corr + dc + og));
        }
      }
      return v;
    }
  };

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
      slice_mma<kConvPasses, false, kSplit != kTf32x3, kSplit != kBf16x1>(
          acc, reinterpret_cast<const T*>(stage), kPitchX, stage + kABytes,
          wm, wn, lane);
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
          const int og = nc * kChunkN + o;
          const float y0 = y_of(acc[mi][jj][2 * hh], r, og);
          const float y1 = y_of(acc[mi][jj][2 * hh + 1], r, og + 1);
          if constexpr (kYTile) {
            *reinterpret_cast<float2*>(ytile + r * kPitchY + o) =
                make_float2(y0, y1);
          } else {
            if (r >= rows || og >= cout) continue;
            float* yp = y + (p0 + r) * cout + og;
            yp[0] = y0;
            if (og + 1 < cout) yp[1] = y1;
          }
        }
  }
  __syncthreads();  // y complete (tile or row store)
  if constexpr (kYTile && !kRound) {  // the training variant's residual
    if (y != nullptr) {
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
  }
  if constexpr (kRound) {  // y as bf16 (exact: its values are bf16)
    if (yb != nullptr) {
      if (vec_yb) {
        const int per = cout / 8;
        for (int e = tid; e < rows * per; e += kThreads) {
          const int r = e / per, q = 8 * (e - r * per);
          const float* src = kYTile ? ytile + r * kPitchY + q
                                    : y + (p0 + r) * cout + q;
          uint32_t u[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
            u[i] = *reinterpret_cast<const uint32_t*>(&v);
          }
          __stcs(reinterpret_cast<uint4*>(yb + (p0 + r) * cout + q),
                 make_uint4(u[0], u[1], u[2], u[3]));
        }
      } else {
        for (int e = tid; e < rows * cout; e += kThreads) {
          const int r = e / cout, k = e - r * cout;
          yb[(p0 + r) * cout + k] = __float2bfloat16(
              kYTile ? ytile[r * kPitchY + k] : y[(p0 + r) * cout + k]);
        }
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
                  pool_b + (static_cast<int64_t>(nc) * sg + g) *
                               kPoolSliceBytes,
                  kPoolSliceBytes, bars + st);
    };
    auto compute = [&](int g, int st) {
      const unsigned char* stage = ring + st * kStageBytes;
      // modes 2, 3: bf16(y^2) and bf16(gamma), one pass; else three TF32
      constexpr int kPoolPasses = kRound ? 1 : 3;
      if constexpr (kYTile)
        slice_mma<kPoolPasses, true, kRound, !kRound>(
            acc, ytile + kSliceK * g, kPitchY, stage + kABytes, wm, wn, lane);
      else
        slice_mma<kPoolPasses, true, kRound, !kRound>(
            acc, reinterpret_cast<const float*>(stage), kPitchF,
            stage + kABytes, wm, wn, lane);
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
          const int og = nc * kChunkN + o;
          if constexpr (kRound) {  // r for the backward
            if (rb != nullptr && r < rows && og < cout) {
              bf16* rp = rb + (p0 + r) * cout + og;
              rp[0] = __float2bfloat16(f0);
              if (og + 1 < cout) rp[1] = __float2bfloat16(f1);
            }
          }
          if constexpr (kYTile) {  // out over y: this thread alone reads
                                   // and writes these places
            float2* yp = reinterpret_cast<float2*>(ytile + r * kPitchY + o);
            const float2 v = *yp;
            *yp = make_float2(v.x * f0, v.y * f1);
          } else {
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

template <typename T, int kCi, int kCo, bool kYTile, int kMode>
Kernel kernel_ptr() {
  return reinterpret_cast<Kernel>(
      conv_gdn_mma_kernel<T, kCi, kCo, kYTile, kMode>);
}

int smem_bytes(bool bf, bool ytile) {
  const int a = (bf && ytile) ? kTileM * kPitchH * 2 : kTileM * kPitchF * 4;
  return kStages * (a + kTripleBytes) +
         (ytile ? kTileM * kPitchY * 4 : a + kTripleBytes) +
         11 * kTileM * 4 + kConvDepth * 8;
}

// the flagship's Cin = Cout = 128 has its own instantiation in the modes
// of the main path (0 float32, 3 bf16) and the Pallas one (1)
template <int kMode>
Kernel kernel_of(int cin, int cout) {
  using T = typename std::conditional<mode_bf16_x(kMode), bf16, float>::type;
  if (cout > kChunkN) return kernel_ptr<T, 0, 0, false, kMode>();
  if constexpr (kMode == 0 || kMode == 1 || kMode == 3) {
    if (cin == 128 && cout == 128)
      return kernel_ptr<T, 128, 128, true, kMode>();
  }
  return kernel_ptr<T, 0, 0, true, kMode>();
}

Kernel kernel_for(int mode, int cin, int cout) {
  switch (mode) {
    case 0: return kernel_of<0>(cin, cout);
    case 1: return kernel_of<1>(cin, cout);
    case 2: return kernel_of<2>(cin, cout);
    case 3: return kernel_of<3>(cin, cout);
    case 4: return kernel_of<4>(cin, cout);
    default: return kernel_of<5>(cin, cout);
  }
}

// The workspace: the split weights, then mode 3's border corrections, then
// the y row store where Cout > 128 and the caller's y cannot hold it
// (modes 2 and 3 always: their y output is bf16), each 256-byte aligned.
int64_t corr_offset(int cin, int cout, int mode) {
  return (workspace_bytes(cin, cout, mode) + 255) / 256 * 256;
}

int64_t row_store_offset(int bsz, int h, int wd, int cin, int cout,
                         int mode) {
  const int64_t corr = mode == 3 ? static_cast<int64_t>(bsz) *
                                       (wd / 2 + h / 2) * cout * 4
                                 : 0;
  return (corr_offset(cin, cout, mode) + corr + 255) / 256 * 256;
}

bool needs_row_store(int cout, int mode, bool want_y) {
  return cout > kChunkN && (!want_y || pool_split(mode) == kBf16x1);
}

}  // namespace

// Bytes of the scratch buffer cae_conv_gdn_fwd takes as `work` for a
// (bsz, h, wd, cin) x in `mode`: the split weights, mode 3's border
// corrections, and where Cout > 128 and y is not held by the caller's y,
// the y row store.
extern "C" int64_t cae_conv_gdn_workspace(int bsz, int h, int wd, int cin,
                                          int cout, int mode, int want_y) {
  const int64_t npix = static_cast<int64_t>(bsz) * (h / 2) * (wd / 2);
  const int64_t rs = row_store_offset(bsz, h, wd, cin, cout, mode);
  if (needs_row_store(cout, mode, want_y)) return rs + npix * cout * 4;
  return rs;
}

// x and out are float32 (modes 0, 4, 5) or bf16 (modes 1-3); w is HWIO
// (3, 3, Cin, Cout), gamma (Cout, Cout) with gamma[o, i] at o * Cout + i,
// beta (Cout,).  y, the pre-GDN conv output, is written where it is not
// null: float32 in modes 0, 1, 4, 5; bf16 in modes 2 and 3, which then
// also write r (bf16) to `r`.  work: cae_conv_gdn_workspace bytes (want_y
// = y != null).
extern "C" int cae_conv_gdn_fwd(const void* x, const float* w,
                                const float* gamma, const float* beta,
                                void* out, void* y, void* r, void* work,
                                int bsz, int h, int wd, int cin, int cout,
                                int mode, cudaStream_t stream) {
  if ((h % 2) || (wd % 2) || h < 2 || wd < 2 || cin < 1 || cout < 1 ||
      bsz < 0 || static_cast<int64_t>(bsz) * h * wd > INT32_MAX ||
      mode < 0 || mode > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool round = pool_split(mode) == kBf16x1;
  if (round && ((y == nullptr) != (r == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t npix = static_cast<int64_t>(bsz) * (h / 2) * (wd / 2);
  if (npix == 0) return 0;
  unsigned char* ws = static_cast<unsigned char*>(work);
  float* yf = round ? nullptr : static_cast<float*>(y);
  bf16* yb = round ? static_cast<bf16*>(y) : nullptr;
  bf16* rb = static_cast<bf16*>(r);
  if (needs_row_store(cout, mode, y != nullptr))  // in the workspace
    yf = reinterpret_cast<float*>(
        ws + row_store_offset(bsz, h, wd, cin, cout, mode));
  const float* corr =
      mode == 3 ? reinterpret_cast<const float*>(
                      ws + corr_offset(cin, cout, mode))
                : nullptr;
  const bool ytile = cout <= kChunkN;
  const bool bf = mode_bf16_x(mode);
  const Kernel k = kernel_for(mode, cin, cout);
  const int smem = smem_bytes(bf, ytile);
  cudaError_t err = opt_in_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t entries = workspace_bytes(cin, cout, mode) / 8;  // >= threads
  const int prep_grid = static_cast<int>(
      entries / 256 + 1 < 4096 ? entries / 256 + 1 : 4096);
  conv_gdn_prep_kernel<<<prep_grid, 256, 0, stream>>>(w, gamma, ws, cin,
                                                      cout, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == 3) {
    const int64_t n = static_cast<int64_t>(bsz) * (wd / 2 + h / 2) * cout;
    const int grid = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
    conv_gdn_border_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(x), w, const_cast<float*>(corr), bsz, h, wd,
        cin, cout);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int size = bf ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(yf);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const uintptr_t yba = reinterpret_cast<uintptr_t>(yb);
  int vec_x = (cin * size) % 16 == 0 && xa % 16 == 0;
  int vec_y = cout % 4 == 0 && ya % 16 == 0;
  int vec_out = (cout * size) % 16 == 0 && oa % 16 == 0;
  int vec_yb = cout % 8 == 0 && yba % 16 == 0;
  const unsigned grid = static_cast<unsigned>((npix + kTileM - 1) / kTileM);
  const unsigned char* work_c = ws;
  void* args[] = {&x,      &work_c, &beta,  &corr,  &out,   &yf,
                  &yb,     &rb,     &h,     &wd,    &npix,  &cin,
                  &cout,   &vec_x,  &vec_y, &vec_out, &vec_yb};
  return static_cast<int>(
      cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, smem, stream));
}

// The bf16 tensor-core building blocks of the bf16 GDN training kernels
// (csrc/gdn_fwd_bf16_tc.cu, K2; csrc/gdn_bf16_tc.cu, K3): ldmatrix from
// shared memory and the m16n8k16 bf16 mma.sync with float32 accumulators,
// and what the two kernels share around them: the tile geometry, the
// once-per-call bf16 copy of gamma, bf16 packing and the group barrier.  A
// product of two bf16 values is exact in float32, so one pass computes a
// bf16-multiplicand product; the tensor core's float32 sums truncate.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "smem_copy.cuh"

namespace {

// A group of 8 warps (2 along rows x 4 along C, each warp 16 rows x 32
// channels) computes one tile of kRows rows x up to kChunk channels at a
// time.  A resident kernel's block holds several groups that take tiles in
// turn (each kernel sets how many); a streamed kernel's block is one group
// and takes kSliceK-deep slices of the reduction.
constexpr int kGroupThreads = 256;
constexpr int kWarpRows = 2;
constexpr int kWarpCols = 32;  // output channels of a warp (4 tiles of 8)
constexpr int kRows = 32;      // rows of a tile
constexpr int kChunk = 128;    // output channels of one product
constexpr int kSliceK = 64;    // reduction channels of a streamed slice

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// rows of tile t of n rows
__device__ __forceinline__ int tile_rows(int64_t n, int64_t t) {
  const int64_t left = n - t * kRows;
  return left < kRows ? static_cast<int>(left) : kRows;
}

// Four 8x8 matrices of 16-bit values from shared memory: lanes 8i .. 8i+7
// give the addresses of the 16-byte rows of matrix i, and register i of
// every lane receives its part of matrix i (row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b, m16n8k16, row-major A, column-major B, bf16 multiplicands,
// float32 accumulators.  Fragments (g = lane / 4, t = lane % 4): a0 row g,
// columns 2t, 2t+1; a1 row g + 8; a2, a3 the same at columns + 8; b0 rows
// 2t, 2t+1 of column g, b1 rows + 8; d0, d1 row g, columns 2t, 2t+1; d2, d3
// row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x 8 kTiles block of a product over kSteps k-steps of 16:
// rows row0 .. row0 + 15 of A (row-major, pitch lda elements) times the
// columns col0 .. col0 + 8 kTiles - 1 of B, given as B^T (row n holds
// column n of B, pitch ldb), added into acc[j] for column tile j.  Both
// pitches are multiples of 8 elements; kTiles is even.  The fragments of
// k-step ks + 1 are loaded before the products of k-step ks.
template <int kTiles, int kSteps>
__device__ __forceinline__ void warp_mma_bf16(const __nv_bfloat16* a_s,
                                              int lda,
                                              const __nv_bfloat16* bt_s,
                                              int ldb, int row0, int col0,
                                              float (&acc)[kTiles][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_row =
      a_s + (row0 + (lane & 15)) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* b_row = bt_s +
      (col0 + (lane & 7) + (lane >> 4) * 8) * ldb + ((lane >> 3) & 1) * 8;
  uint32_t a[2][4], b[2][kTiles / 2][4];
  auto load = [&](int buf, int ks) {
    ldmatrix_x4(a[buf], a_row + 16 * ks);
#pragma unroll
    for (int j = 0; j < kTiles / 2; ++j)
      ldmatrix_x4(b[buf][j], b_row + 16 * j * ldb + 16 * ks);
  };
  load(0, 0);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (ks + 1 < kSteps) load((ks + 1) & 1, ks + 1);
#pragma unroll
    for (int j = 0; j < kTiles / 2; ++j) {
      mma_bf16(acc[2 * j], a[ks & 1], b[ks & 1][j][0], b[ks & 1][j][1]);
      mma_bf16(acc[2 * j + 1], a[ks & 1], b[ks & 1][j][2], b[ks & 1][j][3]);
    }
  }
}

// out[a * kp + b] = bf16(gamma[a * c + b]) for a, b < c (transpose:
// bf16(gamma[b * c + a])), zero elsewhere: np rows of kp, np and kp whole
// chunks and slices.  Row a is column a of the product's B operand: gamma
// as stored for K2's pool (sum_i x^2[i] gamma[o, i]), transposed for K3's
// (sum_o dnb[o] gamma[o, i]).
__global__ void gamma_bf16_prep_kernel(const float* __restrict__ gamma,
                                       __nv_bfloat16* __restrict__ out, int c,
                                       int kp, int np, int transpose) {
  const int64_t total = static_cast<int64_t>(np) * kp;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int a = static_cast<int>(e / kp), b = static_cast<int>(e % kp);
    const int64_t src = transpose ? static_cast<int64_t>(b) * c + a
                                  : static_cast<int64_t>(a) * c + b;
    out[e] = __float2bfloat16(a < c && b < c ? gamma[src] : 0.f);
  }
}

// K of gamma's bf16 copy for a product over C channels: one whole chunk
// when C fits one (the resident layouts), whole slices else
inline int gamma_bf16_kp(int c) {
  return c <= kChunk ? kChunk : round_up(c, kSliceK);
}

// bytes of gamma's bf16 copy: whole chunks of rows of gamma_bf16_kp(c)
inline int64_t gamma_bf16_bytes(int c) {
  return static_cast<int64_t>(round_up(c, kChunk)) * gamma_bf16_kp(c) * 2;
}

inline cudaError_t launch_gamma_bf16_prep(const float* gamma,
                                          __nv_bfloat16* out, int c,
                                          int transpose, cudaStream_t stream) {
  const int np = round_up(c, kChunk), kp = gamma_bf16_kp(c);
  const int64_t blocks = (static_cast<int64_t>(np) * kp + 255) / 256;
  gamma_bf16_prep_kernel<<<
      static_cast<unsigned>(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      gamma, out, c, kp, np, transpose);
  return cudaGetLastError();
}

// 8 consecutive bf16 values from shared memory (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 floats as 8 bf16 values (rounded to nearest even) in 16 bytes
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the barrier of a group's 256 threads (named barrier 1 + group)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads)
               : "memory");
}

}  // namespace

// The bf16 tensor-core building blocks of the bf16 GDN training kernels
// (csrc/gdn_bf16_tc.cu, K3): ldmatrix from shared memory and the m16n8k16
// bf16 mma.sync with float32 accumulators.  A product of two bf16 values is
// exact in float32, so one pass computes a bf16-multiplicand product; the
// tensor core's float32 sums truncate.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "smem_copy.cuh"

namespace {

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

}  // namespace

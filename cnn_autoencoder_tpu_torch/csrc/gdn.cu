// GDN / IGDN over float32 (N, C) rows, for the H100 (sm_90a): K2's float32
// rows, on the CUDA cores.  K2's bf16 rows, the bf16 training mode's
// forward, run on the tensor cores in gdn_fwd_bf16_tc.cu; the serving
// forward K1 in gdn_tc.cu, the bf16 mode's backward K3 in gdn_bf16_tc.cu.
// No path of the port reaches this kernel today: float32 GDN runs K1
// (ops/gdn.py); it stays so that K2's function takes float32 rows as the
// TPU kernel does.
//
// K2 replaces cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:
// _gdn_train_fwd_kernel (pallas_call in _gdn_train_fwd_pallas):
//   y[n, o] = x[n, o] * (beta[o] + sum_i gamma[o, i] * x[n, i]^2)^(-1/2)
// (IGDN: ^(+1/2)) in float32, and the backward residual r = norm^(-1/2)
// (IGDN: norm^(+1/2)) as bf16.  The norm pool follows
// ops/gdn.py:norm_pool_precision: float32 rows in full float32.
//
// What bounds it here: the pool is 2 * C FLOP per element against 10
// bytes read and written, so at C = 128 float32 FMAs on the CUDA cores
// (67 TFLOP/s) bound it, not memory (3.35 TB/s).  A float32-accurate
// tensor-core design (3xTF32, as K1's) is not built for these rows.
//
// Design: the pool is a small matrix product (rows x C) @ (C x C).  A
// block of 256 threads owns a 64-row x 64-channel output tile; each thread
// holds a 4 x 4 register tile, so every pair of values loaded from shared
// memory feeds 4 FMAs.  The row operand x^2 and gamma are staged through
// shared memory in 32-channel slices (both slice-major with one pad column,
// so the staging stores hit 32 banks); gamma is read as stored from device
// memory, where L2 keeps it.  The epilogue reads the row's inputs once more
// and writes each output once.  C is taken as it comes (no padding to
// 128): partial tiles are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;     // rows per block
constexpr int kCols = 64;     // output channels per block
constexpr int kSlice = 32;    // reduction channels per shared-memory slice
constexpr int kThreads = 256;

// acc[i][j] += sum_kk a[kk][4 ty + i] * b[kk][tx + 16 j]
__device__ __forceinline__ void tile_fma(const float (*a)[kRows + 1],
                                         const float (*b)[kCols + 1], int tx,
                                         int ty, float (&acc)[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < kSlice; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[kk][4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// gamma[o * c + i] as stored
__global__ void __launch_bounds__(kThreads)
gdn_train_fwd_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, float* __restrict__ y,
                         __nv_bfloat16* __restrict__ rb, int64_t n, int c,
                         int inverse) {
  __shared__ float s_x2[kSlice][kRows + 1];
  __shared__ float s_g[kSlice][kCols + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx + 16 * j
  const int ty = tid / 16;  // rows 4 * ty + i
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int col0 = blockIdx.y * kCols;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kSlice) {
    for (int e = tid; e < kRows * kSlice; e += kThreads) {
      const int kk = e % kSlice, r = e / kSlice;
      const int64_t row = row0 + r;
      const int ch = k0 + kk;
      const float v = (row < n && ch < c) ? x[row * c + ch] : 0.f;
      s_x2[kk][r] = v * v;
    }
    // consecutive threads read consecutive channels of one row of gamma
    for (int e = tid; e < kSlice * kCols; e += kThreads) {
      const int kk = e % kSlice, cc = e / kSlice;
      const int ch = k0 + kk, o = col0 + cc;
      s_g[kk][cc] = (ch < c && o < c)
                        ? gamma[static_cast<int64_t>(o) * c + ch] : 0.f;
    }
    __syncthreads();
    tile_fma(s_x2, s_g, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + 4 * ty + i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = col0 + tx + 16 * j;
      if (o >= c) continue;
      // correctly rounded sqrt and division (no fast-math): within an ulp
      // or two of torch's rsqrt/sqrt
      const float s = sqrtf(acc[i][j] + beta[o]);
      const float r = inverse ? s : 1.0f / s;
      const int64_t idx = row * c + o;
      y[idx] = x[idx] * r;
      rb[idx] = __float2bfloat16(r);
    }
  }
}

}  // namespace

// x and y are float32 (N, C) rows, rb bf16; gamma is float32 (C, C), beta
// (C,).
extern "C" int cae_gdn_train_fwd_f32(const float* x, const float* gamma,
                                     const float* beta, float* y, void* rb,
                                     int64_t n, int c, int inverse,
                                     cudaStream_t stream) {
  if (n == 0 || c == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((c + kCols - 1) / kCols));
  gdn_train_fwd_f32_kernel<<<grid, kThreads, 0, stream>>>(
      x, gamma, beta, y, static_cast<__nv_bfloat16*>(rb), n, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

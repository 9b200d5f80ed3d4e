// GDN / IGDN over (N, C) float32 rows, for the H100 (sm_90a).
//
// Replaces: cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:_gdn_kernel (its
// pallas_call in _gdn_pallas, entry fused_gdn).  Computes
//   y[n, o] = x[n, o] * (beta[o] + sum_i gamma[o, i] * x[n, i]^2)^(-1/2)
// (IGDN: ^(+1/2)) in float32, one rounding of the output.
//
// What bounds it here: at C = 128 the norm pool is 2*C = 256 FLOP per
// element against 8 bytes read and written, above the H100's float32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so the CUDA cores'
// float32 FMA rate bounds it, not memory.  No tensor cores: the f32 path is
// exact float32 (the JAX package's HIGHEST), which TF32 would break.
//
// Design: the pool is a small matrix product (rows x C) @ gamma^T.  A block
// of 256 threads owns a 64-row x 64-channel output tile; each thread holds a
// 4 x 4 register tile, so every pair of values loaded from shared memory
// feeds 4 FMAs.  x^2 and gamma^T are staged through shared memory in
// 32-channel slices (x^2 slice-major with one pad column, so the staging
// stores hit 32 banks); gamma^T is read from device memory, where L2 keeps
// its 64 KB.  The epilogue reads x once more and writes y once.  C is taken
// as it comes (no padding to 128): partial tiles are masked.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;     // rows per block
constexpr int kCols = 64;     // output channels per block
constexpr int kSlice = 32;    // input channels per shared-memory slice
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gdn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma_t,
               const float* __restrict__ beta, float* __restrict__ y,
               int64_t n, int c, int inverse) {
  __shared__ float s_x2[kSlice][kRows + 1];
  __shared__ float s_g[kSlice][kCols];
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
    for (int e = tid; e < kSlice * kCols; e += kThreads) {
      const int cc = e % kCols, kk = e / kCols;
      const int ch = k0 + kk, o = col0 + cc;
      s_g[kk][cc] = (ch < c && o < c)
                        ? gamma_t[static_cast<int64_t>(ch) * c + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_x2[kk][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_g[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
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
      const float xv = x[row * c + o];
      y[row * c + o] = inverse ? xv * s : xv * (1.0f / s);
    }
  }
}

}  // namespace

extern "C" int cae_gdn_fwd(const float* x, const float* gamma_t,
                           const float* beta, float* y, int64_t n, int c,
                           int inverse, cudaStream_t stream) {
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((c + kCols - 1) / kCols));
  gdn_fwd_kernel<<<grid, kThreads, 0, stream>>>(x, gamma_t, beta, y, n, c,
                                                inverse);
  return static_cast<int>(cudaGetLastError());
}

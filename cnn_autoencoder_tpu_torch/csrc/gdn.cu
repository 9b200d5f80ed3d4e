// GDN / IGDN over (N, C) rows, for the H100 (sm_90a): K2, the forward of
// the bf16 training mode.  The serving forward K1 runs on the tensor cores
// in gdn_tc.cu, the bf16 mode's backward K3 in gdn_bf16_tc.cu.
//
// K2 replaces cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:
// _gdn_train_fwd_kernel (pallas_call in _gdn_train_fwd_pallas):
//   y[n, o] = x[n, o] * (beta[o] + sum_i gamma[o, i] * x[n, i]^2)^(-1/2)
// (IGDN: ^(+1/2)), written in the input's type, and the backward residual
// r = norm^(-1/2) (IGDN: norm^(+1/2)) as bf16.  The norm pool follows
// ops/gdn.py:norm_pool_precision: float32 rows in full float32; bf16 rows
// with x^2 and gamma rounded to bf16 and the products summed in float32
// (what the matrix unit's DEFAULT precision does).
//
// What bounds it here: the pool is 2 * C FLOP per element against 4 to
// 12 bytes read and written, so at C = 128 float32 FMAs on the CUDA cores
// (67 TFLOP/s) bound it, not memory (3.35 TB/s).  With bf16 rows the
// tensor cores would lift that bound above the byte bound; this kernel
// stays on the CUDA cores (a first, simple design: bf16 values are exact in
// float32, so the f32 FMAs give the bf16-multiplicand products exactly and
// sum them in float32).
//
// Design: the pool is a small matrix product (rows x C) @ (C x C).  A
// block of 256 threads owns a 64-row x 64-channel output tile; each thread
// holds a 4 x 4 register tile, so every pair of values loaded from shared
// memory feeds 4 FMAs.  The row operand x^2 and the C x C operand are
// staged through shared memory in 32-channel slices (row operand
// slice-major with one pad column, so the staging stores hit 32 banks);
// the C x C operand is read from device memory, where L2 keeps it.  The
// epilogue reads the row's inputs once more and writes each output once.
// C is taken as it comes (no padding to 128): partial tiles are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRows = 64;     // rows per block
constexpr int kCols = 64;     // output channels per block
constexpr int kSlice = 32;    // reduction channels per shared-memory slice
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc[i][j] += sum_kk a[kk][4 ty + i] * b[kk][tx + 16 j]
__device__ __forceinline__ void tile_fma(const float (*a)[kRows + 1],
                                         const float (*b)[kCols], int tx,
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

// K2.  gamma_t is gamma transposed: gamma_t[i * c + o] = gamma[o, i].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gdn_train_fwd_kernel(const T* __restrict__ x,
                     const float* __restrict__ gamma_t,
                     const float* __restrict__ beta, T* __restrict__ y,
                     bf16* __restrict__ rb, int64_t n, int c, int inverse) {
  constexpr bool kRound = std::is_same<T, bf16>::value;
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
      const float v = (row < n && ch < c) ? load(x, row * c + ch) : 0.f;
      s_x2[kk][r] = kRound ? round_bf16(v * v) : v * v;
    }
    for (int e = tid; e < kSlice * kCols; e += kThreads) {
      const int cc = e % kCols, kk = e / kCols;
      const int ch = k0 + kk, o = col0 + cc;
      const float gv = (ch < c && o < c)
                           ? gamma_t[static_cast<int64_t>(ch) * c + o] : 0.f;
      s_g[kk][cc] = kRound ? round_bf16(gv) : gv;
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
      store(y, idx, load(x, idx) * r);
      rb[idx] = __float2bfloat16(r);
    }
  }
}

dim3 row_grid(int64_t n, int c) {
  return dim3(static_cast<unsigned>((n + kRows - 1) / kRows),
              static_cast<unsigned>((c + kCols - 1) / kCols));
}

}  // namespace

// x and y are float32 (is_bf16 = 0) or bf16 (is_bf16 = 1); rb is bf16.
extern "C" int cae_gdn_train_fwd(const void* x, const float* gamma_t,
                                 const float* beta, void* y, void* rb,
                                 int64_t n, int c, int inverse, int is_bf16,
                                 cudaStream_t stream) {
  if (n == 0) return 0;
  bf16* r = static_cast<bf16*>(rb);
  if (is_bf16)
    gdn_train_fwd_kernel<bf16><<<row_grid(n, c), kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), gamma_t, beta, static_cast<bf16*>(y), r,
        n, c, inverse);
  else
    gdn_train_fwd_kernel<float><<<row_grid(n, c), kThreads, 0, stream>>>(
        static_cast<const float*>(x), gamma_t, beta, static_cast<float*>(y),
        r, n, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

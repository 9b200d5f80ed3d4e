// Fused reflect-pad + 3x3 stride-2 convolution + GDN, for the H100
// (sm_90a): K4, its serving variant and its training (want_y) variant.
//
// Replaces: cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel (its
// pallas_call in _fused_conv_gdn_pallas, entry fused_conv_gdn).  Computes,
// for NHWC x (B, H, W, Cin), HWIO weights (3, 3, Cin, Cout) and even H, W:
//   y[b, r, c, o]   = sum_{dy, dx, i} w[dy, dx, i, o] * x[b, R(2r+dy-1), R(2c+dx-1), i]
//   out[b, r, c, o] = y * (beta[o] + sum_i gamma[o, i] * y[b, r, c, i]^2)^(-1/2)
// with R the reflect index (-1 -> 1, H -> H-2).  The training variant
// (want_y in the TPU kernel) also writes the pre-GDN y in float32, the
// backward's residual.  Two compute types, chosen by x's type:
//   float32 x: float32 products (the JAX package's HIGHEST);
//   bf16 x:    bf16 multiplicands (w rounded to bf16 as it is staged) and
//              float32 sums (DEFAULT on the matrix unit).
// y is accumulated in float32 either way, the GDN epilogue is full float32
// (conv_gdn_kernel.py:57-70 there), and out is stored in x's type.
//
// What bounds it here: 2 * (9 * Cin + Cout) * Cout FLOP per output pixel
// (1152 + 128 terms per channel at the flagship's 128 -> 128 stage) against
// Cin * 16 + Cout * 4 bytes (float32), far above the float32 ridge: the
// CUDA cores' float32 FMA rate bounds it.  No tensor cores in this first
// design, in either type (bf16 values are exact in float32, so the float32
// FMAs give the bf16-multiplicand products exactly).
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin.  A
// block of 256 threads owns 64 output pixels x all (<= 128) output
// channels, because the GDN epilogue needs each pixel's whole channel row;
// a thread holds 4 pixels x 8 channels in registers.  The reflect index is
// computed while staging each 32-channel slice of one tap into shared
// memory, so there is no padded copy and no materialised tap stack (the
// TPU wrapper's nine-tap stack is 9x the input bytes).  The GDN pool runs
// on the finished tile: y^2 goes through the same shared-memory slices
// against gamma^T, and the output is written once.  Accumulation is float32
// in (tap, channel) order, so parity with cuDNN is by tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kPix = 64;      // output pixels per block
constexpr int kMaxCout = 128; // output channels held per block
constexpr int kSlice = 32;    // reduction slice staged in shared memory
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
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// T is x's and out's type; y (float32) is written when it is not null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_gdn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ gamma_t,
                    const float* __restrict__ beta, T* __restrict__ out,
                    float* __restrict__ y, int bsz, int h, int wd, int cin,
                    int cout) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  __shared__ float s_a[kSlice][kPix + 1];
  __shared__ float s_b[kSlice][kMaxCout];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx + 16 * j
  const int ty = tid / 16;  // pixels 4 * ty + i
  const int h2 = h / 2, w2 = wd / 2;
  const int64_t npix = static_cast<int64_t>(bsz) * h2 * w2;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPix;

  // this thread stages channel (slice offset) kk_ld of pixels
  // tid / 32 + 8 * m, m < 8: consecutive threads read consecutive channels
  const int kk_ld = tid % kSlice;
  int64_t pix_base[8];
  int pix_oy[8], pix_ox[8];
  bool pix_ok[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int64_t p = p0 + tid / kSlice + 8 * m;
    pix_ok[m] = p < npix;
    const int64_t pp = pix_ok[m] ? p : 0;
    const int64_t b = pp / (static_cast<int64_t>(h2) * w2);
    const int rem = static_cast<int>(pp - b * h2 * w2);
    pix_oy[m] = rem / w2;
    pix_ox[m] = rem % w2;
    pix_base[m] = b * h * wd;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    int64_t src[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int iy = reflect(2 * pix_oy[m] + dy - 1, h);
      const int ix = reflect(2 * pix_ox[m] + dx - 1, wd);
      src[m] = (pix_base[m] + static_cast<int64_t>(iy) * wd + ix) * cin;
    }
    for (int ci0 = 0; ci0 < cin; ci0 += kSlice) {
      const int ci = ci0 + kk_ld;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        s_a[kk_ld][tid / kSlice + 8 * m] =
            (pix_ok[m] && ci < cin) ? load(x, src[m] + ci) : 0.f;
      for (int e = tid; e < kSlice * kMaxCout; e += kThreads) {
        const int o = e % kMaxCout, kk = e / kMaxCout;
        const int c = ci0 + kk;
        const float wv = (c < cin && o < cout)
            ? w[(static_cast<int64_t>(tap) * cin + c) * cout + o] : 0.f;
        s_b[kk][o] = kBf16 ? __bfloat162float(__float2bfloat16(wv)) : wv;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_a[kk][4 * ty + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = s_b[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // GDN epilogue on the finished tile: norm = y^2 @ gamma^T + beta.
  // Channels >= cout hold y = 0 (masked weights) and gamma^T rows of 0.
  float nrm[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) nrm[i][j] = 0.f;
#pragma unroll
  for (int sl = 0; sl < kMaxCout / kSlice; ++sl) {
    // slice sl covers channels [32 sl, 32 sl + 32): held as j = 2 sl, 2 sl + 1
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = acc[i][2 * sl + jj];
        s_a[tx + 16 * jj][4 * ty + i] = v * v;
      }
    for (int e = tid; e < kSlice * kMaxCout; e += kThreads) {
      const int o = e % kMaxCout, kk = e / kMaxCout;
      const int c = kSlice * sl + kk;
      s_b[kk][o] = (c < cout && o < cout)
          ? gamma_t[static_cast<int64_t>(c) * cout + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[kk][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = s_b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) nrm[i][j] = fmaf(a[i], b[j], nrm[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t p = p0 + 4 * ty + i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = tx + 16 * j;
      if (o >= cout) continue;
      store(out, p * cout + o,
            acc[i][j] * (1.0f / sqrtf(nrm[i][j] + beta[o])));
      if (y != nullptr) y[p * cout + o] = acc[i][j];
    }
  }
}

}  // namespace

// x and out are float32 (is_bf16 = 0) or bf16 (is_bf16 = 1); y may be null
// (the serving variant).
extern "C" int cae_conv_gdn_fwd(const void* x, const float* w,
                                const float* gamma_t, const float* beta,
                                void* out, float* y, int bsz, int h, int wd,
                                int cin, int cout, int is_bf16,
                                cudaStream_t stream) {
  if (cout > kMaxCout || (h % 2) || (wd % 2) || h < 2 || wd < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t npix = static_cast<int64_t>(bsz) * (h / 2) * (wd / 2);
  if (npix == 0) return 0;
  const unsigned grid = static_cast<unsigned>((npix + kPix - 1) / kPix);
  if (is_bf16)
    conv_gdn_fwd_kernel<bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), w, gamma_t, beta, static_cast<bf16*>(out),
        y, bsz, h, wd, cin, cout);
  else
    conv_gdn_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), w, gamma_t, beta,
        static_cast<float*>(out), y, bsz, h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

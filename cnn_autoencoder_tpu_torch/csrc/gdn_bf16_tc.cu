// K3, the GDN / IGDN backward of the bf16 training mode, on the H100's bf16
// tensor cores (sm_90a).
//
// It replaces cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:
// _gdn_train_bwd_kernel (pallas_call in _gdn_train_bwd_pallas).  From the
// cotangent g and the bf16 residuals xb, rb of K2
// (csrc/gdn_fwd_bf16_tc.cu):
//   dnorm = (-0.5 g x) (r r r)   (IGDN: (0.5 g x) / r),  dnb = bf16(dnorm)
//   back[n, i] = sum_o dnb[n, o] * bf16(gamma[o, i])   (float32 sums)
//   dx = g r + 2 x back
// writing dx in g's type (bf16 or float32) and dnb as bf16; dgamma is a
// contraction over dnb outside the kernel (ops/gdn.py).  Where the caller
// asks for them, the kernel also writes the column sums of the float32
// dnorm, one row of partial sums for each group of warps: their sum over
// the rows is dbeta as the JAX package's default route takes it
// (ops/gdn.py:_gdn_mixed_bwd, the sum before the bf16 rounding), without
// another pass over the rows.
//
// What bounds it: at C = 128 the pool is 2 C = 256 operations per element
// against 10 bytes (bf16 g) or 14 bytes (float32 g) read and written once.
// Both multiplicands of the pool are bf16, so their products are exact in
// float32 and one bf16 mma.sync pass with float32 accumulators computes it:
// at the bf16 tensor-core rate (989 TFLOP/s) the pool is 0.009 ms at
// (262144, 128) against 0.100 ms of bytes, so the function is bound by
// memory and the design's work is to move every byte once.  What keeps the
// kernel above that bound on the card is the SM's elementwise work (dnb and
// dx, about two thirds of a tile's cycles; the probes below measure it).
//
// Design.  A prep kernel launched by the same C entry rounds gamma to bf16
// once per call into a wrapper-owned workspace, transposed (row i holds
// gamma[., i], the column-major B operand) and zero-padded to whole tiles.
//
// C <= 128 (the flagship's layers; gdn_bwd_tc_resident): one persistent
// block per SM holds the whole bf16 gamma in shared memory, loaded once,
// and two groups of 8 warps that take alternate tiles of 32 rows x all C
// channels, each with its own buffers and named barrier, so one group's
// product overlaps the other's elementwise work.  A tile of g, xb and rb
// is one contiguous span in device memory; it comes by 16-byte cp.async
// into one of the group's two stage buffers, the next tile's copies in
// flight while this one is computed.  Each thread turns groups of 8
// elements into dnb, stored once to device memory and once into the A tile
// in shared memory; the warps multiply A by gamma with ldmatrix and
// m16n8k16 bf16 mma (2 x 4 warps of 16 rows x 32 channels); the sums go
// through shared memory to the threads that own the elements, which read
// g, x and r from the stage buffer and store dx.  Every input byte is read
// from device memory once and every output byte written once.  Rows padded
// to 8 elements past the tile keep ldmatrix and the float2 stores free of
// bank conflicts; A's and gamma's channels past C are zero, so no product
// is guarded.
//
// dbeta's partial sums.  Where C divides a group's stride of 8 x 256
// elements (C = 8, 16, 32, 64, 128: the flagship's layers), each thread's
// groups of 8 lie on the same 8 channels in every tile, so the dnb loop
// adds its float32 dnorm into 8 registers; at the end the group's threads
// put them in shared memory and the thread of each channel adds the
// threads of its channel in a fixed order.  Any other C: the dnb loop
// leaves the tile's dnorm in the sums' buffer too, and after a group
// barrier the thread of each channel adds its column into a register (the
// rows of a tile, the group's tiles in turn); a second barrier frees the
// buffer for the product.  At the end each group stores its row of
// partial sums.  (On an H100 at (262144, 128) summing every tile's column
// behind a barrier cost K3 29 %; the registers' sums cost it 9 %.)
//
// C > 128 (gdn_bwd_tc_streamed, one group a block): a tile of 32 rows
// writes its dnb to device memory, then for each chunk of 128 output
// channels streams 64-deep slices of dnb (from L2, where this block just
// wrote it) and of the bf16 gamma into shared memory and multiplies them
// the same way, the slices' sums added up in shared memory; the epilogue
// reads g, x and r again.  It takes any C; it is not on the flagship's path.
//
// Any row count, both GDN and IGDN, g in bf16 or float32.  Inputs that are
// not 16-byte aligned are staged element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bf16_mma.cuh"
#include "smem_copy.cuh"

// Probe builds only (csrc/probes/gdn_bwd_probe.cu, built by chip_smoke.py):
// GDN_BWD_NO_IO 1 neither copies the tiles in nor stores dnb and dx (it
// stores only NaNs, which keeps them live), to time what the SM spends;
// GDN_BWD_LAPS 1 has thread 0 of every block add the clock64 cycles of each
// part of a tile (gdn_bwd_tc_resident) into g_bwd_laps.  The library
// builds with the defaults.
#ifndef GDN_BWD_NO_IO
#define GDN_BWD_NO_IO 0
#endif
#ifndef GDN_BWD_LAPS
#define GDN_BWD_LAPS 0
#endif

namespace {

using bf16 = __nv_bfloat16;

// The tile geometry (bf16_mma.cuh): groups of 8 warps on tiles of 32 rows;
// the resident kernel's block holds two groups that take alternate tiles,
// the streamed kernel's block one.
constexpr int kResidentThreads = 2 * kGroupThreads;
constexpr int kBackPitch = kChunk + 8;  // floats per row of the sums
constexpr bool kNoIO = GDN_BWD_NO_IO;

#if GDN_BWD_LAPS
// cycles by part of a tile, summed over blocks and tiles: the wait for the
// tile's copies, dnb, the product, dx (with the next tile's copies issued)
__device__ unsigned long long g_bwd_laps[4];
#endif

// add the cycles since `last` to part `part` (probe builds only)
__device__ __forceinline__ void lap(long long& last, int part) {
#if GDN_BWD_LAPS
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&g_bwd_laps[part], static_cast<unsigned long long>(now - last));
    last = now;
  }
#endif
}

__device__ __forceinline__ float dnorm_of(float g, float x, float r,
                                          bool inverse) {
  // the TPU kernel's operation order, so dnb rounds alike
  return inverse ? (0.5f * g * x) / r : (-0.5f * g * x) * (r * r * r);
}

// dnorm (f) and bf16(dnorm) (d) of 8 elements, as floats; the branch
// outside the loop
__device__ __forceinline__ void dnb8(const float (&g)[8], const float (&x)[8],
                                    const float (&r)[8], bool inverse,
                                    float (&f)[8], float (&d)[8]) {
  if (inverse) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = dnorm_of(g[i], x[i], r[i], true);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = dnorm_of(g[i], x[i], r[i], false);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    d[i] = __bfloat162float(__float2bfloat16(f[i]));
}

__device__ __forceinline__ float dx_of(float g, float x, float r,
                                       float back) {
  return fmaf(2.0f * x, back, g * r);
}

// 8 consecutive elements from shared memory (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ bool any_nan(const float (&v)[8]) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) nan |= v[i] != v[i];
  return nan;
}

// 8 consecutive values to device memory (16-byte aligned), in the type of p
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  if (kNoIO && !any_nan(v)) return;
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  if (kNoIO && !any_nan(v)) return;
  *reinterpret_cast<uint4*>(p) = pack8(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) {
  if (!kNoIO || v != v) *p = v;
}
__device__ __forceinline__ void store1(bf16* p, float v) {
  if (!kNoIO || v != v) *p = __float2bfloat16(v);
}

// bytes [0, nbytes) from src (16-byte aligned when aligned) into dst, by
// the threads gt of a group: 16-byte cp.async copies, the tail (and all of
// an unaligned span) element by element
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int nbytes,
                                           bool aligned, int gt) {
  if (kNoIO) return;
  int done = 0;
  if (aligned) {
    const int chunks = nbytes / 16;
    for (int q = gt; q < chunks; q += kGroupThreads)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * q,
                 reinterpret_cast<const char*>(src) + 16 * q);
    done = chunks * 16;
  }
  for (int e = done / static_cast<int>(sizeof(T)) + gt;
       e < nbytes / static_cast<int>(sizeof(T)); e += kGroupThreads)
    dst[e] = src[e];
}

// A tile's product over kSteps k-steps: a warp's 16 x 32 block of A (pitch
// lda) times the bf16 gamma (B^T, pitch ldb), into the group's sums, or
// added to them where accumulate (the sums of earlier slices).  Channels
// past C multiply zero rows of gamma.
template <int kSteps>
__device__ __forceinline__ void product_to_sums(const bf16* s_a, int lda,
                                                const bf16* s_bt, int ldb,
                                                float* s_back,
                                                bool accumulate) {
  const int warp = (threadIdx.x >> 5) % (kGroupThreads / 32);
  const int lane = threadIdx.x & 31;
  const int wm = warp % kWarpRows, wn = warp / kWarpRows;
  const int row = 16 * wm + (lane >> 2);
  const int col = kWarpCols * wn + 2 * (lane & 3);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* p = s_back + row * kBackPitch + col + 8 * j;
    acc[j][0] = accumulate ? p[0] : 0.f;
    acc[j][1] = accumulate ? p[1] : 0.f;
    acc[j][2] = accumulate ? p[8 * kBackPitch] : 0.f;
    acc[j][3] = accumulate ? p[8 * kBackPitch + 1] : 0.f;
  }
  warp_mma_bf16<4, kSteps>(s_a, lda, s_bt, ldb, 16 * wm, kWarpCols * wn,
                           acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* p = s_back + row * kBackPitch + col + 8 * j;
    *reinterpret_cast<float2*>(p) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(p + 8 * kBackPitch) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// dnb of the group of 8 at element e of a tile, to device memory (the tile's
// dnb at dnb_tile) and into row e / c of A
__device__ __forceinline__ void put_dnb(const float (&d)[8], int e, int elems,
                                        bf16* dnb_tile, bf16* s_a, int ld,
                                        int c, bool vec_rows) {
  if (e + 8 <= elems) {
    store8(dnb_tile + e, d);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (e + i < elems) store1(dnb_tile + e + i, d[i]);
  }
  if (vec_rows) {
    const int r = e / c;
    *reinterpret_cast<uint4*>(s_a + r * ld + e - r * c) = pack8(d);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (e + i < elems) {
        const int r = (e + i) / c;
        s_a[r * ld + e + i - r * c] = __float2bfloat16(d[i]);
      }
    }
  }
}

// the float32 dnorm of the group of 8 at element e of a tile into its rows
// of s_back (where the sums go later)
__device__ __forceinline__ void put_dnorm(const float (&f)[8], int e,
                                          int elems, int c, bool vec_rows,
                                          float* s_back) {
  if (vec_rows) {
    const int r = e / c;
    float4* p = reinterpret_cast<float4*>(s_back + r * kBackPitch + e - r * c);
    p[0] = make_float4(f[0], f[1], f[2], f[3]);
    p[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (e + i < elems) {
        const int r = (e + i) / c;
        s_back[r * kBackPitch + e + i - r * c] = f[i];
      }
    }
  }
}

// the sums of the group of 8 at element e of a tile, from its rows of s_back
__device__ __forceinline__ void get_back(const float* s_back, int e,
                                         int elems, int c, bool vec_rows,
                                         float (&back)[8]) {
  if (vec_rows) {
    const int r = e / c;
    load8(s_back + r * kBackPitch + e - r * c, back);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ei = min(e + i, elems - 1), r = ei / c;
      back[i] = s_back[r * kBackPitch + ei - r * c];
    }
  }
}

// C <= 128, K padded to kChunk.  Shared memory: gamma [kChunk][kChunk + 8]
// bf16, then for each of the two groups A [kRows][kChunk + 8] bf16, its
// sums [kRows][kBackPitch] float and two stage buffers of g | xb | rb for
// one tile each.
template <typename G>
__global__ void __launch_bounds__(kResidentThreads, 1)
gdn_bwd_tc_resident(const G* __restrict__ g, const bf16* __restrict__ xb,
                    const bf16* __restrict__ rb, const bf16* __restrict__ gt,
                    G* __restrict__ dx, bf16* __restrict__ dnb,
                    float* __restrict__ dbeta_part, int64_t n, int c,
                    int inverse, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kp = kChunk, ld = kp + 8;
  const int tile_elems = kRows * c;
  const int g_bytes = tile_elems * static_cast<int>(sizeof(G));
  const int stage_bytes = g_bytes + 4 * tile_elems;  // multiple of 16
  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  bf16* s_gamma = reinterpret_cast<bf16*>(smem);
  unsigned char* s_group = smem + 2 * kChunk * ld +
      group * (2 * kRows * ld + 4 * kRows * kBackPitch + 2 * stage_bytes);
  bf16* s_a = reinterpret_cast<bf16*>(s_group);
  float* s_back = reinterpret_cast<float*>(s_a + kRows * ld);
  unsigned char* s_stage = reinterpret_cast<unsigned char*>(
      s_back + kRows * kBackPitch);

  // gamma once per block, before either group starts
  for (int q = threadIdx.x; q < kChunk * (kp / 8); q += kResidentThreads) {
    const int row = q / (kp / 8), col = 8 * (q % (kp / 8));
    cp_async16(s_gamma + row * ld + col,
               gt + static_cast<int64_t>(row) * kp + col);
  }
  cp_async_commit();
  // A's channels past C stay zero
  for (int q = gtid; q < kRows * ld / 8; q += kGroupThreads)
    reinterpret_cast<uint4*>(s_a)[q] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  __syncthreads();

  const int64_t ntiles = (n + kRows - 1) / kRows;
  const int64_t first = 2 * static_cast<int64_t>(blockIdx.x) + group;
  const int64_t stride = 2 * static_cast<int64_t>(gridDim.x);
  auto issue = [&](int64_t t, int buf) {
    if (t < ntiles) {
      unsigned char* st = s_stage + buf * stage_bytes;
      const int elems = tile_rows(n, t) * c;
      const int64_t base = t * kRows * c;
      stage_span(reinterpret_cast<G*>(st), g + base,
                 elems * static_cast<int>(sizeof(G)), aligned, gtid);
      stage_span(reinterpret_cast<bf16*>(st + g_bytes), xb + base, 2 * elems,
                 aligned, gtid);
      stage_span(reinterpret_cast<bf16*>(st + g_bytes + 2 * tile_elems),
                 rb + base, 2 * elems, aligned, gtid);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  issue(first, 0);
  issue(first + stride, 1);

  const bool vec_rows = c % 8 == 0;  // a group of 8 lies in one row
  const bool sums = dbeta_part != nullptr;
  // each thread's 8 channels are the same in every tile
  const bool fixed = vec_rows && (8 * kGroupThreads) % c == 0;
  float colsum = 0.f;  // dbeta's partial sum of channel gtid (gtid < c)
  float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int buf = 0;
  long long last = GDN_BWD_LAPS ? clock64() : 0;
  for (int64_t t = first; t < ntiles; t += stride, buf ^= 1) {
    cp_async_wait<1>();  // this tile has landed
    group_sync(group);
    lap(last, 0);
    const unsigned char* st = s_stage + buf * stage_bytes;
    const G* sg = reinterpret_cast<const G*>(st);
    const bf16* sx = reinterpret_cast<const bf16*>(st + g_bytes);
    const bf16* sr = reinterpret_cast<const bf16*>(st + g_bytes +
                                                   2 * tile_elems);
    const int elems = tile_rows(n, t) * c;
    const int64_t base = t * kRows * c;

    // dnb, once to device memory and once into A
    for (int e = 8 * gtid; e < elems; e += 8 * kGroupThreads) {
      float gv[8], xv[8], rv[8], f[8], d[8];
      load8(sg + e, gv);
      load8(sx + e, xv);
      load8(sr + e, rv);
      dnb8(gv, xv, rv, inverse, f, d);
      put_dnb(d, e, elems, dnb + base, s_a, ld, c, vec_rows);
      if (sums && fixed) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc8[i] += f[i];
      } else if (sums) {
        put_dnorm(f, e, elems, c, vec_rows, s_back);
      }
    }
    group_sync(group);
    if (sums && !fixed) {
      if (gtid < c)
        for (int r = 0; r < elems / c; ++r)
          colsum += s_back[r * kBackPitch + gtid];
      group_sync(group);  // the product may overwrite s_back
    }
    lap(last, 1);

    product_to_sums<kp / 16>(s_a, ld, s_gamma, ld, s_back, false);
    group_sync(group);
    lap(last, 2);

    // dx from the stage buffer and the sums
    for (int e = 8 * gtid; e < elems; e += 8 * kGroupThreads) {
      float gv[8], xv[8], rv[8], back[8], out[8];
      load8(sg + e, gv);
      load8(sx + e, xv);
      load8(sr + e, rv);
      get_back(s_back, e, elems, c, vec_rows, back);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = dx_of(gv[i], xv[i], rv[i], back[i]);
      if (e + 8 <= elems) {
        store8(dx + base + e, out);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (e + i < elems) store1(dx + base + e + i, out[i]);
      }
    }
    group_sync(group);  // this stage buffer and the sums are free
    issue(t + 2 * stride, buf);
    lap(last, 3);
  }
  cp_async_wait<0>();
  if (sums && fixed) {
    // the threads of channel ch: gtid = ch / 8 + j c / 8, register ch % 8
    float* s_red = s_back;  // kGroupThreads x 8 floats
    group_sync(group);
#pragma unroll
    for (int i = 0; i < 8; ++i) s_red[8 * gtid + i] = acc8[i];
    group_sync(group);
    if (gtid < c)
      for (int j = 0; j < 8 * kGroupThreads / c; ++j)
        colsum += s_red[8 * (gtid / 8 + j * (c / 8)) + gtid % 8];
  }
  if (sums && gtid < c)
    dbeta_part[(2 * static_cast<int64_t>(blockIdx.x) + group) * c + gtid] =
        colsum;
}

// C > 128, one group a block.  Shared memory: A [kRows][kSliceK + 8] bf16,
// gamma [kChunk][kSliceK + 8] bf16, the sums [kRows][kBackPitch] float.
template <typename G>
__global__ void __launch_bounds__(kGroupThreads)
gdn_bwd_tc_streamed(const G* __restrict__ g, const bf16* __restrict__ xb,
                    const bf16* __restrict__ rb, const bf16* __restrict__ gt,
                    G* __restrict__ dx, bf16* dnb, float* dbeta_part,
                    int64_t n, int c, int kp, int inverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kSliceK + 8;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_gamma = s_a + kRows * ld;
  float* s_back = reinterpret_cast<float*>(s_gamma + kChunk * ld);
  const int64_t ntiles = (n + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  // dbeta's partial sums: this block's row, each channel's only by its
  // thread, the tiles in turn
  float* part = dbeta_part == nullptr
                    ? nullptr
                    : dbeta_part + static_cast<int64_t>(blockIdx.x) * c;
  if (part != nullptr)
    for (int ch = tid; ch < c; ch += kGroupThreads) part[ch] = 0.f;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int rows = tile_rows(n, t);
    const int64_t base = t * kRows * c;
    for (int e = tid; e < rows * c; e += kGroupThreads) {
      const int64_t i = base + e;
      store1(dnb + i, dnorm_of(to_float(g[i]), __bfloat162float(xb[i]),
                               __bfloat162float(rb[i]), inverse));
    }
    if (part != nullptr) {
      for (int ch = tid; ch < c; ch += kGroupThreads) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) {
          const int64_t i = base + static_cast<int64_t>(r) * c + ch;
          sum += dnorm_of(to_float(g[i]), __bfloat162float(xb[i]),
                          __bfloat162float(rb[i]), inverse);
        }
        part[ch] += sum;
      }
    }
    __syncthreads();  // this block's dnb is visible to the block
    for (int n0 = 0; n0 < c; n0 += kChunk) {
      const int width = min(kChunk, c - n0);
      for (int k0 = 0; k0 < kp; k0 += kSliceK) {
        for (int q = tid; q < kChunk * (kSliceK / 8); q += kGroupThreads) {
          const int row = q / (kSliceK / 8), col = 8 * (q % (kSliceK / 8));
          cp_async16(s_gamma + row * ld + col,
                     gt + static_cast<int64_t>(n0 + row) * kp + k0 + col);
        }
        cp_async_commit();
        for (int e = tid; e < kRows * kSliceK; e += kGroupThreads) {
          const int r = e / kSliceK, k = e - r * kSliceK;
          s_a[r * ld + k] = (r < rows && k0 + k < c && !kNoIO)
                                ? dnb[base + static_cast<int64_t>(r) * c +
                                      k0 + k]
                                : __float2bfloat16(0.f);
        }
        cp_async_wait<0>();
        __syncthreads();
        product_to_sums<kSliceK / 16>(s_a, ld, s_gamma, ld, s_back, k0 > 0);
        __syncthreads();
      }
      for (int e = tid; e < rows * width; e += kGroupThreads) {
        const int r = e / width, ch = e - r * width;
        const int64_t i = base + static_cast<int64_t>(r) * c + n0 + ch;
        store1(dx + i, dx_of(to_float(g[i]), __bfloat162float(xb[i]),
                             __bfloat162float(rb[i]),
                             s_back[r * kBackPitch + ch]));
      }
      __syncthreads();
    }
  }
}

int resident_smem(int c, int g_size) {
  return 2 * kChunk * (kChunk + 8) +
         2 * (2 * kRows * (kChunk + 8) + 4 * kRows * kBackPitch +
              2 * kRows * c * (g_size + 4));
}

constexpr int kStreamedSmem =
    2 * (kRows + kChunk) * (kSliceK + 8) + 4 * kRows * kBackPitch;

// The grid of the kernel for (n, c) rows with g of type G, its shared
// memory opted in.
template <typename G>
cudaError_t plan(int64_t n, int c, unsigned* grid) {
  const bool resident = c <= kChunk;
  const void* kernel =
      resident ? reinterpret_cast<const void*>(gdn_bwd_tc_resident<G>)
               : reinterpret_cast<const void*>(gdn_bwd_tc_streamed<G>);
  const int threads = resident ? kResidentThreads : kGroupThreads;
  const int smem = resident ? resident_smem(c, sizeof(G)) : kStreamedSmem;
  int blocks = 0;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err == cudaSuccess) err = resident_blocks(kernel, threads, smem, &blocks);
  if (err != cudaSuccess) return err;
  // a resident block's two groups take two tiles at a time
  const int64_t ntiles = (n + kRows - 1) / kRows;
  *grid = static_cast<unsigned>(
      std::min<int64_t>(resident ? (ntiles + 1) / 2 : ntiles, blocks));
  return cudaSuccess;
}

// rows of dbeta's partial sums for a grid: one a group of warps
int64_t partial_rows(int c, unsigned grid) {
  return (c <= kChunk ? 2 : 1) * static_cast<int64_t>(grid);
}

template <typename G>
cudaError_t launch(const G* g, const bf16* xb, const bf16* rb,
                   const float* gamma, G* dx, bf16* dnb, float* dbeta_part,
                   bf16* gt, int64_t n, int c, int inverse,
                   cudaStream_t stream) {
  const bool resident = c <= kChunk;
  const int kp = gamma_bf16_kp(c);
  cudaError_t err = launch_gamma_bf16_prep(gamma, gt, c, 1, stream);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  err = plan<G>(n, c, &grid);
  if (err != cudaSuccess) return err;
  const int threads = resident ? kResidentThreads : kGroupThreads;
  const int smem = resident ? resident_smem(c, sizeof(G)) : kStreamedSmem;
  if (resident) {
    const int aligned = (reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(xb) |
                         reinterpret_cast<uintptr_t>(rb)) % 16 == 0;
    gdn_bwd_tc_resident<G><<<grid, threads, smem, stream>>>(
        g, xb, rb, gt, dx, dnb, dbeta_part, n, c, inverse, aligned);
  } else {
    gdn_bwd_tc_streamed<G><<<grid, threads, smem, stream>>>(
        g, xb, rb, gt, dx, dnb, dbeta_part, n, c, kp, inverse);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace cae_gdn_train_bwd takes for C channels: the bf16
// gamma, transposed and padded.
extern "C" int64_t cae_gdn_train_bwd_workspace(int c) {
  return gamma_bf16_bytes(c);
}

// Rows of dbeta's partial sums that cae_gdn_train_bwd writes for (n, c)
// rows (float32 g: is_bf16 = 0), each of c floats; -1 on a CUDA error.
extern "C" int64_t cae_gdn_train_bwd_partials(int64_t n, int c,
                                              int is_bf16) {
  if (n == 0 || c == 0) return 0;
  unsigned grid = 0;
  const cudaError_t err =
      is_bf16 ? plan<bf16>(n, c, &grid) : plan<float>(n, c, &grid);
  return err == cudaSuccess ? partial_rows(c, grid) : -1;
}

// g and dx are float32 (is_bf16 = 0) or bf16 (is_bf16 = 1); xb, rb and dnb
// are bf16; gamma is float32 (C, C); work holds
// cae_gdn_train_bwd_workspace(c) bytes, 16-byte aligned.  dbeta_part is
// null, or float32 (cae_gdn_train_bwd_partials(n, c, is_bf16), c): the
// column sums of the float32 dnorm, whose sum over the rows is dbeta.
extern "C" int cae_gdn_train_bwd(const void* g, const void* xb,
                                 const void* rb, const float* gamma, void* dx,
                                 void* dnb, float* dbeta_part, void* work,
                                 int64_t n, int c, int inverse, int is_bf16,
                                 cudaStream_t stream) {
  if (n == 0 || c == 0) return 0;
  const bf16* x = static_cast<const bf16*>(xb);
  const bf16* r = static_cast<const bf16*>(rb);
  bf16* d = static_cast<bf16*>(dnb);
  bf16* gt = static_cast<bf16*>(work);
  const cudaError_t err =
      is_bf16 ? launch(static_cast<const bf16*>(g), x, r, gamma,
                       static_cast<bf16*>(dx), d, dbeta_part, gt, n, c,
                       inverse, stream)
              : launch(static_cast<const float*>(g), x, r, gamma,
                       static_cast<float*>(dx), d, dbeta_part, gt, n, c,
                       inverse, stream);
  return static_cast<int>(err);
}

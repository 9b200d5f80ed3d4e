// Diagnostics of K1 (csrc/gdn_tc.cu), never part of the kernels' library:
// chip_smoke.py builds this file on its own, once for each variant of K1
// or of K2 on float32 rows it compares with the library's
// (-DGDN_TC_PASSES=1, -DGDN_TC_NO_IO=1, -DGDN_TC_R_TILE=0; see gdn_tc.cu),
// and loads each build beside the library.  Every build also
// carries the mma.sync rate probe and K1's layout query below.
#include "../gdn_tc.cu"

namespace {

// The tensor cores' mma.sync TF32 rate, the ceiling of K1's products:
// every warp issues iters x 8 independent m16n8k8 products.
__global__ void __launch_bounds__(kThreads)
mma_probe_kernel(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x ^ 9u, b1 = threadIdx.x ^ 13u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, b0, b1);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// blocks x 256 threads of the mma.sync TF32 probe into out (one float a
// thread): blocks x 8 warps x iters x 8 products of 2 x 16 x 8 x 8 FLOP.
extern "C" int cae_gdn_mma_probe(float* out, int blocks, int iters,
                                 cudaStream_t stream) {
  mma_probe_kernel<<<blocks, kThreads, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

// The layout K1 (K2 on float32 rows: want_r) takes for C channels on the
// current device, from its launch plan: out = {tile groups per block, rows
// per tile, gamma resident (1/0), x in K-slices (1/0), x tiles in each
// ring, dynamic shared memory bytes, most blocks in the grid, r tiles
// (1/0)}.
extern "C" int cae_gdn_fwd_layout(int c, int want_r, int* out) {
  Launch l;
  const cudaError_t err = launch_for(c, want_r != 0, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[] = {l.plan.groups, 32 * l.plan.row_warps, l.plan.resident,
                   l.plan.xslice, l.plan.nbuf, l.plan.smem, l.cap,
                   l.plan.r_tile};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

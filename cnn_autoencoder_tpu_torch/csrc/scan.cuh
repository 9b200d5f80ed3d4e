// Block-wide exclusive prefix count of one flag per thread.
#pragma once

#include <cuda_runtime.h>

// Returns the number of set flags among the threads before this one in the
// block (thread order), and the block's total in *total.  Every thread of
// the block must call it (it synchronises twice).  s_warp holds one int per
// warp (at most 32).  blockDim.x must be a multiple of 32.
__device__ __forceinline__ int block_exclusive_count(bool flag, int* s_warp,
                                                     int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int i = 0; i < nwarps; ++i) {
    const int v = s_warp[i];
    before += (i < warp) ? v : 0;
    sum += v;
  }
  __syncthreads();  // s_warp is rewritten by the next call
  *total = sum;
  return before + rank;
}

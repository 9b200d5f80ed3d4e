// Shared-memory helpers of the kernels that stage their operands
// (csrc/gdn_tc.cu, csrc/conv_gdn.cu, csrc/rans.cu, the bf16 GDN kernels):
// cp.async copies into shared memory, the wait on an mbarrier, and the
// host's once-per-device opt-in to a kernel's dynamic shared memory and
// count of the blocks the device holds at once.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

// a generic pointer into shared memory as a shared-window address
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes (src not read) where !ok
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  const uint32_t s = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for the phase of parity `parity` of mbarrier bar to complete; a
// copy that never lands traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}

// Opt kernel k in to smem bytes of dynamic shared memory on the current
// device, once per (device, kernel); later calls read the cache.
inline cudaError_t opt_in_smem(const void* k, int smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto found = done.find({dev, k});
  if (found != done.end() && found->second >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  done[{dev, k}] = smem;
  return cudaSuccess;
}

// The blocks of `kernel` (threads threads, smem bytes of dynamic shared
// memory, opted in) that the current device holds at once, queried once per
// (device, kernel, smem).
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                                   int* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  const auto found = cache.find(key);
  if (found != cache.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *out = cache[key] = sms * std::max(per_sm, 1);
  return cudaSuccess;
}

}  // namespace

// Diagnostics of K3 (csrc/gdn_bf16_tc.cu), never part of the kernels'
// library: chip_smoke.py builds this file on its own, with and without
// -DGDN_BWD_NO_IO=1 (no device-memory traffic for the tiles; see
// gdn_bf16_tc.cu), and times each build beside the library's K3.  Both
// record the cycles of each part of a tile (GDN_BWD_LAPS), which
// cae_gdn_bwd_probe_laps reads and resets.
#define GDN_BWD_LAPS 1
#include "../gdn_bf16_tc.cu"

// out = the cycles by part of a tile (the wait for its copies, dnb, the
// product, dx), summed over blocks and tiles since the last read; then
// zero them
extern "C" int cae_gdn_bwd_probe_laps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_bwd_laps,
                                         sizeof(unsigned long long) * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_bwd_laps, zero,
                                             sizeof(zero)));
}

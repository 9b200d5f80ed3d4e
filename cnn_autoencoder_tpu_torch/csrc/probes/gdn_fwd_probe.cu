// Diagnostics of K2's bf16 rows (csrc/gdn_fwd_bf16_tc.cu), never part of
// the kernels' library: chip_smoke.py builds this file on its own, as it
// is and with -DGDN_FWD_NO_IO=1 (no device-memory traffic for the tiles),
// and times each build beside the library's K2.  Both record the cycles of
// each part of a tile (GDN_FWD_LAPS), which cae_gdn_fwd_probe_laps reads
// and resets.
#define GDN_FWD_LAPS 1
#include "../gdn_fwd_bf16_tc.cu"

// out = the cycles by part of a tile (the wait for its copies, x^2, the
// product, the epilogue), summed over blocks and tiles since the last read;
// then zero them
extern "C" int cae_gdn_fwd_probe_laps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_fwd_laps,
                                         sizeof(unsigned long long) * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_fwd_laps, zero,
                                             sizeof(zero)));
}

// groups of the resident block (thread 0, which keeps the laps, is in the
// first of them and takes one tile in kGroups)
extern "C" int cae_gdn_fwd_probe_groups() { return kGroups; }

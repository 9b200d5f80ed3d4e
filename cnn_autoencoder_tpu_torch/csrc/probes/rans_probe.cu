// Diagnostics of K5 and K6's state pass (csrc/rans.cu), never part of the
// kernels' library: chip_smoke.py builds this file on its own and loads it
// beside the library.  It is rans.cu with RANS_PROBE set, so thread 0 of
// every block records clock64 and the global nanosecond timer around its
// serial loop, and the decode's cycles by part of its steps;
// cae_rans_probe_read and cae_rans_probe_laps copy those records out.
#define RANS_PROBE 1
#include "../rans.cu"

// The records of the last launch of `which` (0: the encode state pass, 1:
// the decode) for its first `blocks` blocks: per block {clock64 at the
// loop's start, at its end, nanoseconds at its start, at its end}.
extern "C" int cae_rans_probe_read(int which, unsigned long long* out,
                                   int blocks) {
  if (which < 0 || which > 1 || blocks < 1 || blocks > kProbeBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_rans_probe, sizeof(unsigned long long) * 4 * blocks,
      sizeof(unsigned long long) * 4 * kProbeBlocks * which));
}

// The decode's cycles by part of its steps, summed over the steps, for the
// first `blocks` blocks of its last launch: per block {the decode of the
// step's states, the wait for the copies and the block's barrier, the
// counts of the warps before, the refills}.
extern "C" int cae_rans_probe_laps(unsigned long long* out, int blocks) {
  if (blocks < 1 || blocks > kProbeBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_rans_laps, sizeof(unsigned long long) * kLaps * blocks));
}

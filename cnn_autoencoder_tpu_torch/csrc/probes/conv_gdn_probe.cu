// Diagnostics of K4 (csrc/conv_gdn.cu), never part of the kernels' library:
// chip_smoke.py builds this file on its own, once for each variant of K4
// it times beside the library's (-DCONV_GDN_PASSES=1, -DCONV_GDN_NO_IO=1;
// see conv_gdn.cu), and loads each build beside the library.
#include "../conv_gdn.cu"

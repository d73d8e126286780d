// Kernel K2, the packed SubM 3x3x3 convolution (subm_conv.cuh), for
// fp32 activations (the fp32 forward, entry.entry()).

#include "subm_conv.cuh"

namespace {
using T = float;
constexpr int DTYPE = 0;
}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, identity and out); this library takes
// fp32 activations only. w: the packed weight panels (bf16, in ktable's
// order); ktable: nkb host rows of (x lane, pack offset, first output
// column, window width). Needs C % 16 == 0, Co of 16, 32, 64 or 128 with
// p*Co = N = 128, windows of 1-3 whole output slots, G % bz == 0 and
// 16-byte aligned pointers; the Python wrapper checks them.
// Returns the launch's CUDA error code.
extern "C" int subm_ext_conv(const void* x, const void* w, void* out,
                             int mode, const void* mcell, const void* mean,
                             const void* inv, const void* bias,
                             const void* identity, const int* ktable,
                             int dtype, int G, int bz, int X, int Y, int pC,
                             int C, int Co, int nkb, void* stream) {
  if (dtype != DTYPE) return static_cast<int>(cudaErrorInvalidValue);
  return entry<T>(x, w, out, mode, mcell, mean, inv, bias, identity, ktable,
                  G, bz, X, Y, pC, C, Co, nkb, stream);
}

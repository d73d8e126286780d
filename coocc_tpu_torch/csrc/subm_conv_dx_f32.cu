// The dX kernel of K2's backward (subm_conv_bwd.cuh), writing fp32 dx (the
// fp32 train step; the wrapper rounds the fp32 cotangent to bf16 first).

#include "subm_conv_bwd.cuh"

// As subm_conv_dx.cu's entry, with out fp32 [G, X, Y, 128].
extern "C" int subm_ext_conv_dx(const void* dy, const void* panels, void* out,
                                const int* table, const int* nkb,
                                const int* base, int ngroups, int p, int G,
                                int bz, int X, int Y, void* stream) {
  return dx_entry<float>(dy, panels, out, table, nkb, base, ngroups, p, G,
                         bz, X, Y, stream);
}

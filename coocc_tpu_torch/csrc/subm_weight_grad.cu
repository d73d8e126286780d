// The dW kernel of K2's backward and its deterministic reduce
// (subm_conv_dw.cuh).

#include "subm_conv_dw.cuh"

// x: bf16 [G, X, Y, pC]; dy0..dy2: nparts bf16 [G, X, Y, 128] whose sum
// is the masked cotangent (1 part for bf16 activations, 3 for fp32);
// table: nunits rows of 44 ints (DwUnit: x tiles, dy windows, and what
// each consumer warpgroup multiplies); S: the splits of the cells;
// partials: the fp32 workspace; gw: fp32 [9, E, 128], zeroed by the
// caller, each element rounded to the activations' type (out_dtype 0 =
// fp32, 1 = bf16).
// Returns the first CUDA error code of the two launches.
extern "C" int subm_ext_weight_grad(const void* x, const void* dy0,
                                    const void* dy1, const void* dy2,
                                    int nparts, const int* table, int nunits,
                                    int S, void* partials, void* gw,
                                    int out_dtype, int G, int bz, int X,
                                    int Y, int pC, int E, void* stream) {
  const void* dy[3] = {dy0, dy1, dy2};
  if (out_dtype == 1)
    return dw_entry<__nv_bfloat16>(x, dy, nparts, table, nunits, S, partials,
                                   gw, G, bz, X, Y, pC, E, stream);
  if (out_dtype == 0)
    return dw_entry<float>(x, dy, nparts, table, nunits, S, partials, gw, G,
                           bz, X, Y, pC, E, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

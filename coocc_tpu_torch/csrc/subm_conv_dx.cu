// The dX kernel of K2's backward (subm_conv_bwd.cuh), writing bf16 dx (the
// bf16 train step).

#include "subm_conv_bwd.cuh"

// dy: bf16 [G, X, Y, 128], the masked cotangent; panels: the packed bf16
// weight panels of the mirrored taps, group by group; table: ngroups x 24
// host rows of (dy lane, pack offset, first output lane in the group,
// width), nkb[ngroups], base[ngroups + 1] the groups' panel byte offsets;
// out: bf16 [G, X, Y, 128]. Needs 16-byte aligned pointers; the Python
// wrapper checks the shapes. Returns the launch's CUDA error code.
extern "C" int subm_ext_conv_dx(const void* dy, const void* panels, void* out,
                                const int* table, const int* nkb,
                                const int* base, int ngroups, int p, int G,
                                int bz, int X, int Y, void* stream) {
  return dx_entry<__nv_bfloat16>(dy, panels, out, table, nkb, base, ngroups,
                                 p, G, bz, X, Y, stream);
}

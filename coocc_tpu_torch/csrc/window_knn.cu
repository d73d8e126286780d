// Window-KNN best-2 search over a voxel grid, for Hopper (sm_90a).
//
// For every cell (x, y, z) of an [X, Y, Z] key-activity mask, the linear ids
// ((x*Y + y)*Z + z) of the first two ACTIVE cells met when walking the window
// offsets in their given order (make_offsets: sorted by L2 norm, clipped at
// dist_thresh), or -1. Output [X, Y, Z, 2] int32. Cells outside the grid are
// never active.
//
// Replaces the TPU kernel coocc_tpu/ops/pallas/window_knn.py (_kernel, via
// _best2_ranks / window_knn_best2) and the rank->id step after it
// (coocc_tpu/ops/window_knn.py:_ranks_to_ids).
//
// Bound and design: the mask is one byte a cell (80 KB at the flagship
// 100x100x8 grid) and the ids 8 bytes a cell, so memory traffic is no bound;
// the cost is the probe count: one shared-memory byte load and compare per
// offset tried, from 2 per cell (dense keys) to O per cell (empty window).
// One block covers a TX*TY*TZ tile of cells, one thread a cell. The block
// stages its tile plus the (rx, ry, rz) halo in shared memory as bytes, zero
// outside the grid, and the offset list as shared-memory deltas in rank
// order; each thread walks the deltas from its own cell and stops at its
// second hit. Neighbouring threads differ in z, so their probes hit
// neighbouring bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 4;
constexpr int TY = 8;
constexpr int TZ = 8;
constexpr int THREADS = TX * TY * TZ;

// Linear id of `cell` moved by offset row `o`; -1 for no hit (o < 0).
__device__ __forceinline__ int32_t neighbour_id(
    const int32_t* __restrict__ offsets, int o, int64_t cell, int Y, int Z) {
  if (o < 0) return -1;
  return static_cast<int32_t>(
      cell + (static_cast<int64_t>(offsets[3 * o]) * Y + offsets[3 * o + 1]) *
                 Z + offsets[3 * o + 2]);
}

__global__ void __launch_bounds__(THREADS)
window_knn_best2_kernel(const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ offsets, int O, int X,
                        int Y, int Z, int rx, int ry, int rz,
                        int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int HY = TY + 2 * ry;
  const int HZ = TZ + 2 * rz;
  const int HX = TX + 2 * rx;
  int32_t* s_delta = smem;                                   // [O]
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(smem + O);    // [HX*HY*HZ]

  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * TX;
  const int tid = threadIdx.x;

  for (int o = tid; o < O; o += THREADS) {
    const int dx = offsets[3 * o], dy = offsets[3 * o + 1],
              dz = offsets[3 * o + 2];
    s_delta[o] = (dx * HY + dy) * HZ + dz;
  }
  const int n_halo = HX * HY * HZ;
  for (int h = tid; h < n_halo; h += THREADS) {
    const int hx = h / (HY * HZ);
    const int hy = (h / HZ) % HY;
    const int hz = h % HZ;
    const int gx = x0 - rx + hx, gy = y0 - ry + hy, gz = z0 - rz + hz;
    uint8_t v = 0;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
      v = mask[(static_cast<int64_t>(gx) * Y + gy) * Z + gz];
    s_mask[h] = v;
  }
  __syncthreads();

  const int lx = tid / (TY * TZ);
  const int ly = (tid / TZ) % TY;
  const int lz = tid % TZ;
  const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
  if (x >= X || y >= Y || z >= Z) return;

  const int center = ((lx + rx) * HY + (ly + ry)) * HZ + (lz + rz);
  const int64_t cell = (static_cast<int64_t>(x) * Y + y) * Z + z;
  int first = -1, second = -1;
  for (int o = 0; o < O; ++o) {
    if (s_mask[center + s_delta[o]]) {
      if (first < 0) {
        first = o;
      } else {
        second = o;
        break;
      }
    }
  }
  out[2 * cell] = neighbour_id(offsets, first, cell, Y, Z);
  out[2 * cell + 1] = neighbour_id(offsets, second, cell, Y, Z);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// mask: [X, Y, Z] uint8/bool, offsets: [O, 3] int32 with |d| <= (rx, ry, rz),
// out: [X, Y, Z, 2] int32, all device pointers, contiguous.
extern "C" int window_knn_best2(const void* mask, const void* offsets, int O,
                                int X, int Y, int Z, int rx, int ry, int rz,
                                void* out, void* stream) {
  const size_t smem = sizeof(int32_t) * O +
                      static_cast<size_t>(TX + 2 * rx) * (TY + 2 * ry) *
                          (TZ + 2 * rz);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_knn_best2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Z + TZ - 1) / TZ, (Y + TY - 1) / TY, (X + TX - 1) / TX);
  window_knn_best2_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(offsets), O, X, Y, Z, rx, ry, rz,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

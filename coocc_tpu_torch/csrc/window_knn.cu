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
// Bound: the mask is one byte a cell (80 KB at the flagship 100x100x8 grid)
// and the ids 8 bytes a cell, so memory traffic is no bound; the work is the
// search. Walked offset by offset (O = 1,215 or 2,535 at the flagship), a
// cell with an empty window pays O dependent shared-memory probes, and that
// latency, not the probe count, sets the time.
//
// Design: the walk goes over the window's (dx, dy) COLUMNS, not its offsets
// (169 columns for the 13x13x15 window, 81 for 9x9x15). The block packs its
// tile of TX x TY grid columns and their (rx, ry) halo into shared memory as
// one 32-bit word per column, bit z set where the cell is active (Z <= 32;
// words outside the grid are 0, so out-of-grid z never costs a step). The
// host tables (ops/window_knn.py:column_tables) list the columns by the
// smallest rank any of their dz takes, with a 64-bit mask of the dz the
// offset list keeps (dist_thresh clips the far ones) and each column's rank
// per dz; the block stages the column list, the rank rows are read through
// L1 on hits only. A thread owns a cell and, per column, masks the column's
// word to the kept dz, takes the two nearest set bits above z with __ffs
// and the two nearest below with __clz (ranks grow with |dz| in a column,
// so the column's best two are among these four; +dz and -dz are compared
// by their ranks from the table), and keeps the best two ranks. It stops
// before a chunk of CHUNK columns whose first column's smallest rank is not
// below its second rank: ranks only grow along the list, so no later column
// can improve either. The chunk's words are loaded together, so an empty
// window's walk waits on a quarter of the dependent loads; a column past
// the stopping point inside a chunk changes nothing. The rank -> id step
// is cell + delta(offset[rank]).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 4;
constexpr int TY = 8;
constexpr int THREADS = 256;
constexpr int CHUNK = 4;  // columns a step loads together

// Linear id of `cell` moved by offset row `o`; -1 for no hit (o == O).
__device__ __forceinline__ int32_t neighbour_id(
    const int32_t* __restrict__ offsets, int o, int O, int64_t cell, int Y,
    int Z) {
  if (o >= O) return -1;
  return static_cast<int32_t>(
      cell + (static_cast<int64_t>(offsets[3 * o]) * Y + offsets[3 * o + 1]) *
                 Z + offsets[3 * o + 2]);
}

__global__ void __launch_bounds__(THREADS)
window_knn_best2_kernel(const uint8_t* __restrict__ mask,
                        const int4* __restrict__ cols,
                        const int32_t* __restrict__ ranks, int NC, int RW,
                        const int32_t* __restrict__ offsets, int O, int X,
                        int Y, int Z, int rx, int ry,
                        int32_t* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int HX = TX + 2 * rx;
  const int HY = TY + 2 * ry;
  const int rz = RW / 2;
  const int NCP = (NC + CHUNK - 1) / CHUNK * CHUNK;
  int4* s_col = smem;  // [NCP]: (dx*HY + dy, min rank, allow lo, allow hi)
  uint32_t* s_word = reinterpret_cast<uint32_t*>(s_col + NCP);  // [HX*HY]

  const int y0 = blockIdx.x * TY;
  const int x0 = blockIdx.y * TX;
  const int tid = threadIdx.x;

  for (int k = tid; k < NCP; k += THREADS) {
    // (dx << 16 | dy & 0xffff, min, lo, hi); the padding allows no dz
    int4 c = k < NC ? __ldg(cols + k) : make_int4(0, O, 0, 0);
    c.x = (c.x >> 16) * HY + static_cast<int16_t>(c.x & 0xffff);
    s_col[k] = c;
  }
  for (int h = tid; h < HX * HY; h += THREADS) {
    const int gx = x0 - rx + h / HY, gy = y0 - ry + h % HY;
    uint32_t w = 0;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y) {
      const uint8_t* col = mask + (static_cast<int64_t>(gx) * Y + gy) * Z;
#pragma unroll 8
      for (int z = 0; z < Z; ++z) w |= static_cast<uint32_t>(col[z] != 0) << z;
    }
    s_word[h] = w;
  }
  __syncthreads();

  for (int c = tid; c < TX * TY * Z; c += THREADS) {
    const int z = c % Z, lx = c / Z / TY, ly = c / Z % TY;
    const int x = x0 + lx, y = y0 + ly;
    if (x >= X || y >= Y) continue;
    const uint32_t* center = s_word + (lx + rx) * HY + (ly + ry);
    const uint32_t below = (1u << z) - 1u;
    const int shift = 32 - z;  // allow bit dz + 32 -> word bit z + dz
    int r1 = O, r2 = O;
    auto insert = [&](int r) {
      r2 = min(r2, max(r1, r));
      r1 = min(r1, r);
    };
    for (int k0 = 0; k0 < NCP; k0 += CHUNK) {
      if (s_col[k0].y >= r2) break;
      // CHUNK columns at once: a column past the stopping point can only
      // offer ranks >= its smallest >= r2, which change neither rank
      uint32_t w[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int4 cv = s_col[k0 + i];
        w[i] = center[cv.x] &
               __funnelshift_rc(static_cast<uint32_t>(cv.z),
                                static_cast<uint32_t>(cv.w), shift);
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        if (w[i] == 0) continue;
        // rank[p - z] for word bit p, |p - z| <= rz (a hit reads the table
        // from L1: a few reads a cell, where staging it cost every block)
        const int32_t* rank = ranks + (k0 + i) * RW + rz;
        uint32_t up = w[i] & ~below;
        uint32_t dn = w[i] & below;
        if (up) {
          const int p = __ffs(up) - 1;
          insert(rank[p - z]);
          up &= up - 1u;
          if (up) insert(rank[__ffs(up) - 1 - z]);
        }
        if (dn) {
          const int p = 31 - __clz(dn);
          insert(rank[p - z]);
          dn ^= 1u << p;
          if (dn) insert(rank[31 - __clz(dn) - z]);
        }
      }
    }
    const int64_t cell = (static_cast<int64_t>(x) * Y + y) * Z + z;
    out[2 * cell] = neighbour_id(offsets, r1, O, cell, Y, Z);
    out[2 * cell + 1] = neighbour_id(offsets, r2, O, cell, Y, Z);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// mask: [X, Y, Z] uint8/bool with Z <= 32; table: int32, NC column rows
// (dx << 16 | dy & 0xffff, min rank, allow lo, allow hi) sorted by min rank,
// then NC rank rows of RW (rank of dz at dz + RW/2); offsets: [O, 3] int32
// with |dx| <= rx, |dy| <= ry; out: [X, Y, Z, 2] int32; all device
// pointers, contiguous.
extern "C" int window_knn_best2(const void* mask, const void* table, int NC,
                                int RW, const void* offsets, int O, int X,
                                int Y, int Z, int rx, int ry, void* out,
                                void* stream) {
  if (Z < 1 || Z > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int4) * ((NC + CHUNK - 1) / CHUNK * CHUNK) +
                      sizeof(uint32_t) * (TX + 2 * rx) * (TY + 2 * ry);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_knn_best2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Y + TY - 1) / TY, (X + TX - 1) / TX);
  window_knn_best2_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int4*>(table),
      static_cast<const int32_t*>(table) + 4 * NC, NC, RW,
      static_cast<const int32_t*>(offsets), O, X, Y, Z, rx, ry,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

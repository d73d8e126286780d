// The weight gradient of kernel K2 (the packed SubM 3x3x3 convolution, see
// subm_conv.cuh) for Hopper (sm_90a): subm_ext_weight_grad_kernel and its
// deterministic reduce, built as subm_weight_grad.cu.
//
// Replaces the dW half of the XLA VJP through which JAX trains the packed
// encoder: coocc_tpu/ops/conv_acc.py:46 (`_bwd` of `conv_f32acc`), reached
// from coocc_tpu/nn/sparse_enc_packed.py:431-433. The Pallas kernel K2 has
// no backward.
//
// What it computes. The extended weight's gradient on its structurally
// nonzero blocks: for tap (kx, ky), K-block b (16 extended lanes) and output
// column n of b's window,
//   gw[kx, ky, 16b + e, n] = sum over cells (g, x', y') of
//       ext[g, x', y', 16b + e] * dy[g, x'-kx+1, y'-ky+1, n],
// ext read from x with its carries as K2 reads it (one TMA box per pack, a
// carry skipped at a sample's first or last pack; no shifted copy is made),
// dy zero outside the grid (TMA's zero fill). x and each of up to three dy
// parts are bf16 (the wrapper rounds fp32 x to bf16 and splits fp32 dy
// into three bf16 parts whose sum is dy exactly, so every product is
// exact); sums are fp32; the reduce rounds each element once to the
// activations' type.
//
// Bound. The useful FLOP equal the forward's (2.0e12 a flagship step, 2.0
// ms at 989 TFLOP/s); x and dy are read once (4.7 ms of bytes at
// coocc_lidar's 16 calls). So the tensor cores bound it, and the design
// is about keeping them fed.
//
// Design. wgmma m64n96k16, bf16 in, fp32 accumulators, with M = 64
// extended lanes (four K-blocks, one a warp), N = the 3 kx taps of one ky
// over a 32-column window, and K = 16 sites (one row of a 16 x 16 site
// tile).
//   * A = x^T from registers: each warp ldmatrix.trans-es its K-block's
//     x tile row (TMA's 32-byte swizzled box, as K2 lands it). x is not
//     shifted, so one A fragment serves all 9 taps of a row.
//   * B = the tap-shifted dy from shared memory, an MN-major operand with
//     no swizzle. One 5-d TMA box lands the window's 18 x 18 dy halo as
//     [halo row hx][8-column chunk c][halo column hy][8 columns]: a chunk
//     of a halo row is 18 sites of 16 bytes (288 bytes), a halo row 4 of
//     them (1,152). A core matrix (8 columns x 8 sites) is 128 contiguous
//     bytes; the next 8 sites are the next 128 bytes (leading byte
//     offset), the next 8 columns the next chunk, 288 bytes on (stride
//     byte offset). The ky shift is a start address 16 bytes a site
//     further on (any site: no 8-row alignment), and since a halo row is
//     exactly 4 chunks, the next halo row is the next 4 chunks of the
//     same operand: N = 96 covers kx'' = 0, 1, 2 (halo rows r .. r + 2,
//     tap kx = 2 - kx'') with one product, where 32 columns a tap would
//     take three and send A to the tensor cores three times as often.
//   * A warpgroup keeps its window's 9 taps x 64 x 32 fp32 sums in
//     registers (144 a thread) over all the tiles of its split; per tile
//     row it loads one A fragment a warp and issues 3 wgmmas (one a ky),
//     the next row's fragment loading while they run (two buffers, one
//     group in flight); it waits for all at the end of a tile and frees
//     the stage.
//   * A block is a unit of two consumer warpgroups that share what the
//     producer lands: the K-blocks' x tiles (up to 6) and the windows' dy
//     halos (up to 2). One producer thread keeps a ring of 2-3 stages full
//     through mbarrier full/empty pairs; the producer warpgroup hands its
//     registers to the consumers (setmaxnreg, as in K2).
//   * The units (ops/subm_conv.py:dw_units) tile the block-tridiagonal
//     weight by 32-column windows: a window pair with the same K-blocks
//     (p <= 2: every block nonzero) is one unit a run of 4 K-blocks, its
//     two warpgroups on the two windows (one x tile set, all products
//     useful); at p = 8 a unit is two windows whose K-blocks (4 each,
//     6 together) are nonzero bands of two output slots (75% useful); at
//     p = 4 a unit is one window and its 6 K-blocks, 4 and 2 to its
//     warpgroups (75%). A warp whose K-block is a skipped carry, or that
//     has none, multiplies zeros.
//   * Deterministic: the cells split into S ranges of whole tiles by the
//     shapes alone (the wrapper's rule, not the SM count); block (unit,
//     split, part) writes its fp32 sums to a workspace, and the reduce
//     sums them in (part, split) order, rounds, and writes the extended
//     weight's gradient where it is not a structural zero. No atomics.

#pragma once

#include <cstring>

#include "subm_conv_bwd.cuh"

namespace {

constexpr int DW_COLS = 32;                 // a window's output columns
constexpr int DW_CROW = HY * 16;            // 288: a chunk of a halo row
constexpr int DW_HROW = DW_COLS / 8 * DW_CROW;  // 1,152: a halo row
constexpr int DW_WIN = HX * DW_HROW;        // 20,736: a window's halo
constexpr int DW_XTILE = TX * TY * KB * 2;  // 8,192: one K-block's x tile
constexpr int DW_MAX_KB = 6;                // x tiles a unit lands
constexpr int DW_MAX_WIN = 2;               // windows a unit lands
constexpr int DW_MAX_UNITS = 16;
constexpr int DW_MAX_STAGES = 4;
constexpr int DW_MAX_PARTS = 3;
constexpr int DW_ACC = 9 * 64 * DW_COLS;    // a warpgroup's sums
constexpr int DW_SMEM_LIMIT = 231424;       // dynamic shared memory asked
constexpr int DW_ROW = 44;                  // ints of a unit's host row

// A unit: the x tiles (K-blocks) and dy windows its producer lands, and
// what each consumer warpgroup multiplies. Its layout is the host row's.
struct DwUnit {
  int nkb, nwin;
  int col[DW_MAX_WIN];   // each window's first output column
  int win[2];            // each warpgroup's window
  int xs[2][4];          // each (warpgroup, warp)'s x tile, -1: none
  int e[DW_MAX_KB];      // each x tile's extended K-block
  int lane[DW_MAX_KB];   // its lane of x
  int dg[DW_MAX_KB];     // its pack offset (0, +1 up-carry, -1 dn-carry)
  int lo[DW_MAX_KB];     // its output columns [lo, hi): the nonzero ones
  int hi[DW_MAX_KB];
};
static_assert(sizeof(DwUnit) == DW_ROW * sizeof(int), "host row layout");

struct DwTable {
  int n;
  DwUnit u[DW_MAX_UNITS];
};

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, int c4,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];"
      "\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// B operand descriptor: MN-major, no swizzle (CUTLASS's canonical
// ((1,n),(8,k)) : ((X,SBO),(1,LBO)) in 16-byte units): 128 bytes to the
// next 8 sites along K (leading byte offset), a chunk of a halo row, 288
// bytes, to the next 8 columns along N (stride byte offset).
__device__ __forceinline__ uint64_t dw_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(DW_CROW >> 4) << 32);
}

// m64n96k16, A from registers, B MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_n96_mn(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dw_fence_acc(float (&d)[3][48]) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[t][i])::"memory");
}

// The warp's A fragment of x tile row r: x^T, its 16 lanes by the row's
// 16 sites (ldmatrix.trans from TMA's 32-byte swizzled box: lane l gives
// the address of site (l % 8) + 8 (l >= 16), 8-lane chunk (l / 8) % 2);
// zeros for a warp without a K-block or with a skipped carry.
__device__ __forceinline__ void dw_load_a(uint32_t (&a)[4], uint32_t xs,
                                          int r, bool zero, int lane) {
  if (zero) {
    a[0] = a[1] = a[2] = a[3] = 0u;
    return;
  }
  const int site = (lane & 7) + ((lane >> 4) << 3), chunk = (lane >> 3) & 1;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(halo_bf16(xs, r * TY + site, chunk)));
}

// One tile for this warpgroup: per x row r and ky, the products of its A
// fragment with the dy halo rows r .. r + 2 (taps kx = 2, 1, 0), columns
// 2 - ky on: B starts r halo rows and 2 - ky sites in, and the
// descriptor's address field counts 16-byte units (a site of a chunk).
// acc[ky] column 32 kx'' + n is tap (2 - kx'', ky)'s window column n.
// Returns with every wgmma done.
__device__ __forceinline__ void dw_tile(float (&acc)[3][48], uint32_t xs,
                                        uint32_t win, bool zero, int lane) {
  const uint64_t desc = dw_desc(win);
  uint32_t a[2][4];
  dw_load_a(a[0], xs, 0, zero, lane);
#pragma unroll
  for (int r = 0; r < TX; ++r) {
    wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      wgmma_n96_mn(acc[ky], a[r & 1],
                   desc + static_cast<uint64_t>(r * (DW_HROW / 16) + 2 - ky));
    wgmma_commit();
    if (r + 1 < TX) {
      wgmma_wait<1>();   // row r - 1's group read the other buffer
      dw_load_a(a[(r + 1) & 1], xs, r + 1, zero, lane);
    }
  }
  wgmma_wait<0>();
  dw_fence_acc(acc);
}

__device__ __forceinline__ void dw_consume(const DwUnit& un, uint64_t* full,
                                           uint64_t* empty, uint32_t ring,
                                           int xoff, int stages,
                                           int stage_bytes,
                                           float* __restrict__ dst, int G,
                                           int bz, int Y, int t0, int t1,
                                           int warp, int lane) {
  const int wg = warp >> 2, wq = warp & 3;
  const int slot = un.xs[wg][wq];
  const int dg = slot >= 0 ? un.dg[slot] : 0;
  const uint32_t xtile = xoff + (slot >= 0 ? slot : 0) * DW_XTILE;
  const uint32_t win = un.win[wg] * DW_WIN;
  float acc[3][48];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[t][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    const Tile tl = tile_of(t, G, bz, Y);
    const bool zero = slot < 0 || carry_skipped(dg, tl.zp, bz);
    mbar_wait(smem_u32(&full[stage]), phase);
    __syncwarp();  // wgmma wants the warp converged after the spin
    const uint32_t st = ring + stage * stage_bytes;
    dw_tile(acc, st + xtile, st + win, zero, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // accumulator (ky, 4j + q): row 16*wq + lane/4 + 8*(q >> 1) (extended
  // lane e of the warp's K-block), column 8j + 2*(lane%4) + (q & 1) of the
  // product: tap (2 - j/4, ky), window column 8(j%4) + ...; the partial is
  // [9 taps][64 rows][32 columns]
  const int row = 16 * wq + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            dst + ((3 * (2 - j / 4) + ky) * 64 + row + 8 * h) * DW_COLS +
            8 * (j % 4) + c2) =
            make_float2(acc[ky][4 * j + 2 * h], acc[ky][4 * j + 2 * h + 1]);
}

// Per tile: each window's 18 x 18 halo (one box of the 5-d map), then the
// x tile of each K-block that is not a carry skipped at this pack.
__device__ __forceinline__ void dw_produce(const CUtensorMap* xmap,
                                           const CUtensorMap* dymap,
                                           const DwUnit& un, uint64_t* full,
                                           uint64_t* empty, uint32_t ring,
                                           int xoff, int stages,
                                           int stage_bytes, int G, int bz,
                                           int Y, int t0, int t1) {
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    const Tile tl = tile_of(t, G, bz, Y);
    int active = 0;
    for (int k = 0; k < un.nkb; ++k)
      active += !carry_skipped(un.dg[k], tl.zp, bz);
    mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
    const uint32_t st = ring + stage * stage_bytes;
    const uint32_t bar = smem_u32(&full[stage]);
    mbar_expect_tx(bar, un.nwin * DW_WIN + active * DW_XTILE);
    for (int w = 0; w < un.nwin; ++w)
      tma_load_5d(st + w * DW_WIN, dymap, 0, tl.y0 - 1, un.col[w] / 8,
                  tl.x0 - 1, tl.g, bar);
    for (int k = 0; k < un.nkb; ++k) {
      if (carry_skipped(un.dg[k], tl.zp, bz)) continue;
      tma_load_4d(st + xoff + k * DW_XTILE, xmap, un.lane[k], tl.y0, tl.x0,
                  tl.g + un.dg[k], bar);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Block (unit, split, part): each consumer warpgroup sums its window's 9
// taps over the tiles of its split and writes them to its partial.
__global__ void __launch_bounds__(THREADS, 1)
subm_ext_weight_grad_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap dymap0,
                            const __grid_constant__ CUtensorMap dymap1,
                            const __grid_constant__ CUtensorMap dymap2,
                            const __grid_constant__ DwTable tab,
                            float* __restrict__ partials, int G, int bz,
                            int Y, int T, int S, int xoff, int stages,
                            int stage_bytes) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[DW_MAX_STAGES], empty[DW_MAX_STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int u = blockIdx.x, s = blockIdx.y, part = blockIdx.z;
  const DwUnit& un = tab.u[u];
  const int t0 = static_cast<int>(static_cast<long long>(T) * s / S);
  const int t1 = static_cast<int>(static_cast<long long>(T) * (s + 1) / S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * CONSUMER_WARPS)
      dw_produce(&xmap, part == 0 ? &dymap0 : part == 1 ? &dymap1 : &dymap2,
                 un, full, empty, ring, xoff, stages, stage_bytes, G, bz, Y,
                 t0, t1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float* dst = partials +
                 (((static_cast<size_t>(part) * S + s) * tab.n + u) * 2 +
                  (warp >> 2)) *
                     DW_ACC;
    dw_consume(un, full, empty, ring, xoff, stages, stage_bytes, dst, G, bz,
               Y, t0, t1, warp, lane);
  }
}

// v rounded once to the activations' type TO, held in fp32
__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One thread an element of the partials' [unit][warpgroup][tap][row][column]:
// where its K-block is nonzero at its column, the sum of its nsum partials
// in order, rounded once to TO, into the fp32 gw [9, E, N].
template <typename TO>
__global__ void subm_ext_weight_grad_reduce(
    const float* __restrict__ partials, const __grid_constant__ DwTable tab,
    float* __restrict__ gw, int nsum, int E) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= tab.n * 2 * DW_ACC) return;
  const DwUnit& un = tab.u[idx / (2 * DW_ACC)];
  const int wg = idx / DW_ACC % 2, el = idx % DW_ACC;
  const int tap = el / (64 * DW_COLS), row = el / DW_COLS % 64;
  const int slot = un.xs[wg][row / 16];
  if (slot < 0) return;
  const int col = un.col[un.win[wg]] + el % DW_COLS;
  if (col < un.lo[slot] || col >= un.hi[slot]) return;
  const size_t stride = static_cast<size_t>(tab.n) * 2 * DW_ACC;
  float sum = 0.f;
  for (int k = 0; k < nsum; ++k)
    sum = __fadd_rn(sum, partials[k * stride + idx]);
  gw[(static_cast<size_t>(tap) * E + un.e[slot] * KB + row % 16) * N + col] =
      rounded(sum, static_cast<TO*>(nullptr));
}

// The dy halo map: a bf16 [G, X, Y, 128] tensor viewed as 5-d (8 columns,
// Y, 16 chunks of 8 columns, X, G), so that a box of (8, HY, 4, HX, 1)
// lands as [halo row][chunk][halo column][8 columns], out-of-bounds zeros.
int dy_window_map(CUtensorMap* map, const void* base, int G, int X, int Y) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 2;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(Y), N / 8,
                              static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[4] = {row, 16, static_cast<cuuint64_t>(Y) * row,
                                 static_cast<cuuint64_t>(X) * Y * row};
  const cuuint32_t box[5] = {8, HY, DW_COLS / 8, HX, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The host entry of dW. x: bf16 [G, X, Y, pC]; dy: nparts bf16 [G, X, Y,
// 128] tensors whose sum is the cotangent; table: nunits rows of DW_ROW
// ints in DwUnit's layout; S: the splits of the cells (the caller's
// shape-only rule); partials: nparts * S * nunits * 2 * DW_ACC floats; gw:
// fp32 [9, E, 128], each element rounded to TO, zero outside the nonzero
// blocks (the caller zeroes it).
template <typename TO>
int dw_entry(const void* x, const void* const* dy, int nparts,
             const int* table, int nunits, int S, void* partials, void* gw,
             int G, int bz, int X, int Y, int pC, int E, void* stream) {
  if (nparts < 1 || nparts > DW_MAX_PARTS || nunits < 1 ||
      nunits > DW_MAX_UNITS || S < 1 || G % bz || pC % KB || E % KB)
    return static_cast<int>(cudaErrorInvalidValue);
  DwTable tab{};
  tab.n = nunits;
  int max_kb = 0, max_win = 0;
  for (int i = 0; i < nunits; ++i) {
    DwUnit& un = tab.u[i];
    memcpy(&un, table + i * DW_ROW, sizeof(DwUnit));
    bool ok = un.nkb >= 1 && un.nkb <= DW_MAX_KB && un.nwin >= 1 &&
              un.nwin <= DW_MAX_WIN;
    for (int w = 0; ok && w < un.nwin; ++w)
      ok = un.col[w] >= 0 && un.col[w] % 8 == 0 && un.col[w] + DW_COLS <= N;
    for (int g = 0; ok && g < 2; ++g) {
      ok = un.win[g] >= 0 && un.win[g] < un.nwin;
      for (int q = 0; ok && q < 4; ++q)
        ok = un.xs[g][q] >= -1 && un.xs[g][q] < un.nkb;
    }
    for (int k = 0; ok && k < un.nkb; ++k)
      ok = un.e[k] >= 0 && un.e[k] < E / KB && un.lane[k] >= 0 &&
           un.lane[k] + KB <= pC && un.dg[k] >= -1 && un.dg[k] <= 1 &&
           un.lo[k] >= 0 && un.lo[k] < un.hi[k] && un.hi[k] <= N;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    max_kb = un.nkb > max_kb ? un.nkb : max_kb;
    max_win = un.nwin > max_win ? un.nwin : max_win;
  }
  // a stage: the windows' halos, then the x tiles at a 1024-byte offset
  const int xoff = (max_win * DW_WIN + 1023) / 1024 * 1024;
  const int stage_bytes = (xoff + max_kb * DW_XTILE + 1023) / 1024 * 1024;
  int stages = (DW_SMEM_LIMIT - 1024) / stage_bytes;
  if (stages > DW_MAX_STAGES) stages = DW_MAX_STAGES;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_ext_weight_grad_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap xmap, dmap[DW_MAX_PARTS];
  int err = bf16_map(&xmap, x, G, X, Y, pC, TY, TX);
  for (int i = 0; i < DW_MAX_PARTS && !err; ++i)
    err = dy_window_map(&dmap[i], dy[i < nparts ? i : 0], G, X, Y);
  if (err) return err;
  const int T = G * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  subm_ext_weight_grad_kernel<<<dim3(nunits, S, nparts), THREADS,
                                stages * stage_bytes + 1024, s>>>(
      xmap, dmap[0], dmap[1], dmap[2], tab, static_cast<float*>(partials), G,
      bz, Y, T, S, xoff, stages, stage_bytes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int elems = nunits * 2 * DW_ACC;
  subm_ext_weight_grad_reduce<TO><<<(elems + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), tab, static_cast<float*>(gw),
      nparts * S, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

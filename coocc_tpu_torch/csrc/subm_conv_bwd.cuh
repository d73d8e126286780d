// The backward of kernel K2 (the packed SubM 3x3x3 convolution, see
// subm_conv.cuh) for Hopper (sm_90a): two kernels of its own.
//
// Both replace the XLA VJP of the ext conv through which JAX trains the
// packed encoder: coocc_tpu/ops/conv_acc.py:29-58 (`conv_f32acc`, its
// `_bwd` at :46), reached from coocc_tpu/nn/sparse_enc_packed.py:431-433.
// The Pallas kernel K2 has no backward; its gradient is this one.
//
// ---- dX: subm_ext_conv_dx_kernel -----------------------------------------
//
// dx[g, x, y, :] = the SubM conv of the masked cotangent dy [G, X, Y, 128]
// (bf16; the wrapper rounds fp32 dy to bf16 first) with the mirrored taps,
// [G, X, Y, 128] in TO (bf16 or fp32): K2's arithmetic (bf16 products, fp32
// sums, one rounding) without a mask or an epilogue.
//
// Bound. A flagship step's 13 calls need about 2.0e12 useful FLOP (2.0 ms
// at 989 TFLOP/s) and move 6.7e9 bytes; coocc_lidar's 16, 1.9e10 bytes
// (4.7 ms at 3.35 TB/s). What held K2's route back (it launched the forward
// kernel with an all-ones mask) was the copy traffic from L2 into shared
// memory: every 256-site block copied the whole weight panel set (221 KB at
// p = 4, beside a 124 KB halo), 1.1 GB of panels per res1 call for 0.33 GB
// of cotangent read.
//
// Design. At p = 8 and p = 4 (the flagship's and OpenOccupancy's res1,
// coocc_lidar's first two stages: most of the work) the panels stay in
// shared memory. The output lanes split into column groups of W = 16p
// lanes (p = 8: one group of all 128; p = 4: two of 64): every output
// lane is fed by 3C/16 K-blocks (the three lane groups of its slot), so a
// group's panels are 9 taps x 16 rows x W columns x 3C/16 = 110,592
// bytes. Each block owns one group (blockIdx.y), copies its panels once,
// and walks its share of the 16 x 16 site tiles (persistent: blockIdx.x,
// blockIdx.x + gridDim.x, ...), streaming only the halos of the K-blocks
// that feed its group through a 4-stage ring. Per tile it stops copying
// the panels (221 KB at p = 4, 110.6 KB at p = 8) and, at p = 4, the
// halos of the 2 lane groups that do not feed its half. At p <= 2 a
// group of 110,592 bytes would be 32 or 16 lanes wide, and 4 or 8 groups
// would each reread the halos and the A fragments (2.7x the K2 route's
// time at p = 1 on an H100): there one group of all 128 lanes
// streams each K-block's panel beside its halo, as K2 does, still
// persistent and without a mask. The products are K2's: wgmma
// m64n{U}k16, U = min(W, C), A from registers (ldmatrix from the swizzled
// halo at the tap's shifted rows), B from the panel; the producer runs
// ahead into the next tile's halos while the consumers store the last
// one.
//
// ---- dW: subm_ext_weight_grad_kernel + subm_ext_weight_grad_reduce ------
//
// The extended weight's gradient on its structurally nonzero blocks: for
// tap (kx, ky), K-block b (16 extended lanes) and output column n of b's
// window,
//   gw[kx, ky, 16b + e, n] = sum over cells (g, x, y) of
//       ext[g, x+kx-1, y+ky-1, 16b + e] * dy[g, x, y, n]
//                          = sum over cells (g, x', y') of
//       ext[g, x', y', 16b + e] * dy[g, x'-kx+1, y'-ky+1, n],
// ext read from x with its carries as K2 reads it (one TMA box per pack, a
// carry skipped at a sample's first or last pack; no shifted copy is
// made), dy zero outside the grid (TMA's zero fill). x and each of up to
// three dy parts are bf16 (the wrapper rounds fp32 x to bf16 and splits
// fp32 dy into three bf16 parts whose sum is dy exactly, so every product
// is exact); sums are fp32; the reduce rounds each element once to the
// activations' type.
//
// Bound. The useful FLOP equal the forward's (2.0e12 a flagship step);
// x and dy are read once. Moved from PyTorch ops, the `shift_ext` copy
// ([9, 800, 800, 160] bf16 at coocc_lidar's stage 0, 1.84 GB) is gone.
//
// Design. The shifted operand goes to registers: in the second form the
// tap shift falls on dy, whose fragments `ldmatrix.trans` reads at any
// row of its 18 x 18 halo, so the 8-row alignment of a wgmma shared-memory
// operand never arises. mma.sync m16n8k16 takes M = 16 extended lanes
// (one K-block: no row of a product is a structural zero), N = 8 columns,
// K = 16 sites (one tile row). The loop walks dy's halo rows: a row's B
// fragment serves the three kx taps (x rows hx - 2 + kx), so a tile loads
// 70 fragments a warp for 288 products (a fragment per x row and tap would
// be 160, more than shared memory serves beside the products). A block
// (8 warps) owns a unit: two 16-column pieces of the output and up to 4
// K-blocks whose windows meet them; warp w holds the 9 taps of (K-block
// w / 2, piece w % 2) in registers (72 fp32) while the cells stream past
// through a 2-stage TMA ring (the two pieces' dy halos and the K-blocks'
// x tiles, 54 KB a stage; two blocks an SM). Deterministic: the cells
// split into S ranges of 48 whole tiles or fewer, by the shapes alone
// (the wrapper's rule, not the SM count); block (unit, split,
// part) writes its fp32 partial sums to a workspace, and the reduce sums
// them in (part, split) order, rounds, and writes the extended weight's
// gradient. No atomics.

#pragma once

#include "subm_conv.cuh"

namespace {

// ---- dX -----------------------------------------------------------------

constexpr int DX_MAX_GROUPS = 2;
constexpr int DX_MAX_KB = 24;          // K-blocks feeding one group
constexpr int DX_GROUP_PANEL = 9 * KB * 384 * 2;  // 110,592 bytes
constexpr int DX_HALO = 11264;         // >= HX*HY*KB*2, 1024-byte multiple
constexpr int DX_STAGES = 4;
constexpr int DX_SMEM = DX_GROUP_PANEL + DX_STAGES * DX_HALO + 1024;
// streamed panels (p <= 2): a stage holds a halo and one K-block's panel
// (9 taps x 16 rows x at most 128 columns)
constexpr int DX_PANEL_SLOT = 9 * KB * N * 2;          // 36,864
constexpr int DX_STREAM_STAGE = DX_HALO + DX_PANEL_SLOT;
constexpr int DX_STREAM_SMEM = DX_STAGES * DX_STREAM_STAGE + 1024;

template <bool RES>
constexpr int DX_STAGE_BYTES = RES ? DX_HALO : DX_STREAM_STAGE;

// Per group: its K-blocks in panel order, each packed as lane | (dg + 1)
// << 10 | (first unit of its window in the group) << 12 | (units) << 16,
// a unit being U output lanes; `base` is the byte offset of the group's
// panels (ngroups + 1 entries).
struct DxTable {
  int ngroups;
  int nkb[DX_MAX_GROUPS];
  int base[DX_MAX_GROUPS + 1];
  uint32_t e[DX_MAX_GROUPS][DX_MAX_KB];
};

__device__ __forceinline__ int dx_lane(uint32_t e) { return e & 1023; }
__device__ __forceinline__ int dx_dg(uint32_t e) {
  return static_cast<int>((e >> 10) & 3) - 1;
}
__device__ __forceinline__ int dx_lo(uint32_t e) { return (e >> 12) & 15; }
__device__ __forceinline__ int dx_ns(uint32_t e) { return (e >> 16) & 15; }

__device__ __forceinline__ bool carry_skipped(int dg, int zp, int bz) {
  return (dg > 0 && zp == bz - 1) || (dg < 0 && zp == 0);
}

// One K-block of window (lo, ns units of U lanes) in a group of W lanes:
// K2's kblock with the unit width U (p = 8: U = 16, W = 128, the windows
// of K2's Co = 16; p = 4: U = 32, W = 64; p = 2: U = 64, W = 128; p = 1:
// one unit, W = U = 128).
template <int W, int U>
__device__ __forceinline__ void dx_kblock(float (&acc)[2][64], uint32_t halo,
                                          uint32_t panel, int lo, int ns,
                                          int wg, int wq, int lane) {
  if constexpr (W == U) {
    kblock<U, 0, 1>(acc, halo, panel, wg, wq, lane);
  } else if constexpr (W == 2 * U) {
    if (ns == 2) kblock<U, 0, 2>(acc, halo, panel, wg, wq, lane);
    else if (lo == 0) kblock<U, 0, 1>(acc, halo, panel, wg, wq, lane);
    else kblock<U, 1, 1>(acc, halo, panel, wg, wq, lane);
  } else {
    switch (lo * 4 + ns) {
#define DX_CASE(LO, NS)                                                  \
  case LO * 4 + NS:                                                      \
    kblock<U, LO, NS>(acc, halo, panel, wg, wq, lane);                   \
    break;
      DX_CASE(0, 1) DX_CASE(0, 2) DX_CASE(0, 3) DX_CASE(1, 3)
      DX_CASE(2, 3) DX_CASE(3, 3) DX_CASE(4, 3) DX_CASE(5, 3)
      DX_CASE(6, 2) DX_CASE(7, 1)
#undef DX_CASE
    }
  }
}

// Tile t of T: pack row t % G (fastest, as K2), then (x, y) tile t / G.
struct Tile {
  int g, zp, x0, y0;
};

__device__ __forceinline__ Tile tile_of(int t, int G, int bz, int Y) {
  const int ny = (Y + TY - 1) / TY;
  Tile r;
  r.g = t % G;
  r.zp = r.g % bz;
  r.x0 = t / (G * ny) * TX;
  r.y0 = t / G % ny * TY;
  return r;
}

template <typename TO, int W, int U, bool RES>
__device__ __forceinline__ void dx_consume(const DxTable& kt, int gc,
                                           uint64_t* full, uint64_t* empty,
                                           uint64_t* pbar, uint32_t panels,
                                           uint32_t ring, TO* __restrict__ out,
                                           int G, int bz, int X, int Y,
                                           int T, int warp, int lane) {
  const int wg = warp >> 2, wq = warp & 3;
  const int nkb = kt.nkb[gc];
  if (RES) mbar_wait(smem_u32(pbar), 0);
  int stage = 0;
  uint32_t phase = 0;
  float acc[2][64];
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const Tile tl = tile_of(t, G, bz, Y);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    for (int k = 0, woff = 0; k < nkb; ++k) {
      const uint32_t e = kt.e[gc][k];
      const int wbytes = 9 * KB * dx_ns(e) * U * 2;
      woff += wbytes;
      if (carry_skipped(dx_dg(e), tl.zp, bz)) continue;
      mbar_wait(smem_u32(&full[stage]), phase);
      __syncwarp();  // wgmma wants the warp converged after the spin
      const uint32_t st = ring + stage * DX_STAGE_BYTES<RES>;
      dx_kblock<W, U>(acc, st, RES ? panels + woff - wbytes : st + DX_HALO,
                      dx_lo(e), dx_ns(e), wg, wq, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
      if (++stage == DX_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // accumulator (m, 4j + q): site row lane/4 + 8*(q >> 1) of tile row
    // 4*(2*wg + m) + wq, group lane 8j + 2*(lane%4) + (q & 1)
    const int c2 = 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int gx = tl.x0 + 4 * (2 * wg + m) + wq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gy = tl.y0 + (lane >> 2) + 8 * half;
        if (gx >= X || gy >= Y) continue;
        TO* dst = out + ((static_cast<size_t>(tl.g) * X + gx) * Y + gy) * N +
                  gc * W + c2;
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          store2(dst + 8 * j, acc[m][4 * j + 2 * half],
                 acc[m][4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int U, bool RES>
__device__ __forceinline__ void dx_produce(const CUtensorMap* dymap,
                                           const DxTable& kt, int gc,
                                           const __nv_bfloat16* panels,
                                           uint64_t* full, uint64_t* empty,
                                           uint64_t* pbar, uint32_t spanel,
                                           uint32_t ring, int G, int bz,
                                           int Y, int T) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(panels) + kt.base[gc];
  if (RES) {
    // the group's panels, once, in four bulk copies
    const int pbytes = kt.base[gc + 1] - kt.base[gc];
    mbar_expect_tx(smem_u32(pbar), pbytes);
    for (int off = 0; off < pbytes;) {
      const int n = pbytes - off < 27648 ? pbytes - off : 27648;
      bulk_load(spanel + off, src + off, n, smem_u32(pbar));
      off += n;
    }
  }
  const int halo_bytes = HX * HY * KB * 2;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const Tile tl = tile_of(t, G, bz, Y);
    for (int k = 0, woff = 0; k < kt.nkb[gc]; ++k) {
      const uint32_t e = kt.e[gc][k];
      const int dg = dx_dg(e);
      const int wbytes = RES ? 0 : 9 * KB * dx_ns(e) * U * 2;
      woff += wbytes;
      if (carry_skipped(dg, tl.zp, bz)) continue;
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t bar = smem_u32(&full[stage]);
      const uint32_t st = ring + stage * DX_STAGE_BYTES<RES>;
      mbar_expect_tx(bar, halo_bytes + wbytes);
      tma_load_4d(st, dymap, dx_lane(e), tl.y0 - 1, tl.x0 - 1, tl.g + dg,
                  bar);
      if (!RES)
        bulk_load(st + DX_HALO, src + woff - wbytes, wbytes, bar);
      if (++stage == DX_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <typename TO, int W, int U, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
subm_ext_conv_dx_kernel(const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ DxTable kt,
                        const __nv_bfloat16* __restrict__ panels,
                        TO* __restrict__ out, int G, int bz, int X, int Y,
                        int T) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[DX_STAGES], empty[DX_STAGES], pbar[1];
  const uint32_t spanel = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = RES ? spanel + DX_GROUP_PANEL : spanel;
  const int gc = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DX_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
    }
    mbar_init(smem_u32(&pbar[0]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {
    // the producer warpgroup: one thread keeps the ring full; the group
    // hands its registers to the consumers, as in K2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * CONSUMER_WARPS)
      dx_produce<U, RES>(&dymap, kt, gc, panels, full, empty, pbar, spanel,
                         ring, G, bz, Y, T);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dx_consume<TO, W, U, RES>(kt, gc, full, empty, pbar, spanel, ring, out,
                              G, bz, X, Y, T, warp, lane);
  }
}

// A 4-d bf16 tensor map of [G, X, Y, L] with a box of KB lanes x `by` x
// `bx` sites x 1 pack, TMA's 32-byte swizzle, out-of-bounds zeros.
int bf16_map(CUtensorMap* map, const void* base, int G, int X, int Y, int L,
             int by, int bx) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(Y),
                              static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(L) * 2,
                                 static_cast<cuuint64_t>(Y) * L * 2,
                                 static_cast<cuuint64_t>(X) * Y * L * 2};
  const cuuint32_t box[4] = {KB, static_cast<cuuint32_t>(by),
                             static_cast<cuuint32_t>(bx), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename TO, int W, int U, bool RES>
int launch_dx(const CUtensorMap& map, const DxTable& kt, const void* panels,
              void* out, int G, int bz, int X, int Y, cudaStream_t stream) {
  auto kernel = subm_ext_conv_dx_kernel<TO, W, U, RES>;
  constexpr int smem = RES ? DX_SMEM : DX_STREAM_SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int T = G * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  // one resident block an SM, the SMs shared among the groups; which block
  // takes which tile changes no sum (each output is one block's)
  int per_group = sms / kt.ngroups;
  if (per_group < 1) per_group = 1;
  if (per_group > T) per_group = T;
  kernel<<<dim3(per_group, kt.ngroups), THREADS, smem, stream>>>(
      map, kt, static_cast<const __nv_bfloat16*>(panels),
      static_cast<TO*>(out), G, bz, X, Y, T);
  return static_cast<int>(cudaGetLastError());
}

// The host entry of dX with output type TO. table: ngroups x DX_MAX_KB rows
// of (dy lane, pack offset, first output lane in the group, width);
// nkb[ngroups], base[ngroups + 1] (panel byte offsets). dy: bf16 [G, X, Y,
// 128]; p: slots (p >= 4: resident groups of W = 16p lanes; p <= 2: one
// streamed group of all 128).
template <typename TO>
int dx_entry(const void* dy, const void* panels, void* out, const int* table,
             const int* nkb, const int* base, int ngroups, int p, int G,
             int bz, int X, int Y, void* stream) {
  const bool res = p >= 4;
  const int W = res ? 16 * p : N, C = N / p, U = W < C ? W : C;
  if (N % p || ngroups * W != N || ngroups > DX_MAX_GROUPS || G % bz)
    return static_cast<int>(cudaErrorInvalidValue);
  DxTable kt{};
  kt.ngroups = ngroups;
  kt.base[0] = base[0];
  for (int gc = 0; gc < ngroups; ++gc) {
    if (nkb[gc] < 1 || nkb[gc] > DX_MAX_KB ||
        (res && base[gc + 1] - base[gc] > DX_GROUP_PANEL))
      return static_cast<int>(cudaErrorInvalidValue);
    kt.nkb[gc] = nkb[gc];
    kt.base[gc + 1] = base[gc + 1];
    int bytes = 0;
    for (int k = 0; k < nkb[gc]; ++k) {
      const int* r = table + 4 * (gc * DX_MAX_KB + k);
      if (r[0] < 0 || r[0] + KB > N || r[1] < -1 || r[1] > 1 || r[2] % U ||
          r[3] % U || r[3] < U || r[3] > 3 * U || r[2] + r[3] > W)
        return static_cast<int>(cudaErrorInvalidValue);
      kt.e[gc][k] = static_cast<uint32_t>(r[0]) |
                    static_cast<uint32_t>(r[1] + 1) << 10 |
                    static_cast<uint32_t>(r[2] / U) << 12 |
                    static_cast<uint32_t>(r[3] / U) << 16;
      bytes += 9 * KB * r[3] * 2;
    }
    if (bytes != base[gc + 1] - base[gc])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const int err = bf16_map(&map, dy, G, X, Y, N, HY, HX);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 8:
      return launch_dx<TO, 128, 16, true>(map, kt, panels, out, G, bz, X, Y,
                                          s);
    case 4:
      return launch_dx<TO, 64, 32, true>(map, kt, panels, out, G, bz, X, Y,
                                         s);
    case 2:
      return launch_dx<TO, 128, 64, false>(map, kt, panels, out, G, bz, X, Y,
                                           s);
    case 1:
      return launch_dx<TO, 128, 128, false>(map, kt, panels, out, G, bz, X,
                                            Y, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- dW -----------------------------------------------------------------

constexpr int DW_KB = 4;                  // K-blocks of a unit
constexpr int DW_WARPS = 2 * DW_KB;       // a warp per (K-block, piece)
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_MAX_UNITS = 32;
constexpr int DW_MAX_PARTS = 3;
constexpr int DW_PIECE = 16;              // output columns of a piece
constexpr int DW_XTILE = TX * TY * KB * 2;  // 8,192 bytes: one K-block's tile
constexpr int DW_HALO = DX_HALO;          // a piece's 18 x 18 dy halo
constexpr int DW_STAGE = 2 * DW_HALO + DW_KB * DW_XTILE;  // 55,296
constexpr int DW_STAGES = 2;
constexpr int DW_SMEM = DW_STAGES * DW_STAGE + 1024;
constexpr int DW_PAIR = 9 * KB * DW_PIECE;  // floats of one warp's partial

// Per unit: its first piece j0 (it owns pieces j0 and j0 + 1) and its
// K-blocks, each packed as (extended K-block index) | lane << 6 | (dg + 1)
// << 16 | (pieces it meets: bit q for piece j0 + q) << 18.
struct DwTable {
  int n;
  int j0[DW_MAX_UNITS];
  int nkb[DW_MAX_UNITS];
  uint32_t e[DW_MAX_UNITS][DW_KB];
};

__device__ __forceinline__ int dw_index(uint32_t e) { return e & 63; }
__device__ __forceinline__ int dw_lane(uint32_t e) { return (e >> 6) & 1023; }
__device__ __forceinline__ int dw_dg(uint32_t e) {
  return static_cast<int>((e >> 16) & 3) - 1;
}
__device__ __forceinline__ int dw_mask(uint32_t e) { return (e >> 18) & 3; }

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (unit, split, part): warp w sums, over the tiles of its split, the
// 9 taps of (K-block w / 2, piece w % 2) and writes them to its partial.
__global__ void __launch_bounds__(DW_THREADS, 2)
subm_ext_weight_grad_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap dymap0,
                            const __grid_constant__ CUtensorMap dymap1,
                            const __grid_constant__ CUtensorMap dymap2,
                            const __grid_constant__ DwTable tab,
                            float* __restrict__ partials, int G, int bz,
                            int Y, int T, int S) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[DW_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int u = blockIdx.x, s = blockIdx.y, part = blockIdx.z;
  const CUtensorMap* dymap =
      part == 0 ? &dymap0 : part == 1 ? &dymap1 : &dymap2;
  const int nkb = tab.nkb[u], j0 = tab.j0[u];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = warp >> 1, q = warp & 1;
  const uint32_t ent = kb < nkb ? tab.e[u][kb] : 0;
  const bool mine = kb < nkb && (dw_mask(ent) >> q & 1);
  const int dg = dw_dg(ent);
  const int t0 = static_cast<int>(static_cast<long long>(T) * s / S);
  const int t1 = static_cast<int>(static_cast<long long>(T) * (s + 1) / S);
  if (threadIdx.x == 0) {
    for (int i = 0; i < DW_STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the tile's copies: the two pieces' dy halos, then the x tile of each
  // K-block that is not a carry skipped at this pack
  auto load_tile = [&](int t, int stage) {
    const Tile tl = tile_of(t, G, bz, Y);
    const uint32_t st = base + stage * DW_STAGE;
    const uint32_t bar = smem_u32(&full[stage]);
    int active = 0;
    for (int k = 0; k < nkb; ++k)
      active += !carry_skipped(dw_dg(tab.e[u][k]), tl.zp, bz);
    mbar_expect_tx(bar, 2 * HX * HY * KB * 2 + active * DW_XTILE);
    for (int i = 0; i < 2; ++i)
      tma_load_4d(st + i * DW_HALO, dymap, (j0 + i) * DW_PIECE, tl.y0 - 1,
                  tl.x0 - 1, tl.g, bar);
    for (int k = 0; k < nkb; ++k) {
      const uint32_t e = tab.e[u][k];
      if (carry_skipped(dw_dg(e), tl.zp, bz)) continue;
      tma_load_4d(st + 2 * DW_HALO + k * DW_XTILE, &xmap, dw_lane(e), tl.y0,
                  tl.x0, tl.g + dw_dg(e), bar);
    }
  };

  float acc[9][2][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tap][h][i] = 0.f;

  // ldmatrix row addresses: A (x^T) rows are sites r + 8 (lane >= 16),
  // lane chunk (lane / 8) % 2; B (dy) rows are sites r + 8 ((lane / 8) %
  // 2), column chunk lane / 16, with r = lane % 8
  const int r = lane & 7;
  const int a_site = r + ((lane >> 4) << 3), a_chunk = (lane >> 3) & 1;
  const int b_site = r + (((lane >> 3) & 1) << 3), b_chunk = lane >> 4;

  if (threadIdx.x == 0 && t0 < t1) load_tile(t0, 0);
  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int stage = i & 1;
    if (threadIdx.x == 0 && t + 1 < t1) load_tile(t + 1, stage ^ 1);
    mbar_wait(smem_u32(&full[stage]), (i >> 1) & 1);
    const Tile tl = tile_of(t, G, bz, Y);
    if (mine && !carry_skipped(dg, tl.zp, bz)) {
      const uint32_t st = base + stage * DW_STAGE;
      const uint32_t xs = st + 2 * DW_HALO + kb * DW_XTILE;
      const uint32_t ds = st + q * DW_HALO;
      // halo row hx of dy meets x rows xl = hx - 2 + kx, one for each kx:
      // one B fragment a (hx, ky) serves the three kx taps, and the A
      // fragments of the last three x rows stay in registers
      uint32_t a[3][4];
#pragma unroll
      for (int hx = 0; hx < HX; ++hx) {
        if (hx < TX) ldsm_x4_t(a[hx % 3], halo_bf16(xs, hx * TY + a_site,
                                                    a_chunk));
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          uint32_t b[4];
          ldsm_x4_t(b, halo_bf16(ds, hx * HY + b_site + 2 - ky, b_chunk));
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int xl = hx - 2 + kx;
            if (xl < 0 || xl >= TX) continue;
            mma_bf16(acc[3 * kx + ky][0], a[xl % 3], b[0], b[1]);
            mma_bf16(acc[3 * kx + ky][1], a[xl % 3], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copies of tile t + 2
  }

  if (!mine) return;
  // accumulator (tap, h, i): lane e = lane/4 + 8*(i >> 1), column 8h +
  // 2*(lane%4) + (i & 1) of the piece; partial [9][16 e][16 n]
  float* dst = partials +
               ((static_cast<size_t>(part) * S + s) * tab.n + u) * DW_WARPS *
                   DW_PAIR +
               static_cast<size_t>(warp) * DW_PAIR;
  const int e0 = lane >> 2, n0 = 2 * (lane & 3);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        *reinterpret_cast<float2*>(
            dst + (tap * KB + e0 + 4 * i) * DW_PIECE + 8 * h + n0) =
            make_float2(acc[tap][h][i], acc[tap][h][i + 1]);
}

// v rounded once to the activations' type TO, held in fp32
__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One thread an element of the nonzero blocks: the sum of its nsum
// partials in order, rounded once to TO, into the fp32 gw [9, E, N].
template <typename TO>
__global__ void subm_ext_weight_grad_reduce(
    const float* __restrict__ partials, const __grid_constant__ DwTable tab,
    float* __restrict__ gw, int nsum, int E) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_unit = DW_WARPS * DW_PAIR;
  if (idx >= tab.n * per_unit) return;
  const int u = idx / per_unit, w = idx % per_unit / DW_PAIR;
  const int el = idx % DW_PAIR, tap = el / (KB * DW_PIECE);
  const int e = el / DW_PIECE % KB, n = el % DW_PIECE;
  const int kb = w >> 1, q = w & 1;
  if (kb >= tab.nkb[u] || !(dw_mask(tab.e[u][kb]) >> q & 1)) return;
  const size_t stride = static_cast<size_t>(tab.n) * per_unit;
  float sum = 0.f;
  for (int k = 0; k < nsum; ++k)
    sum = __fadd_rn(sum, partials[k * stride + idx]);
  const int row = dw_index(tab.e[u][kb]) * KB + e;
  const int col = (tab.j0[u] + q) * DW_PIECE + n;
  gw[(static_cast<size_t>(tap) * E + row) * N + col] =
      rounded(sum, static_cast<TO*>(nullptr));
}

// The host entry of dW. x: bf16 [G, X, Y, pC]; dy: nparts bf16 [G, X, Y,
// 128] tensors whose sum is the cotangent; table: nunits rows of (j0, nkb,
// then DW_KB K-blocks of (extended K-block index, lane, pack offset, piece
// mask)); S: the splits of the cells (the caller's shape-only rule);
// partials: nparts * S * nunits * DW_WARPS * DW_PAIR floats; gw: fp32 [9,
// (p + 2)C, 128], each element rounded to TO, zero outside the nonzero
// blocks (the caller zeroes it).
template <typename TO>
int dw_entry(const void* x, const void* const* dy, int nparts,
             const int* table, int nunits, int S, void* partials, void* gw,
             int G, int bz, int X, int Y, int pC, int E, void* stream) {
  if (nparts < 1 || nparts > DW_MAX_PARTS || nunits < 1 ||
      nunits > DW_MAX_UNITS || S < 1 || G % bz || pC % KB || E % KB ||
      E / KB > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  DwTable tab{};
  tab.n = nunits;
  for (int u = 0; u < nunits; ++u) {
    const int* row = table + u * (2 + 4 * DW_KB);
    tab.j0[u] = row[0];
    tab.nkb[u] = row[1];
    if (row[0] < 0 || row[0] + 2 > N / DW_PIECE || row[1] < 1 ||
        row[1] > DW_KB)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < row[1]; ++k) {
      const int* kb = row + 2 + 4 * k;
      if (kb[0] < 0 || kb[0] >= E / KB || kb[1] < 0 || kb[1] + KB > pC ||
          kb[2] < -1 || kb[2] > 1 || kb[3] < 1 || kb[3] > 3)
        return static_cast<int>(cudaErrorInvalidValue);
      tab.e[u][k] = static_cast<uint32_t>(kb[0]) |
                    static_cast<uint32_t>(kb[1]) << 6 |
                    static_cast<uint32_t>(kb[2] + 1) << 16 |
                    static_cast<uint32_t>(kb[3]) << 18;
    }
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        subm_ext_weight_grad_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
    // two blocks an SM need the largest shared-memory carveout
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          subm_ext_weight_grad_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap xmap, dmap[DW_MAX_PARTS];
  int err = bf16_map(&xmap, x, G, X, Y, pC, TY, TX);
  for (int i = 0; i < DW_MAX_PARTS && !err; ++i)
    err = bf16_map(&dmap[i], dy[i < nparts ? i : 0], G, X, Y, N, HY, HX);
  if (err) return err;
  const int T = G * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  subm_ext_weight_grad_kernel<<<dim3(nunits, S, nparts), DW_THREADS, DW_SMEM,
                                s>>>(xmap, dmap[0], dmap[1], dmap[2], tab,
                                     static_cast<float*>(partials), G, bz, Y,
                                     T, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int elems = nunits * DW_WARPS * DW_PAIR;
  subm_ext_weight_grad_reduce<TO><<<(elems + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), tab, static_cast<float*>(gw),
      nparts * S, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

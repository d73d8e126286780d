// The backward of kernel K2 (the packed SubM 3x3x3 convolution, see
// subm_conv.cuh) for Hopper (sm_90a): its dX kernel here, its dW kernel
// in subm_conv_dw.cuh.
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
// ---- dW -------------------------------------------------------------------
//
// The weight gradient has a kernel of its own, in subm_conv_dw.cuh (built
// as subm_weight_grad.cu); it uses this header's tiles, carries and tensor
// maps.

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

}  // namespace

// Packed SubM 3x3x3 convolution with cross-pack carries and a fused
// epilogue, for Hopper (sm_90a): kernel K2.
//
// x [G, X, Y, pC] (G = B*bz pack rows, pack g is sample g / bz at z-pack
// g % bz, pC = p*C lanes slot*C + c), out [G, X, Y, N] with N = p*Co = 128:
//
//   conv[g, x, y, n] =
//       sum_{kx, ky, e} ext[g, x+kx-1, y+ky-1, e] * w_ext[3kx+ky, e, n]
//
// where ext[g] = [x[g] (pC lanes) | first C lanes of x[g+1] (up-carry) |
// last C lanes of x[g-1] (dn-carry)], the carries zero at a sample's last
// and first pack, everything zero outside the X x Y grid, and w_ext the
// block-tridiagonal extended weight of the packed encoder. Then, in fp32,
// with m the 0/1 mask of the output lane's cell and the [Co] BatchNorm
// vectors tiled over the p slots (rounded ops in the reference's order):
//   mode 0 (mask):              out = conv*m
//   mode 1 (BN + ReLU):         out = relu(((conv*m - mean)*inv + bias)*m)
//   mode 2 (BN + res + ReLU):   out = relu(((conv*m - mean)*inv + bias)*m
//                                          + identity)*m
// Operands are rounded to bf16 (nearest even), sums are fp32, out has x's
// type (fp32 or bf16).
//
// Replaces the TPU kernel coocc_tpu/ops/pallas/subm_conv.py (_kernel, via
// subm_ext_conv) and the elementwise ops the JAX encoder applies to its
// output (_PackedSubM, _PackedBNCore, _PackedBasicBlock in
// coocc_tpu/nn/sparse_enc_packed.py).
//
// Bound. At the flagship a forward's 13 calls need about 2.0e12 useful FLOP
// (2.0 ms at 989 TFLOP/s bf16) and move about 8.7e9 bytes (2.6 ms at 3.35
// TB/s): fp32 x in, fp32 out, the residual on 6 calls. So bytes bound the
// fused kernel, and the epilogue saves the ~20 ms of separate elementwise
// passes PyTorch would make over the same tensors. What holds it back
// today is the traffic from L2 into shared memory: each block re-reads its
// halo (18 x 18 rows for 16 x 16 sites, the carries' lanes a second time)
// and the weight panels (221 KB per block at res1).
//
// Design. One block owns a 16 x 16 tile of (x, y) sites of one pack row
// (M = 256) and all 128 output lanes; blockIdx.x is the pack row fastest,
// so the blocks of neighbouring packs run together and the carries they
// read from each other come from L2. Warps 0-7 are two consumer warpgroups
// (sites 0-127 and 128-255) and warps 8-11 the producer warpgroup: one
// thread of warp 8 issues the copies, warps 9-11 convert (below);
// setmaxnreg moves the producers' registers to the consumers (232 each:
// 128 accumulators, two A fragment buffers of three taps, addresses),
// without which ptxas serializes the wgmmas. The K loop walks K-blocks of
// 16 input lanes of one lane group (a core slot, the up-carry or the
// dn-carry) through a ring of 3 stages in shared memory guarded by
// mbarriers (full: the copies landed; conv: the bf16 halo is written;
// empty: the 8 consumer warps are done). Per K-block the producer issues
//   * one 4-d TMA load of the 18 x 18 halo of the K-block's 16 lanes, from
//     x viewed as [G, X, Y, pC] at pack g (g+1 for the up-carry, g-1 for
//     the dn-carry) and lane offset `lane`; out-of-bounds rows arrive as
//     zeros, the reference's zero padding at the grid edge. A carry
//     K-block at a sample's last (up) or first (dn) pack contributes zero
//     and is skipped by producer and consumers alike;
//   * one cp.async.bulk of the K-block's weight panel: its 16 rows of the
//     9 taps over its output-column window only. Lane group z feeds output
//     slots max(0, z-1) .. min(p-1, z+1) and nothing else (the extended
//     weight is block-tridiagonal), a window of 1-3 whole slots: the
//     structural zeros (half of res1's products, a quarter of res2's) are
//     never loaded or multiplied. The wrapper packs the panels once per
//     call in the no-swizzle K-major core-matrix layout wgmma reads.
// The consumers issue wgmma.mma_async m64n{Co}k16 per tap and output slot
// of the window, each on that slot's block of their m64n128 fp32
// accumulators, B from the panel through a shared-memory descriptor and A
// from registers; the kernel is instantiated per slot width Co (16, 32,
// 64, 128), so all its products have one shape. Co = 16 (the LiDAR-only
// model's HD encoder, p = 8 slots of 16 channels) takes m64n16k16 on each
// slot's 16 columns: a window of 3 slots is three products per tap, where
// one m64n48k16 would do, but the windows of 1 and 2 slots at the pack's
// ends would then mix widths on one accumulator, which serializes them.
//
// Sizes. The largest input, the HD encoder's stage 0, is [9, 800, 800,
// 128] (737,280,000 elements, 2.95e9 bytes in fp32): element offsets are
// size_t in the epilogue and the L2 prefetch, the TMA map takes 64-bit
// dimensions and strides, and the block count and every coordinate stay
// far inside int.
//
// fp32 input. TMA cannot convert, so the halo lands in x's type. Route (b):
// the three converter warps round each landed fp32 halo (64-byte rows,
// TMA's 64-byte swizzle) to a bf16 halo in TMA's 32-byte swizzled layout,
// the layout a bf16 input lands in directly, and the consumers ldmatrix
// their A fragments from it at the tap's shifted rows. Route (a), the
// consumers loading fp32 pairs and converting in registers (8 shared loads
// and 8 conversions per fragment instead of one ldmatrix), took 8.0 ms per
// flagship forward on an H100 against (b)'s 6.9 (chip_smoke.py). A from
// registers frees the tap shift (ky rows) from the 8-row core-matrix
// alignment a shared-memory A descriptor needs; the swizzle keeps the
// ldmatrix reads free of bank conflicts. A fragment buffers alternate per kx, so one kx's loads overlap
// the previous kx's products.
//
// The epilogue runs on the accumulators in registers and stores once; it
// reads the cell mask (one byte per cell) and, in mode 2, the residual,
// which the producer prefetches to L2 a few K-blocks ahead.

// This header holds the kernel; subm_conv.cu (bf16 activations) and
// subm_conv_f32.cu (fp32) each instantiate it for one type, so that nvcc
// compiles the two halves in parallel.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;                // sites per block along x
constexpr int TY = 16;                // sites per block along y
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int KB = 16;                // input lanes per K-block
constexpr int N = 128;                // output lanes, p*Co
constexpr int CONSUMER_WARPS = 8;     // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + a producer group
constexpr int MAX_KB = 32;            // K-blocks: (p+2)*C/16 <= 32
constexpr int HALO_SLOT = 21504;      // >= HX*HY*KB*4, a multiple of 1024
constexpr int CVT_SLOT = 10752;       // >= HX*HY*KB*2
constexpr int STAGES = 3;
constexpr int CONVERTERS = 96;        // producer threads that convert

// A stage: the halo as TMA wrote it, the weight panel (a window of at most
// 3 slots and 128 columns), and for fp32 input the halo in bf16.
template <typename T, int Co>
struct Ring {
  static constexpr int W_SLOT = 9 * KB * (3 * Co < N ? 3 * Co : N) * 2;
  static constexpr int CVT = sizeof(T) == 4 ? HALO_SLOT + W_SLOT : 0;
  static constexpr int STAGE_BYTES =
      (HALO_SLOT + W_SLOT + (sizeof(T) == 4 ? CVT_SLOT : 0) + 1023) / 1024 *
      1024;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

// The K-blocks in panel order: x lane, pack offset (0, +1, -1), first
// output column, window width, byte offset of the weight panel.
struct KTable {
  int n;
  int lane[MAX_KB], dg[MAX_KB], col0[MAX_KB], width[MAX_KB], woff[MAX_KB];
};

struct Epilogue {
  const uint8_t* mcell;  // [G, X, Y, p]
  const float* mean;     // [Co], modes 1 and 2
  const float* inv;
  const float* bias;
  const void* identity;  // [G, X, Y, N] of x's type, mode 2
  int mode;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, bulk copies ----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keeps the compiler from moving accesses to the accumulators across an
// asynchronous wgmma's issue or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand descriptor: no swizzle, K-major core matrices of 8 columns x
// 16 bytes; 128 bytes to the next 8 rows of K (leading byte offset), 256
// bytes to the next 8 columns (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// m64nWk16, bf16 in, fp32 accumulators d[OFF .. OFF + W/2) (columns
// 2*OFF .. 2*OFF + W of the m64n128 tile), A from registers.
template <int OFF>
__device__ __forceinline__ void wgmma_n16(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int OFF>
__device__ __forceinline__ void wgmma_n32(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int OFF>
__device__ __forceinline__ void wgmma_n64(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int OFF>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int W, int OFF>
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc) {
  if constexpr (W == 16) wgmma_n16<OFF>(d, a, desc);
  if constexpr (W == 32) wgmma_n32<OFF>(d, a, desc);
  if constexpr (W == 64) wgmma_n64<OFF>(d, a, desc);
  if constexpr (W == 128) wgmma_n128<OFF>(d, a, desc);
}

// ---- A fragments from the halo ------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 halo the consumers read A from (converted for fp32 input, as TMA
// wrote it for bf16): rows of 16 lanes (32 bytes), 16-byte chunk c of row
// h stored at chunk c ^ ((h >> 2) & 1), TMA's 32-byte swizzle of the box.
__device__ __forceinline__ uint32_t halo_bf16(uint32_t buf, int h, int c) {
  return buf + h * 32 + ((c ^ ((h >> 2) & 1)) << 4);
}

// The m16k16 A fragment of a warp whose 16 rows start at halo row h0
// (lane l gives the address of row l % 16, lanes 8 .. 15 of the row when
// l >= 16); ldmatrix's 8-row phases hit distinct banks under the swizzle.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], uint32_t buf,
                                       int h0, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(halo_bf16(buf, h0 + (lane & 15), lane >> 4)));
}

// fp32 input: converter thread t of CONVERTERS rounds the TMA'd halo (rows
// of 64 bytes, 16-byte chunk c of row h at chunk c ^ ((h >> 1) & 3), TMA's
// 64-byte swizzle) to bf16 in the layout above, 4 lanes at a time.
__device__ __forceinline__ void convert_halo(uint32_t src, uint32_t dst,
                                             int t) {
  for (int v = t; v < HX * HY * 4; v += CONVERTERS) {
    const int h = v >> 2, c = v & 3;
    float f0, f1, f2, f3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(f0), "=f"(f1), "=f"(f2), "=f"(f3)
                 : "r"(src + h * 64 + ((c ^ ((h >> 1) & 3)) << 4)));
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(
                     halo_bf16(dst, h, c >> 1) + (c & 1) * 8),
                 "r"(pack_bf16(f0, f1)), "r"(pack_bf16(f2, f3))
                 : "memory");
  }
}

// Both row blocks' products with output slots S .. S+NS-1, the panel's
// columns of slot S starting at `cols`.
template <int Co, int S, int NS>
__device__ __forceinline__ void slot_products(float (&acc)[2][64],
                                              const uint32_t (&a)[2][4],
                                              uint32_t cols) {
  const uint64_t desc = b_desc(cols);
  wgmma<Co, S * Co / 2>(acc[0], a[0], desc);
  wgmma<Co, S * Co / 2>(acc[1], a[1], desc);
  if constexpr (NS > 1)
    slot_products<Co, S + 1, NS - 1>(acc, a, cols + Co * 32);
}

// One K-block for this warpgroup: 9 taps x its two m64 row blocks x the
// NS output slots LO .. LO+NS-1 of its window. Each product is one
// m64n{Co}k16 on one slot's block of the accumulators: every wgmma of the
// kernel has one shape, so ptxas keeps them pipelined (products of
// different widths on overlapping accumulator slices made it serialize
// them all, and so does a wgmma group left in flight across K-blocks).
// The taps go in three groups, one per kx: a group's A loads (its 3 taps)
// overlap the previous group's products (two A buffers, at most one group
// in flight). Returns with every wgmma done, so the stage may be released.
template <int Co, int LO, int NS>
__device__ __forceinline__ void kblock(float (&acc)[2][64], uint32_t halo,
                                       uint32_t panel, int wg, int wq,
                                       int lane) {
  uint32_t a[2][3][2][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // warp wq of row block 2*wg + m holds tile row 4*(2*wg + m) + wq
        load_a(a[kx & 1][ky][m], halo,
               (4 * (2 * wg + m) + wq + kx) * HY + ky, lane);
      }
    wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      // the panel's tap rows: NS*Co columns, 256 bytes per 8 of them
      slot_products<Co, LO, NS>(acc, a[kx & 1][ky],
                                panel + (3 * kx + ky) * NS * Co * 32);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// The K-block of window (first slot, slot count) for slot width Co.
template <int Co>
__device__ __forceinline__ void kblock_any(float (&acc)[2][64], uint32_t halo,
                                           uint32_t panel, int lo, int ns,
                                           int wg, int wq, int lane) {
  if constexpr (Co == 128) {
    kblock<Co, 0, 1>(acc, halo, panel, wg, wq, lane);
  } else if constexpr (Co == 64) {
    if (ns == 2) kblock<Co, 0, 2>(acc, halo, panel, wg, wq, lane);
    else if (lo == 0) kblock<Co, 0, 1>(acc, halo, panel, wg, wq, lane);
    else kblock<Co, 1, 1>(acc, halo, panel, wg, wq, lane);
  } else if constexpr (Co == 32) {
#define K2_CASE(LO, NS)                                                  \
  case LO * 4 + NS:                                                      \
    kblock<Co, LO, NS>(acc, halo, panel, wg, wq, lane);               \
    break;
    switch (lo * 4 + ns) {
      // p = 4: the dn-carry, slots 0-3, the up-carry
      K2_CASE(0, 1) K2_CASE(0, 2) K2_CASE(0, 3) K2_CASE(1, 3)
      K2_CASE(2, 2) K2_CASE(3, 1)
    }
  } else {
    switch (lo * 4 + ns) {
      // p = 8: the dn-carry, slots 0-7, the up-carry
      K2_CASE(0, 1) K2_CASE(0, 2) K2_CASE(0, 3) K2_CASE(1, 3)
      K2_CASE(2, 3) K2_CASE(3, 3) K2_CASE(4, 3) K2_CASE(5, 3)
      K2_CASE(6, 2) K2_CASE(7, 1)
    }
#undef K2_CASE
  }
}

// ---- epilogue -----------------------------------------------------------

__device__ __forceinline__ float epilogue1(int mode, float v, float m,
                                           float mean, float inv, float bias,
                                           float id) {
  const float y = __fmul_rn(v, m);
  if (mode == 0) return y;
  const float t =
      __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(y, mean), inv), bias), m);
  if (mode == 1) return fmaxf(t, 0.f);
  return __fmul_rn(fmaxf(__fadd_rn(t, id), 0.f), m);
}

__device__ __forceinline__ float2 load2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// The consumer warpgroups' K loop and epilogue: warpgroup wg owns sites
// 128*wg .. 128*wg + 127 as two m64 row blocks; warp wq of a row block
// holds one tile row of 16 sites.
template <typename T, int Co>
__device__ __forceinline__ void consume(const KTable& kt, const Epilogue& ep,
                                        const float (&s_bn)[3][N],
                                        uint64_t* full, uint64_t* conv,
                                        uint64_t* empty, uint32_t base,
                                        T* __restrict__ out,
                                        int g, int zp, int bz, int x0,
                                        int y0, int X, int Y, int warp,
                                        int lane) {
  const int wg = warp >> 2, wq = warp & 3;
  float acc[2][64];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < kt.n; ++i) {
    const int dg = kt.dg[i];
    if ((dg > 0 && zp == bz - 1) || (dg < 0 && zp == 0)) continue;
    if (sizeof(T) == 4) mbar_wait(smem_u32(&conv[stage]), phase);
    mbar_wait(smem_u32(&full[stage]), phase);
    __syncwarp();  // wgmma wants the warp converged after the spin
    const uint32_t st = base + stage * Ring<T, Co>::STAGE_BYTES;
    kblock_any<Co>(acc, st + Ring<T, Co>::CVT, st + HALO_SLOT,
                   kt.col0[i] / Co, kt.width[i] / Co, wg, wq, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // accumulator (m, 4j + q): site row r = lane/4 + 8*(q >> 1) of tile row
  // 4*(2*wg + m) + wq, output lane 8j + 2*(lane%4) + (q & 1) of slot
  // 8j / Co. A site's residual loads are issued together, ahead of its
  // arithmetic (the producer has prefetched the tile's residual to L2).
  const T* idn = static_cast<const T*>(ep.identity);
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int gx = x0 + 4 * (2 * wg + m) + wq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gy = y0 + (lane >> 2) + 8 * half;
      if (gx >= X || gy >= Y) continue;
      const size_t site = (static_cast<size_t>(g) * X + gx) * Y + gy;
      float mk[N / Co];
#pragma unroll
      for (int s = 0; s < N / Co; ++s)
        mk[s] = ep.mcell[site * (N / Co) + s] ? 1.f : 0.f;
      float2 id[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        id[j] = ep.mode == 2 ? load2f(idn + site * N + 8 * j + c2)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = 8 * j + c2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mean = ep.mode ? s_bn[0][n + e] : 0.f;
          const float inv = ep.mode ? s_bn[1][n + e] : 0.f;
          const float bias = ep.mode ? s_bn[2][n + e] : 0.f;
          v[e] = epilogue1(ep.mode, acc[m][4 * j + 2 * half + e],
                           mk[8 * j / Co], mean, inv, bias,
                           e ? id[j].y : id[j].x);
        }
        store2(out + site * N + n, v[0], v[1]);
      }
    }
  }
}

// The producer's copies for the block's tile: per K-block the halo (TMA)
// and the weight panel (bulk copy) into the next free stage; in mode 2
// also the tile's residual to L2, a few K-blocks before the consumers'
// epilogue reads it.
template <typename T, int Co>
__device__ __forceinline__ void produce(const CUtensorMap* xmap,
                                        const KTable& kt, const Epilogue& ep,
                                        const __nv_bfloat16* panels,
                                        uint64_t* full, uint64_t* empty,
                                        uint32_t base, int g, int zp, int bz,
                                        int x0, int y0, int X, int Y) {
  const int halo_bytes = HX * HY * KB * static_cast<int>(sizeof(T));
  int stage = 0, active = 0, k = 0;
  uint32_t phase = 0;
  for (int i = 0; i < kt.n; ++i)
    active += !((kt.dg[i] > 0 && zp == bz - 1) || (kt.dg[i] < 0 && zp == 0));
  for (int i = 0; i < kt.n; ++i) {
    const int dg = kt.dg[i];
    if ((dg > 0 && zp == bz - 1) || (dg < 0 && zp == 0)) continue;
    if (ep.mode == 2 && k++ == (active > 4 ? active - 4 : 0)) {
      const T* idn = static_cast<const T*>(ep.identity);
      const int rows = Y - y0 < TY ? Y - y0 : TY;
      for (int xr = 0; xr < TX && x0 + xr < X; ++xr)
        prefetch_l2(idn + ((static_cast<size_t>(g) * X + x0 + xr) * Y + y0) *
                              N,
                    rows * N * static_cast<int>(sizeof(T)));
    }
    mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
    const uint32_t st = base + stage * Ring<T, Co>::STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[stage]);
    const uint32_t wbytes = 9 * KB * kt.width[i] * 2;
    mbar_expect_tx(bar, halo_bytes + wbytes);
    tma_load_4d(st, xmap, kt.lane[i], y0 - 1, x0 - 1, g + dg, bar);
    bulk_load(st + HALO_SLOT,
              reinterpret_cast<const uint8_t*>(panels) + kt.woff[i], wbytes,
              bar);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// fp32 input: the converter threads round each stage's halo to bf16 once
// its TMA bytes have landed, and arrive on the stage's conv barrier.
template <typename T, int Co>
__device__ __forceinline__ void convert(const KTable& kt, uint64_t* full,
                                        uint64_t* conv, uint32_t base,
                                        int zp, int bz, int t) {
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < kt.n; ++i) {
    const int dg = kt.dg[i];
    if ((dg > 0 && zp == bz - 1) || (dg < 0 && zp == 0)) continue;
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t st = base + stage * Ring<T, Co>::STAGE_BYTES;
    convert_halo(st, st + Ring<T, Co>::CVT, t);
    mbar_arrive(smem_u32(&conv[stage]));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ---- the kernel ---------------------------------------------------------

template <typename T, int Co>
__global__ void __launch_bounds__(THREADS, 1)
subm_ext_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ KTable kt,
                     const __grid_constant__ Epilogue ep,
                     const __nv_bfloat16* __restrict__ panels,
                     T* __restrict__ out, int G, int bz, int X, int Y) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], conv[STAGES], empty[STAGES];
  __shared__ float s_bn[3][N];           // mean, inv, bias per output lane

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // block t takes pack row t % G (fastest, so the blocks of neighbouring
  // packs run together) of (x, y) tile t / G
  const int ny = (Y + TY - 1) / TY;
  const int g = blockIdx.x % G, zp = g % bz;
  const int x0 = blockIdx.x / (G * ny) * TX, y0 = blockIdx.x / G % ny * TY;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&conv[s]), CONVERTERS);
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ep.mode != 0) {
    const float* vec[3] = {ep.mean, ep.inv, ep.bias};
    for (int i = threadIdx.x; i < 3 * N; i += THREADS)
      s_bn[i / N][i % N] = vec[i / N][(i % N) % Co];
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // producer warpgroup: one thread of its first warp keeps the ring full,
    // its other three warps convert fp32 halos; the group hands registers
    // to the consumers (launched at 168 a thread, 40 here and 232 there)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * CONSUMER_WARPS)
      produce<T, Co>(&xmap, kt, ep, panels, full, empty, base, g, zp, bz, x0,
                     y0, X, Y);
    else if (sizeof(T) == 4 && warp > CONSUMER_WARPS)
      convert<T, Co>(kt, full, conv, base, zp, bz,
                     threadIdx.x - 32 * (CONSUMER_WARPS + 1));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<T, Co>(kt, ep, s_bn, full, conv, empty, base, out, g, zp, bz, x0,
                   y0, X, Y, warp, lane);
  }
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, int Co>
int launch(const void* x, const void* panels, void* out, const KTable& kt,
           const Epilogue& ep, int G, int bz, int X, int Y, int pC,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_ext_conv_kernel<T, Co>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<T, Co>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t esz = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(pC),
                              static_cast<cuuint64_t>(Y),
                              static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[3] = {pC * esz, Y * pC * esz, X * Y * pC * esz};
  const cuuint32_t box[4] = {KB, HY, HX, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(x), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = G * ((Y + TY - 1) / TY) * ((X + TX - 1) / TX);
  subm_ext_conv_kernel<T, Co>
      <<<blocks, THREADS, Ring<T, Co>::SMEM_BYTES, stream>>>(
          map, kt, ep, static_cast<const __nv_bfloat16*>(panels),
          static_cast<T*>(out), G, bz, X, Y);
  return static_cast<int>(cudaGetLastError());
}

// The host entry for activations of type T (see the .cu files).
template <typename T>
int entry(const void* x, const void* w, void* out, int mode,
          const void* mcell, const void* mean, const void* inv,
          const void* bias, const void* identity, const int* ktable, int G,
          int bz, int X, int Y, int pC, int C, int Co, int nkb,
          void* stream) {
  if (C % KB || pC % C || Co * (pC / C) != N || G % bz || nkb < 1 ||
      nkb > MAX_KB || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  KTable kt{};
  kt.n = nkb;
  int woff = 0;
  for (int i = 0; i < nkb; ++i) {
    kt.lane[i] = ktable[4 * i];
    kt.dg[i] = ktable[4 * i + 1];
    kt.col0[i] = ktable[4 * i + 2];
    kt.width[i] = ktable[4 * i + 3];
    kt.woff[i] = woff;
    woff += 9 * KB * kt.width[i] * 2;
    if (kt.col0[i] % Co || kt.width[i] % Co || kt.width[i] < Co ||
        kt.width[i] > 3 * Co || kt.col0[i] + kt.width[i] > N)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue ep{static_cast<const uint8_t*>(mcell),
                    static_cast<const float*>(mean),
                    static_cast<const float*>(inv),
                    static_cast<const float*>(bias), identity, mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Co) {
    case 16: return launch<T, 16>(x, w, out, kt, ep, G, bz, X, Y, pC, s);
    case 32: return launch<T, 32>(x, w, out, kt, ep, G, bz, X, Y, pC, s);
    case 64: return launch<T, 64>(x, w, out, kt, ep, G, bz, X, Y, pC, s);
    case 128: return launch<T, 128>(x, w, out, kt, ep, G, bz, X, Y, pC, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Packed SubM 3x3x3 convolution with cross-pack carries, for Hopper (sm_90a).
//
// x [G, X, Y, pC] (G = B*bz pack rows, pack g is sample g / bz at z-pack
// g % bz), w [9, E, N] bf16 with E = pC + 2C extended input lanes and taps
// kx-major (tap = 3*kx + ky), out [G, X, Y, N]:
//
//   out[g, x, y, n] =
//       sum_{kx, ky, e} ext[g, x+kx-1, y+ky-1, e] * w[3kx+ky, e, n]
//
// where ext[g] = [x[g] (pC lanes) | first C lanes of x[g+1] (up-carry) |
// last C lanes of x[g-1] (dn-carry)], the carries zero at a sample's last
// and first pack, and everything zero outside the X x Y grid. Operands are
// rounded to bf16 (nearest even) on the way into shared memory; sums are
// fp32; out has x's type (fp32 or bf16).
//
// Replaces the TPU kernel coocc_tpu/ops/pallas/subm_conv.py (_kernel, via
// subm_ext_conv). That kernel padded the 2C carry lanes to a 128-lane slab
// in HBM for Mosaic's (8, 128) tiling; here the carries are read straight
// from the neighbouring pack rows while staging.
//
// Bound and design: at the flagship a forward's 13 calls do 3.37 TFLOP and
// move about 7 GB (fp32 in and out), so operations bound it. An implicit
// GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate):
// a block owns an 8 x 16 tile of (x, y) sites of one pack row (M = 128) and
// 128 output lanes (N). It walks the E input lanes in chunks of KC = 32:
// it stages the chunk's (8+2) x (16+2) halo (converted to bf16) and the
// chunk's rows of all 9 taps' weights in shared memory, then each of its 8
// warps (4 along M, 2 along N) runs 9 taps x 2 k-steps of 2 x 8 mma tiles,
// reading A rows of the halo shifted by the tap with ldmatrix. Rows are
// padded by 16 bytes so ldmatrix reads hit distinct banks. No TMA, wgmma or
// pipelining yet: the loads of a chunk do not overlap its products (two
// blocks per SM give some overlap).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 8;                 // sites per block along x
constexpr int TY = 16;                // sites per block along y
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int KC = 32;                // input lanes per staged chunk
constexpr int BN = 128;               // output lanes per block
constexpr int HPAD = KC + 8;          // halo row stride (bf16 elements)
constexpr int WPAD = BN + 8;          // weight row stride (bf16 elements)
constexpr int THREADS = 256;
constexpr int SMEM_W = 9 * KC * WPAD;
constexpr int SMEM_H = HX * HY * HPAD;
constexpr int SMEM_BYTES = (SMEM_W + SMEM_H) * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive lanes of x at `src` as 8 bf16 (16 bytes).
__device__ __forceinline__ uint4 load8(const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src) {
  return *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
subm_ext_conv_kernel(const T* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w, T* __restrict__ out,
                     int G, int bz, int X, int Y, int pC, int C, int N) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* s_w = smem;            // [9][KC][WPAD]
  __nv_bfloat16* s_h = smem + SMEM_W;   // [HX*HY][HPAD]

  const int E = pC + 2 * C;
  const int y0 = blockIdx.x * TY;
  const int x0 = blockIdx.y * TX;
  const int g = blockIdx.z % G;
  const int n0 = (blockIdx.z / G) * BN;
  const int zp = g % bz;
  const bool has_up = zp + 1 < bz;
  const bool has_dn = zp > 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;              // m-tiles: x rows 2*wm, 2*wm + 1
  const int wn = warp >> 2;             // n lanes 64*wn .. 64*wn + 63

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const size_t row_stride = static_cast<size_t>(pC);
  for (int k0 = 0; k0 < E; k0 += KC) {
    // weights of this chunk, all 9 taps: 9 * KC rows of BN lanes
    for (int v = tid; v < 9 * KC * (BN / 8); v += THREADS) {
      const int row = v / (BN / 8);     // tap * KC + r
      const int c8 = v % (BN / 8);
      const int tap = row / KC;
      const int r = row % KC;
      const __nv_bfloat16* src =
          w + (static_cast<size_t>(tap) * E + k0 + r) * N + n0 + c8 * 8;
      cp_async16(smem_addr(s_w + row * WPAD + c8 * 8), src);
    }
    // halo of this chunk, carries resolved, zero outside the grid
    for (int v = tid; v < HX * HY * (KC / 8); v += THREADS) {
      const int hrow = v / (KC / 8);
      const int c8 = v % (KC / 8);
      const int gx = x0 - 1 + hrow / HY;
      const int gy = y0 - 1 + hrow % HY;
      const int e = k0 + c8 * 8;
      int src_g = g, src_c = e;
      bool ok = gx >= 0 && gx < X && gy >= 0 && gy < Y;
      if (e >= pC + C) {                // dn-carry: last C lanes of g - 1
        src_g = g - 1;
        src_c = pC - C + (e - pC - C);
        ok = ok && has_dn;
      } else if (e >= pC) {             // up-carry: first C lanes of g + 1
        src_g = g + 1;
        src_c = e - pC;
        ok = ok && has_up;
      }
      uint4 val = make_uint4(0, 0, 0, 0);
      if (ok)
        val = load8(x + ((static_cast<size_t>(src_g) * X + gx) * Y + gy) *
                            row_stride + src_c);
      *reinterpret_cast<uint4*>(s_h + hrow * HPAD + c8 * 8) = val;
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int kx = tap / 3, ky = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int i = 2 * wm + mt;           // x row of the tile
          const int j = lane & 15;             // y of the A row
          const int hrow = (i + kx) * HY + (j + ky);
          ldmatrix_x4(a[mt], smem_addr(s_h + hrow * HPAD + ks * 16 +
                                       (lane >> 4) * 8));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          const int krow = tap * KC + ks * 16 + (lane & 7) +
                           ((lane >> 3) & 1) * 8;
          const int ncol = wn * 64 + np * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(b, smem_addr(s_w + krow * WPAD + ncol));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8 (y), lanes 2*(lane%4)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gx = x0 + 2 * wm + mt;
    if (gx >= X) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gy = y0 + (lane >> 2) + half * 8;
      if (gy >= Y) continue;
      T* dst = out + ((static_cast<size_t>(g) * X + gx) * Y + gy) * N + n0 +
               wn * 64 + (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store2(dst + nt * 8, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int G, int bz, int X,
           int Y, int pC, int C, int N, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_ext_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Y + TY - 1) / TY, (X + TX - 1) / TX, G * (N / BN));
  subm_ext_conv_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<T*>(out), G, bz, X, Y, pC, C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x and out). Needs C, pC % 8 == 0,
// (pC + 2C) % 32 == 0, N % 128 == 0 and 16-byte aligned pointers; the
// Python wrapper checks them. Returns the launch's CUDA error code.
extern "C" int subm_ext_conv(const void* x, const void* w, void* out,
                             int dtype, int G, int bz, int X, int Y, int pC,
                             int C, int N, void* stream) {
  if (C % 8 || pC % 8 || (pC + 2 * C) % KC || N % BN || G % bz)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, G, bz, X, Y, pC, C, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, G, bz, X, Y, pC, C, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

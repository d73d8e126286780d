// Exact brute-force 2-nearest-neighbour search over masked 3-D keys, for
// Hopper (sm_90a).
//
// For each query q of [Q, 3] fp32, the two nearest keys of [K, 3] fp32 whose
// mask is set, by d2 = (|q|^2 + |k|^2) - 2 q.k in fp32 (masked keys count as
// d2 = 1e30). Keys are taken in tiles of KT = 512: within a tile the best two
// are the two smallest by (d2, index) (argmin, mask, argmin), then merged
// with the best two carried from the earlier tiles by the four-candidate
// rule of the TPU kernel, tile after tile. At the end
//   idx[q, s]  = best index if d2 < thresh2 and the query is valid, else -1
//   dist[q, s] = sqrt(max(d2, 0))   (1e15 where no key was found)
//
// Replaces the TPU kernel coocc_tpu/ops/pallas/knn.py (_knn2_kernel, via
// knn2), whose grid carried the running best-2 in VMEM scratch across the
// sequential key-tile axis and computed the cross term on the MXU. Here the
// key-tile axis is a loop inside the block.
//
// Bound: 8 fp32 operations per (query, key) pair against 12 bytes per point
// read once, so operations bound it (67 TFLOP/s fp32 on the CUDA cores); at
// about 9 instructions a pair the instruction throughput is the practical
// floor.
//
// Design:
// - L = 8 lanes share a query: each scans every L-th key of the tile, in
//   index order with strict '<' (ties to the lower index), and the lanes'
//   best twos are reduced by __shfl_xor_sync on (d2, index) in
//   lexicographic order, which is what argmin, mask, argmin gives. Then
//   every lane merges the tile's best two into the carried best two by the
//   TPU kernel's rule, which is NOT lexicographic across tiles (a carried
//   (4, 5) loses to a new tile's (1, 515), (4, 519)), so tiles stay in
//   order and the key range is never split across blocks.
// - Each thread holds R = 4 queries, so a key read from shared memory
//   serves R pairs; 64 queries a block of 128 threads spread the work over
//   the SMs (829 blocks for the main path's 53,028 queries).
// - The block stages a tile as (2x, 2y, 2z, |k|^2), with |k|^2 = +inf for a
//   masked or padded key: 2q.k then costs no multiply by 2 (exact: scaling
//   by 2 commutes with rounding), and a masked key never wins a strict '<'
//   against 1e30, with no branch and no second load. Two buffers: the next
//   tile's keys are loaded into registers before a tile's scan and staged
//   after it, so a block never waits on device memory at its barrier.
// - A tile's scan starts from the carried second distance instead of 1e30:
//   a key at or above it cannot change the merge's result, so once the
//   carried pair is close most pairs cost a compare and no update, and the
//   update, with selects, runs under one branch per key for all R queries.
// - The products and sums are rounded one by one (__fmul_rn, __fadd_rn: no
//   fused multiply-add), in the order of the plain PyTorch version, so the
//   two agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KT = 512;
constexpr int L = 8;                  // lanes per query
constexpr int R = 4;                  // queries per thread
constexpr int THREADS = 128;
constexpr int QB = THREADS / L * R;   // queries per block
constexpr int PER = KT / THREADS;     // keys a thread stages per tile
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// (da, ia) < (db, ib) in lexicographic order
__device__ __forceinline__ bool lex_lt(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void __launch_bounds__(THREADS)
knn2_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const uint8_t* __restrict__ qmask,
            const uint8_t* __restrict__ kmask, int Q, int K, float thresh2,
            int32_t* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ float4 s_buf[2][KT];

  const int lane = threadIdx.x % L;
  const int group = threadIdx.x / L;
  float qx[R], qy[R], qz[R], qq[R];
  float bd1[R], bd2[R];
  int bi1[R], bi2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = blockIdx.x * QB + r * (THREADS / L) + group;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (qi < Q) {
      qx[r] = q[3 * qi];
      qy[r] = q[3 * qi + 1];
      qz[r] = q[3 * qi + 2];
    }
    qq[r] = sq3(qx[r], qy[r], qz[r]);
    bd1[r] = bd2[r] = BIG;
    bi1[r] = bi2[r] = -1;
  }

  // this thread's share of a key tile, loaded one tile ahead into
  // registers and staged into the other buffer after the tile's scan
  float px[PER], py[PER], pz[PER];
  bool pv[PER];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int g = base + threadIdx.x + u * THREADS;
      pv[u] = g < K && kmask[g];
      px[u] = pv[u] ? k[3 * g] : 0.f;
      py[u] = pv[u] ? k[3 * g + 1] : 0.f;
      pz[u] = pv[u] ? k[3 * g + 2] : 0.f;
    }
  };
  auto stage = [&](float4* s_key) {
#pragma unroll
    for (int u = 0; u < PER; ++u)
      s_key[threadIdx.x + u * THREADS] =
          pv[u] ? make_float4(px[u] + px[u], py[u] + py[u], pz[u] + pz[u],
                              sq3(px[u], py[u], pz[u]))
                : make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
  };
  fetch(0);
  stage(s_buf[0]);
  for (int base = 0, buf = 0; base < K; base += KT, buf ^= 1) {
    __syncthreads();
    const float4* s_key = s_buf[buf];
    if (base + KT < K) fetch(base + KT);

    // tile-local best two of this lane's keys, below the carried second
    // (index 0 with the carried second's value stands for "none")
    float m1[R], m2[R];
    int a1[R], a2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m1[r] = m2[r] = bd2[r];
      a1[r] = a2[r] = 0;
    }
#pragma unroll 4
    for (int j = lane; j < KT; j += L) {
      const float4 kv = s_key[j];
      float d2[R];
      bool hit = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float cross2 = __fadd_rn(
            __fadd_rn(__fmul_rn(qx[r], kv.x), __fmul_rn(qy[r], kv.y)),
            __fmul_rn(qz[r], kv.z));
        d2[r] = __fsub_rn(__fadd_rn(qq[r], kv.w), cross2);
        hit |= d2[r] < m2[r];
      }
      if (hit) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool c1 = d2[r] < m1[r], c2 = d2[r] < m2[r];
          const float hi = c1 ? m1[r] : d2[r];
          const int ihi = c1 ? a1[r] : j;
          m1[r] = c1 ? d2[r] : m1[r];
          a1[r] = c1 ? j : a1[r];
          m2[r] = c2 ? hi : m2[r];
          a2[r] = c2 ? ihi : a2[r];
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      // the lanes' best twos, reduced in (d2, index) order
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float p1 = __shfl_xor_sync(0xffffffffu, m1[r], off);
        const int pi1 = __shfl_xor_sync(0xffffffffu, a1[r], off);
        const float p2 = __shfl_xor_sync(0xffffffffu, m2[r], off);
        const int pi2 = __shfl_xor_sync(0xffffffffu, a2[r], off);
        if (lex_lt(p1, pi1, m1[r], a1[r])) {
          const bool mine = lex_lt(m1[r], a1[r], p2, pi2);
          m2[r] = mine ? m1[r] : p2;
          a2[r] = mine ? a1[r] : pi2;
          m1[r] = p1;
          a1[r] = pi1;
        } else if (lex_lt(p1, pi1, m2[r], a2[r])) {
          m2[r] = p1;
          a2[r] = pi1;
        }
      }
      // a result not below the carried second cannot change the merge:
      // it stands for "none" (1e30 at tile index 0), as in the plain version
      if (!(m1[r] < bd2[r])) { m1[r] = BIG; a1[r] = 0; }
      if (!(m2[r] < bd2[r])) { m2[r] = BIG; a2[r] = 0; }
      const int i1 = base + a1[r], i2 = base + a2[r];

      // merge with the carried best two (coocc_tpu/ops/pallas/knn.py:70-82)
      const bool take_new1 = m1[r] < bd1[r];
      const float nd1 = take_new1 ? m1[r] : bd1[r];
      const int ni1 = take_new1 ? i1 : bi1[r];
      const float other1 = take_new1 ? bd1[r] : m1[r];
      const int oidx1 = take_new1 ? bi1[r] : i1;
      const float cand2d = fminf(m2[r], bd2[r]);
      const int cand2i = m2[r] < bd2[r] ? i2 : bi2[r];
      const bool use_other1 = other1 < cand2d;
      bd1[r] = nd1;
      bi1[r] = ni1;
      bd2[r] = use_other1 ? other1 : cand2d;
      bi2[r] = use_other1 ? oidx1 : cand2i;
    }
    if (base + KT < K) stage(s_buf[buf ^ 1]);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = blockIdx.x * QB + r * (THREADS / L) + group;
      if (qi < Q) {
        const bool qv = qmask[qi] != 0;
        out_idx[2 * qi] = (bd1[r] < thresh2 && qv) ? bi1[r] : -1;
        out_idx[2 * qi + 1] = (bd2[r] < thresh2 && qv) ? bi2[r] : -1;
        out_dist[2 * qi] = sqrtf(fmaxf(bd1[r], 0.f));
        out_dist[2 * qi + 1] = sqrtf(fmaxf(bd2[r], 0.f));
      }
    }
  }
}

}  // namespace

// Returns the launch's CUDA error code.
extern "C" int knn2(const void* q, const void* k, const void* qmask,
                    const void* kmask, int Q, int K, float thresh2,
                    void* out_idx, void* out_dist, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + QB - 1) / QB;
  knn2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const uint8_t*>(qmask), static_cast<const uint8_t*>(kmask),
      Q, K, thresh2, static_cast<int32_t*>(out_idx),
      static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

// Exact brute-force 2-nearest-neighbour search over masked 3-D keys, for
// Hopper (sm_90a).
//
// For each query q of [Q, 3] fp32, the two nearest keys of [K, 3] fp32 whose
// mask is set, by d2 = (|q|^2 + |k|^2) - 2 q.k in fp32 (masked keys count as
// d2 = 1e30). Keys are taken in tiles of KT = 512: within a tile the best two
// by a streaming scan in index order with strict '<' (ties go to the lower
// index), then merged with the best two carried from the earlier tiles by
// the four-candidate rule of the TPU kernel. At the end
//   idx[q, s]  = best index if d2 < thresh2 and the query is valid, else -1
//   dist[q, s] = sqrt(max(d2, 0))   (1e15 where no key was found)
//
// Replaces the TPU kernel coocc_tpu/ops/pallas/knn.py (_knn2_kernel, via
// knn2), whose grid carried the running best-2 in VMEM scratch across the
// sequential key-tile axis and computed the cross term on the MXU. Here the
// key-tile axis is a loop inside the block.
//
// Bound and design: 8 fp32 operations per (query, key) pair against 12
// bytes per point read once, so operations bound it (67 TFLOP/s fp32 on the
// CUDA cores). One thread per query keeps its best two in registers; the
// block stages each key tile in shared memory as (x, y, z, |k|^2) with a
// validity flag, and every thread scans it. The products and sums are
// rounded one by one (no fused multiply-add), in the order of the plain
// PyTorch version, so the two agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KT = 512;
constexpr int THREADS = 256;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

__global__ void __launch_bounds__(THREADS)
knn2_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const uint8_t* __restrict__ qmask,
            const uint8_t* __restrict__ kmask, int Q, int K, float thresh2,
            int32_t* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ float4 s_key[KT];
  __shared__ uint8_t s_valid[KT];

  const int qi = blockIdx.x * THREADS + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  const float qq = sq3(qx, qy, qz);

  float bd1 = BIG, bd2 = BIG;
  int bi1 = -1, bi2 = -1;
  for (int base = 0; base < K; base += KT) {
    const int n = min(KT, K - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float x = k[3 * (base + j)], y = k[3 * (base + j) + 1],
                  z = k[3 * (base + j) + 2];
      s_key[j] = make_float4(x, y, z, sq3(x, y, z));
      s_valid[j] = kmask[base + j];
    }
    __syncthreads();

    // tile-local best two; masked and padded keys (d2 = BIG) never win a
    // strict '<' against the initial BIG, and index 0 stands for "none"
    float m1 = BIG, m2 = BIG;
    int a1 = 0, a2 = 0;
    for (int j = 0; j < n; ++j) {
      if (!s_valid[j]) continue;
      const float4 kv = s_key[j];
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, kv.x), __fmul_rn(qy, kv.y)),
          __fmul_rn(qz, kv.z));
      const float d2 = __fsub_rn(__fadd_rn(qq, kv.w), 2.f * cross);
      if (d2 < m1) {
        m2 = m1;
        a2 = a1;
        m1 = d2;
        a1 = j;
      } else if (d2 < m2) {
        m2 = d2;
        a2 = j;
      }
    }
    const int i1 = base + a1, i2 = base + a2;

    // merge with the carried best two (coocc_tpu/ops/pallas/knn.py:70-82)
    const bool take_new1 = m1 < bd1;
    const float nd1 = take_new1 ? m1 : bd1;
    const int ni1 = take_new1 ? i1 : bi1;
    const float other1 = take_new1 ? bd1 : m1;
    const int oidx1 = take_new1 ? bi1 : i1;
    const float cand2d = fminf(m2, bd2);
    const int cand2i = m2 < bd2 ? i2 : bi2;
    const bool use_other1 = other1 < cand2d;
    bd1 = nd1;
    bi1 = ni1;
    bd2 = use_other1 ? other1 : cand2d;
    bi2 = use_other1 ? oidx1 : cand2i;
  }

  if (qi < Q) {
    const bool qv = qmask[qi] != 0;
    out_idx[2 * qi] = (bd1 < thresh2 && qv) ? bi1 : -1;
    out_idx[2 * qi + 1] = (bd2 < thresh2 && qv) ? bi2 : -1;
    out_dist[2 * qi] = sqrtf(fmaxf(bd1, 0.f));
    out_dist[2 * qi + 1] = sqrtf(fmaxf(bd2, 0.f));
  }
}

}  // namespace

// Returns the launch's CUDA error code.
extern "C" int knn2(const void* q, const void* k, const void* qmask,
                    const void* kmask, int Q, int K, float thresh2,
                    void* out_idx, void* out_dist, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + THREADS - 1) / THREADS;
  knn2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const uint8_t*>(qmask), static_cast<const uint8_t*>(kmask),
      Q, K, thresh2, static_cast<int32_t*>(out_idx),
      static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

// Native host-side preprocessing kernels for the coocc_tpu data pipeline.
//
// TPU-native replacement for the reference's CPU numba kernels
// (nb_process_label majority vote, loading.py:433-448; nb_process_img_points
// z-buffer, loading.py:396-411) and the python z-buffer loop in
// CreateDepthFromLiDAR (lidar2depth.py:64-84). These run per-sample on the
// host while the TPU computes; C++ keeps the input pipeline off the
// training critical path at 10+ Hz.
//
// Exposed as a plain C ABI consumed via ctypes (coocc_tpu/utils/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Z-buffer depth-map fill: for each projected point (u, v, d), keep the
// smallest positive depth per integer pixel. Points must be pre-projected;
// u/v are rounded here. depth_out has shape [H, W], zero-initialized by the
// caller semantics (we overwrite unconditionally).
void zbuffer_depth(const float* uvd, int64_t n_points, int64_t img_h,
                   int64_t img_w, float* depth_out) {
  std::memset(depth_out, 0, sizeof(float) * img_h * img_w);
  for (int64_t i = 0; i < n_points; ++i) {
    const float u = uvd[i * 3 + 0];
    const float v = uvd[i * 3 + 1];
    const float d = uvd[i * 3 + 2];
    if (d <= 0.f) continue;
    if (u < 0.f || v < 0.f || u > img_w - 1 || v > img_h - 1) continue;
    const int64_t ui = (int64_t)(u + 0.5f);
    const int64_t vi = (int64_t)(v + 0.5f);
    float& slot = depth_out[vi * img_w + ui];
    if (slot == 0.f || d < slot) slot = d;
  }
}

// Majority-vote label voxelization: sparse (voxel_index, label) pairs ->
// dense label grid. Ties resolve to the smallest label (torch.mode parity).
// coords: [n, 3] int64 (x, y, z); labels: [n] int64; grid [X*Y*Z] int64
// zero-initialized by caller.
void majority_vote(const int64_t* coords, const int64_t* labels,
                   int64_t n, int64_t X, int64_t Y, int64_t Z,
                   int64_t* grid) {
  std::unordered_map<int64_t, std::unordered_map<int64_t, int64_t>> counts;
  counts.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = coords[i * 3], y = coords[i * 3 + 1],
                  z = coords[i * 3 + 2];
    if (x < 0 || y < 0 || z < 0 || x >= X || y >= Y || z >= Z) continue;
    const int64_t lid = (x * Y + y) * Z + z;
    counts[lid][labels[i]] += 1;
  }
  for (const auto& kv : counts) {
    int64_t best_label = 0, best_count = -1;
    for (const auto& lc : kv.second) {
      if (lc.second > best_count ||
          (lc.second == best_count && lc.first < best_label)) {
        best_label = lc.first;
        best_count = lc.second;
      }
    }
    grid[kv.first] = best_label;
  }
}

// Hard voxelization (host-side oracle / tools path): mean of the first
// `max_points` points per voxel, voxels in first-appearance order capped at
// `max_voxels`. Returns the number of voxels written.
int64_t voxelize_mean(const float* points, int64_t n_points, int64_t n_feat,
                      const float* pc_range,  // [6]
                      const float* voxel_size, // [3]
                      int64_t nx, int64_t ny, int64_t nz,
                      int64_t max_points, int64_t max_voxels,
                      int64_t* out_ids, float* out_feats) {
  std::unordered_map<int64_t, int64_t> slot_of;
  slot_of.reserve(max_voxels * 2);
  std::vector<int64_t> count(max_voxels, 0);
  std::memset(out_feats, 0, sizeof(float) * max_voxels * n_feat);
  int64_t n_vox = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    const float* p = points + i * n_feat;
    int64_t c[3];
    bool ok = true;
    for (int a = 0; a < 3; ++a) {
      const float f = (p[a] - pc_range[a]) / voxel_size[a];
      c[a] = (int64_t)std::floor(f);
    }
    if (c[0] < 0 || c[1] < 0 || c[2] < 0 || c[0] >= nx || c[1] >= ny ||
        c[2] >= nz)
      ok = false;
    if (!ok) continue;
    const int64_t lid = (c[0] * ny + c[1]) * nz + c[2];
    auto it = slot_of.find(lid);
    int64_t slot;
    if (it == slot_of.end()) {
      if (n_vox >= max_voxels) continue;
      slot = n_vox++;
      slot_of.emplace(lid, slot);
      out_ids[slot] = lid;
    } else {
      slot = it->second;
    }
    if (count[slot] >= max_points) continue;
    for (int64_t f = 0; f < n_feat; ++f) out_feats[slot * n_feat + f] += p[f];
    count[slot] += 1;
  }
  for (int64_t s = 0; s < n_vox; ++s) {
    const float inv = count[s] > 0 ? 1.f / (float)count[s] : 0.f;
    for (int64_t f = 0; f < n_feat; ++f) out_feats[s * n_feat + f] *= inv;
  }
  return n_vox;
}

}  // extern "C"

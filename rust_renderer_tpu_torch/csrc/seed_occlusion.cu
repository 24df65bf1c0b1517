// The seed test: per ray, whether one of the triangles of the k largest-area
// leaf rows occludes it, one thread per ray.
//
// The port of rust_renderer_tpu/ops/bvh.py::make_seed_test (:843-911). That
// function has no Pallas kernel: it is a chain of per-triangle tensor
// operations that XLA fused into one pass. Eager PyTorch would launch each of
// them (about 35 per triangle, 48 triangles), so the port fuses them here.
// The seed rows come as rows of the leaf table (ops/bvh.py: 12 slots of
// [v0, e1, e2], then 12 triangle ids as int32 bits, -1 = empty slot); a ray
// tests the live slots in row and slot order and stops at the first that
// occludes it, since the verdict is an OR. Each test is the JAX package's
// Moller-Trumbore in its operation order (built with -fmad=false), with t in
// (t_min, t_max): the same arithmetic as trv::leaf_test, but against t_max
// itself rather than a running best.
//
// What bounds it on an H100: operations (about 52 f32 operations per ray and
// triangle, against 33 bytes of rays, limits and verdict per ray); the seed
// rows (at most 4 x 480 bytes) are read by every thread and stay in L1.

#include "traverse_common.cuh"

namespace {

__global__ void __launch_bounds__(TRV_THREADS)
seed_occlusion_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_min_in,
                      const float* __restrict__ t_max_in,
                      const float* __restrict__ rows, int n_rows, int n_rays,
                      bool* __restrict__ occluded) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = origin[3 * i + 0], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i + 0], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  const float t_min = t_min_in[i], t_max = t_max_in[i];
  bool occ = false;
  for (int row = 0; row < n_rows && !occ; ++row) {
    const float* lrow = rows + static_cast<int64_t>(row) * TRV_LEAF_COLS;
    const int* ids = reinterpret_cast<const int*>(lrow + 9 * TRV_LEAF_SLOTS);
    for (int s = 0; s < TRV_LEAF_SLOTS; ++s) {
      if (__ldg(ids + s) < 0) continue;
      const float* q = lrow + 9 * s;
      const float v0x = __ldg(q + 0), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
      const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
      const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      if (!(fabsf(det) > 1e-12f)) continue;
      const float inv = 1.0f / det;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * px + tvy * py + tvz * pz) * inv;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_max) {
        occ = true;
        break;
      }
    }
  }
  occluded[i] = occ;
}

}  // namespace

// rows: (n_rows, 120) f32 seed rows of the leaf table; occluded: (n_rays,)
// bool.
extern "C" int seed_occlusion(const float* origin, const float* direction,
                              const float* t_min, const float* t_max,
                              const float* rows, int n_rows, int n_rays,
                              bool* occluded, void* stream) {
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  seed_occlusion_kernel<<<blocks, TRV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_min, t_max, rows, n_rows, n_rays, occluded);
  return static_cast<int>(cudaGetLastError());
}

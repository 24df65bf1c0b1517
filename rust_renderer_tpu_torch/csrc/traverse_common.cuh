// What the traversal kernels share: the ray, the running best hit, and the
// test of one 12-slot leaf row (ops/bvh.py: 12 slots of [v0, e1, e2], then
// 12 triangle ids as int32 bits, -1 = empty slot).
//
// Arithmetic follows the JAX package's reference order op by op; the
// kernels are built with -fmad=false so that no multiply-add is contracted
// and a walk matches the plain PyTorch walk on the same inputs.

#pragma once

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#define TRV_WIDTH 16
#define TRV_NODE_COLS 112
#define TRV_LEAF_SLOTS 12
#define TRV_LEAF_COLS 120
#define TRV_THREADS 128
#define TRV_WIDE_EMPTY (-0x7FFFFFFF)
#define TRV_INF 3.0e38f

namespace trv {

__device__ __forceinline__ float safe_inv(float a) {
  const float s = fabsf(a) < 1e-12f ? (a < 0.0f ? -1e-12f : 1e-12f) : a;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min;
};

struct Best {
  float t, u, v;
  int prim;
};

// Loads ray i; false for a degenerate (zero-length) ray, which hits nothing.
__device__ __forceinline__ bool load_ray(const float* __restrict__ origin,
                                         const float* __restrict__ direction,
                                         const float* __restrict__ t_min_in,
                                         const float* __restrict__ t_max_in,
                                         int64_t i, Ray& r, Best& best) {
  r.ox = origin[3 * i + 0];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i + 0];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  r.t_min = t_min_in[i];
  best.t = fminf(TRV_INF, t_max_in[i]);
  best.u = 0.0f;
  best.v = 0.0f;
  best.prim = -1;
  if ((r.dx * r.dx + r.dy * r.dy + r.dz * r.dz) < 1e-12f) return false;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return true;
}

__device__ __forceinline__ void store_hit(int64_t i, const Best& best,
                                          bool any_hit, float* __restrict__ t_out,
                                          int* __restrict__ prim_out,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out) {
  const bool hit = best.prim >= 0;
  t_out[i] = hit ? best.t : TRV_INF;
  prim_out[i] = (hit && any_hit) ? 0 : best.prim;
  u_out[i] = best.u;
  v_out[i] = best.v;
}

// Slab test of the box [lo, hi] (the JAX order: (plane - o) * inv, per-axis
// min / max, then the largest near and the smallest far). Returns whether
// the box is hit in [t_min, best_t]; tnear is this ray's entry distance.
__device__ __forceinline__ bool slab(const Ray& r, float lox, float loy,
                                     float loz, float hix, float hiy, float hiz,
                                     float best_t, float& tnear) {
  const float tx0 = (lox - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz;
  const float tx1 = (hix - r.ox) * r.ix;
  const float ty1 = (hiy - r.oy) * r.iy;
  const float tz1 = (hiz - r.oz) * r.iz;
  tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tfar >= fmaxf(tnear, r.t_min) && tnear <= best_t;
}

// Slab test of child c of a wide row (column 16k + c holds plane k).
__device__ __forceinline__ bool wide_child_hit(const float* __restrict__ row,
                                               int c, const Ray& r,
                                               float best_t, float& tnear) {
  return slab(r, __ldg(row + c), __ldg(row + TRV_WIDTH + c),
              __ldg(row + 2 * TRV_WIDTH + c), __ldg(row + 3 * TRV_WIDTH + c),
              __ldg(row + 4 * TRV_WIDTH + c), __ldg(row + 5 * TRV_WIDTH + c),
              best_t, tnear);
}

// Tests the 12 slots of one leaf row in order; a slot wins only if strictly
// nearer than the best so far, so the earlier slot keeps a tie. Returns true
// when some slot hit (with any_hit, at the first). `tests`, where not null,
// counts the triangles tested (the non-empty slots reached).
__device__ __forceinline__ bool leaf_test(const float* __restrict__ lrow,
                                          const Ray& r, Best& best,
                                          bool any_hit, int* tests = nullptr) {
  const int* ids = reinterpret_cast<const int*>(lrow + 9 * TRV_LEAF_SLOTS);
  bool found = false;
#pragma unroll
  for (int s = 0; s < TRV_LEAF_SLOTS; ++s) {
    const int tri = __ldg(ids + s);
    if (tri < 0) continue;
    if (tests != nullptr) ++*tests;
    const float* q = lrow + 9 * s;
    const float v0x = __ldg(q + 0), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
    const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
    const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    if (!(fabsf(det) > 1e-12f)) continue;
    const float inv_det = 1.0f / det;
    const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.t_min && t < best.t) {
      best.t = t;
      best.u = u;
      best.v = v;
      best.prim = tri;
      found = true;
      if (any_hit) return true;
    }
  }
  return found;
}

// Component c (a constant once unrolled) of a 16-byte vector.
__device__ __forceinline__ float lane4(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}
__device__ __forceinline__ int lane4(const int4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// leaf_test over a row read with 16-byte loads through the read-only path:
// its ids as 3 int4, then for each group of 4 slots with a live one, the
// group's 36 floats as 9 float4 (30 loads for a full row). The same tests in
// the same order. Rows are 480 bytes, so a 16-byte-aligned table keeps every
// row aligned. kCount adds the live slots reached to *tests (K1's stats form);
// without it the form compiles as it did before the counter existed.
template <bool kCount = false>
__device__ __forceinline__ bool leaf_test_v4(const float* __restrict__ lrow,
                                             const Ray& r, Best& best,
                                             bool any_hit, int* tests = nullptr) {
  const float4* geo = reinterpret_cast<const float4*>(lrow);
  const int4* ids4 = reinterpret_cast<const int4*>(lrow + 9 * TRV_LEAF_SLOTS);
  bool found = false;
#pragma unroll
  for (int g = 0; g < TRV_LEAF_SLOTS / 4; ++g) {
    const int4 ids = __ldg(ids4 + g);
    if (ids.x < 0 && ids.y < 0 && ids.z < 0 && ids.w < 0) continue;
    float f[36];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float4 x = __ldg(geo + 9 * g + k);
      f[4 * k] = x.x;
      f[4 * k + 1] = x.y;
      f[4 * k + 2] = x.z;
      f[4 * k + 3] = x.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int tri = lane4(ids, s);
      if (tri < 0) continue;
      if (kCount) ++*tests;
      // leaf_test's arithmetic, op for op, kept apart from it: one shared
      // helper changed the other kernels' generated code and slowed them by
      // up to 18% on an H100.
      const float* q = f + 9 * s;
      const float v0x = q[0], v0y = q[1], v0z = q[2];
      const float e1x = q[3], e1y = q[4], e1z = q[5];
      const float e2x = q[6], e2y = q[7], e2z = q[8];
      const float px = r.dy * e2z - r.dz * e2y;
      const float py = r.dz * e2x - r.dx * e2z;
      const float pz = r.dx * e2y - r.dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      if (!(fabsf(det) > 1e-12f)) continue;
      const float inv_det = 1.0f / det;
      const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
      const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.t_min && t < best.t) {
        best.t = t;
        best.u = u;
        best.v = v;
        best.prim = tri;
        found = true;
        if (any_hit) return true;
      }
    }
  }
  return found;
}

// Children 4g .. 4g + 3 of a wide row as 16-byte loads through the
// read-only path: plane k (min.xyz, max.xyz) of the four in p[k], then their
// refs. A row is 448 bytes, so a 16-byte-aligned table keeps every row
// aligned; a node is 28 loads.
struct WideGroup {
  float4 p[6];
  int4 ref;
};

__device__ __forceinline__ WideGroup load_wide_group(const float* __restrict__ row,
                                                     int g) {
  WideGroup w;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    w.p[k] = __ldg(reinterpret_cast<const float4*>(row + TRV_WIDTH * k) + g);
  }
  w.ref = __ldg(reinterpret_cast<const int4*>(row + 6 * TRV_WIDTH) + g);
  return w;
}

__device__ __forceinline__ const float* leaf_row(const float* __restrict__ leaf,
                                                 int64_t row) {
  return leaf + row * TRV_LEAF_COLS;
}

}  // namespace trv

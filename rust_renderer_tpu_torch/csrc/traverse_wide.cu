// K1: closest-hit / any-hit traversal of the width-16 BVH, one thread per ray.
//
// Replaces the TPU kernel rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_row (launched by _run / traverse_packet_pallas). Same
// contract: per ray, the nearest Moller-Trumbore hit in (t_min, min(INF,
// t_max)) as (t, prim, u, v), t = INF (3.0e38) and prim = -1 on a miss; with
// any_hit the walk stops at the first hit and reports prim = 0.
//
// Tables (ops/bvh.py):
//   wnode (W, 112) f32: column 16k + c (k < 6) is child c's min.xyz, max.xyz;
//     column 96 + c is its ref (int32 bits): >= 0 a wide node, <= -2 leaf row
//     -(ref + 2), WIDE_EMPTY an empty slot.
//   leaf (L, 120) f32: 12 slots of [v0, e1, e2], then 12 triangle ids (int32
//     bits, -1 = empty slot).
//
// What bounds it on an H100: dependent loads. Every step reads one 448-byte
// node row or one 480-byte leaf row whose address came from the previous
// step, so a ray's walk is a chain of memory latencies. The tables of the
// default scene are about 2 MB and stay in the 50 MB L2, so each link costs
// an L2 hit, not a trip to HBM. The design keeps that chain short and wide:
// a width-16 node tests 16 child boxes per load (a shallow tree), leaves
// hold 12 triangles tested inline without a stack push, rows are read
// through the read-only path, and 128-thread blocks keep many rays' chains
// in flight per SM to hide the latency. The stack lives in local memory
// (L1-cached). Warp-level packets, ray sorting, TMA and wgmma are left to
// later work.
//
// Arithmetic follows the JAX package's reference order op by op; build with
// -fmad=false so no multiply-add is contracted and results match the plain
// PyTorch walk on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_WIDTH 16
#define K1_NODE_COLS 112
#define K1_LEAF_SLOTS 12
#define K1_LEAF_COLS 120
#define K1_STACK_CAP 256  // ops/traversal.py K1_STACK_CAP
#define K1_THREADS 128
#define K1_WIDE_EMPTY (-0x7FFFFFFF)
#define K1_INF 3.0e38f

namespace {

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

// Tests the 12 slots of one leaf row in order; a slot wins only if strictly
// nearer than the best so far, so the earlier slot keeps a tie. Returns true
// when some slot hit.
__device__ __forceinline__ bool leaf_test(const float* __restrict__ lrow,
                                          const Ray& r, Best& best,
                                          bool any_hit) {
  const int* ids = reinterpret_cast<const int*>(lrow + 9 * K1_LEAF_SLOTS);
  bool found = false;
#pragma unroll
  for (int s = 0; s < K1_LEAF_SLOTS; ++s) {
    const int tri = __ldg(ids + s);
    if (tri < 0) continue;
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

__global__ void __launch_bounds__(K1_THREADS)
k1_traverse_wide_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_min_in,
                        const float* __restrict__ t_max_in,
                        const float* __restrict__ wnode,
                        const float* __restrict__ leaf, int n_rays, int any_hit,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = origin[3 * i + 0];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i + 0];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  r.t_min = t_min_in[i];
  Best best;
  best.t = fminf(K1_INF, t_max_in[i]);
  best.u = 0.0f;
  best.v = 0.0f;
  best.prim = -1;

  // Degenerate (zero-length) rays hit nothing: dead path lanes retire here.
  const bool degenerate = (r.dx * r.dx + r.dy * r.dy + r.dz * r.dz) < 1e-12f;
  if (!degenerate) {
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    int stack[K1_STACK_CAP];
    int sp = 0;
    stack[sp++] = 0;
    bool done = false;
    while (sp > 0 && !done) {
      const float* row = wnode + static_cast<size_t>(stack[--sp]) * K1_NODE_COLS;
      const int* refs = reinterpret_cast<const int*>(row + 6 * K1_WIDTH);
      for (int c = 0; c < K1_WIDTH; ++c) {
        const int ref = __ldg(refs + c);
        if (ref == K1_WIDE_EMPTY) continue;
        const float tx0 = (__ldg(row + c) - r.ox) * r.ix;
        const float ty0 = (__ldg(row + K1_WIDTH + c) - r.oy) * r.iy;
        const float tz0 = (__ldg(row + 2 * K1_WIDTH + c) - r.oz) * r.iz;
        const float tx1 = (__ldg(row + 3 * K1_WIDTH + c) - r.ox) * r.ix;
        const float ty1 = (__ldg(row + 4 * K1_WIDTH + c) - r.oy) * r.iy;
        const float tz1 = (__ldg(row + 5 * K1_WIDTH + c) - r.oz) * r.iz;
        const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                  fminf(tz0, tz1));
        const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fmaxf(tz0, tz1));
        if (!(tfar >= fmaxf(tnear, r.t_min) && tnear <= best.t)) continue;
        if (ref >= 0) {
          stack[sp++] = ref;  // the wrapper sizes K1_STACK_CAP for the tree
        } else if (leaf_test(leaf + static_cast<size_t>(-(ref + 2)) * K1_LEAF_COLS,
                             r, best, any_hit) &&
                   any_hit) {
          done = true;
          break;
        }
      }
    }
  }
  const bool hit = best.prim >= 0;
  t_out[i] = hit ? best.t : K1_INF;
  prim_out[i] = (hit && any_hit) ? 0 : best.prim;
  u_out[i] = best.u;
  v_out[i] = best.v;
}

}  // namespace

extern "C" int k1_traverse_wide(const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const float* wnode, const float* leaf,
                                int n_rays, int any_hit, float* t_out,
                                int* prim_out, float* u_out, float* v_out,
                                void* stream) {
  const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;
  k1_traverse_wide_kernel<<<blocks, K1_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, t_out,
      prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

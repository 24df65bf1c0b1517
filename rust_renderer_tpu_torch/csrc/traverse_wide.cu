// K1 and the wide forms of K3: closest-hit / any-hit traversal of the
// width-16 BVH, one thread per ray.
//
// K1 replaces the TPU kernel rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_row (launched by _run / traverse_packet_pallas). Same
// contract: per ray, the nearest Moller-Trumbore hit in (t_min, min(INF,
// t_max)) as (t, prim, u, v), t = INF (3.0e38) and prim = -1 on a miss; with
// any_hit the walk stops at the first hit and reports prim = 0.
//
// K3 (wide) replaces _make_kernel_wide (:403, with its stats output) and
// _make_kernel_wide_dual (:2080) under the same contract. As there, leaf
// children are pushed on the stack (as refs <= -2) and tested when popped;
// compile-time forms:
//   ordered: the hit children are pushed far to near by this ray's own tnear
//     (the per-ray form of the packet's sorting network, :568-582);
//   dual: two entries are popped per iteration and expanded in turn, B's
//     children pushed before A's so that A's subtree pops first (:2241-2262);
//     the visited set is the same, only ties may resolve differently;
//   stats: per-ray pops (every entry popped) and leaf pops, as rows 0 and 1
//     of the JAX stats output, which counts them per 1024-ray packet; rows 2
//     and 3 count the child-box slab tests (non-empty slots of the popped
//     nodes) and the triangle tests (non-empty leaf slots reached) that the
//     walk performs. A diagnostic of the schedule, not part of the contract.
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
// a width-16 node tests 16 child boxes per load (a shallow tree), K1 tests
// the 12 triangles of a leaf inline without a stack push, rows are read
// through the read-only path, and 128-thread blocks keep many rays' chains
// in flight per SM to hide the latency. The stack lives in local memory
// (L1-cached), sized by the wrapper's bound on the tree's wide depth.
// Measured on chip_smoke.py's 1080p fronts, K1 takes 3-15x its operations
// bound and the binary skip walk (traverse_binary.cu) keeps pace with it, so
// the chain's length alone does not set its time (PERF.md).

#include "traverse_common.cuh"

#define K1_STACK_CAP 256  // ops/traversal.py K1_STACK_CAP
#define K3_STACK_CAP 512  // ops/traversal.py K3_STACK_CAP

namespace {

using trv::Best;
using trv::Ray;

__global__ void __launch_bounds__(TRV_THREADS)
k1_traverse_wide_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_min_in,
                        const float* __restrict__ t_max_in,
                        const float* __restrict__ wnode,
                        const float* __restrict__ leaf, int n_rays, int any_hit,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    int stack[K1_STACK_CAP];
    int sp = 0;
    stack[sp++] = 0;
    bool done = false;
    while (sp > 0 && !done) {
      const float* row = wnode + static_cast<size_t>(stack[--sp]) * TRV_NODE_COLS;
      const int* refs = reinterpret_cast<const int*>(row + 6 * TRV_WIDTH);
      for (int c = 0; c < TRV_WIDTH; ++c) {
        const int ref = __ldg(refs + c);
        if (ref == TRV_WIDE_EMPTY) continue;
        float tnear;
        if (!trv::wide_child_hit(row, c, r, best.t, tnear)) continue;
        if (ref >= 0) {
          stack[sp++] = ref;  // the wrapper sizes K1_STACK_CAP for the tree
        } else if (trv::leaf_test(trv::leaf_row(leaf, -(ref + 2)), r, best,
                                  any_hit) &&
                   any_hit) {
          done = true;
          break;
        }
      }
    }
  }
  trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
}

// The per-ray counters of K3's stats form.
struct Counts {
  int pops, leaf_pops, box_tests, tri_tests;
};

// One popped entry of a K3 walk: a leaf ref is tested; a node's hit children
// are collected into kids / tns (slot order). Counts into `counts` where it
// is not null. Returns true when an any-hit walk is done.
__device__ __forceinline__ bool k3_expand(int ref, const float* __restrict__ wnode,
                                          const float* __restrict__ leaf,
                                          const Ray& r, Best& best, bool any_hit,
                                          int* kids, float* tns, int& n,
                                          Counts* counts) {
  n = 0;
  if (ref < 0) {
    if (counts != nullptr) ++counts->leaf_pops;
    return trv::leaf_test(trv::leaf_row(leaf, -(ref + 2)), r, best, any_hit,
                          counts != nullptr ? &counts->tri_tests : nullptr) &&
           any_hit;
  }
  const float* row = wnode + static_cast<size_t>(ref) * TRV_NODE_COLS;
  const int* refs = reinterpret_cast<const int*>(row + 6 * TRV_WIDTH);
  for (int c = 0; c < TRV_WIDTH; ++c) {
    const int child = __ldg(refs + c);
    if (child == TRV_WIDE_EMPTY) continue;
    if (counts != nullptr) ++counts->box_tests;
    float tnear;
    if (!trv::wide_child_hit(row, c, r, best.t, tnear)) continue;
    kids[n] = child;
    tns[n] = tnear;
    ++n;
  }
  return false;
}

// Pushes n collected children: in slot order (the top is the highest slot,
// as in K1), or, when ordered, far to near (a stable sort on tnear, nearest
// on top).
template <bool kOrdered>
__device__ __forceinline__ void k3_push(int* kids, float* tns, int n,
                                        int* stack, int& sp) {
  if (kOrdered) {
    for (int a = 1; a < n; ++a) {  // insertion sort, tnear descending
      const int k = kids[a];
      const float t = tns[a];
      int b = a - 1;
      while (b >= 0 && tns[b] < t) {
        kids[b + 1] = kids[b];
        tns[b + 1] = tns[b];
        --b;
      }
      kids[b + 1] = k;
      tns[b + 1] = t;
    }
  }
  for (int a = 0; a < n; ++a) stack[sp++] = kids[a];
}

template <bool kOrdered, bool kDual, bool kStats>
__global__ void __launch_bounds__(TRV_THREADS)
k3_traverse_wide_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_min_in,
                        const float* __restrict__ t_max_in,
                        const float* __restrict__ wnode,
                        const float* __restrict__ leaf, int n_rays, int any_hit,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ stats_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  Counts counts{0, 0, 0, 0};
  Counts* const count = kStats ? &counts : nullptr;
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    int stack[K3_STACK_CAP];
    int sp = 0;
    stack[sp++] = 0;
    int kids_a[TRV_WIDTH], kids_b[TRV_WIDTH];
    float tns_a[TRV_WIDTH], tns_b[TRV_WIDTH];
    bool done = false;
    while (sp > 0 && !done) {
      const int ref_a = stack[--sp];
      const bool has_b = kDual && sp > 0;
      const int ref_b = has_b ? stack[--sp] : 0;
      counts.pops += 1 + has_b;
      int n_a = 0, n_b = 0;
      done = k3_expand(ref_a, wnode, leaf, r, best, any_hit, kids_a, tns_a, n_a,
                       count);
      if (has_b && !done) {
        done = k3_expand(ref_b, wnode, leaf, r, best, any_hit, kids_b, tns_b, n_b,
                         count);
      }
      if (done) break;
      if (has_b) k3_push<kOrdered>(kids_b, tns_b, n_b, stack, sp);
      k3_push<kOrdered>(kids_a, tns_a, n_a, stack, sp);
    }
  }
  trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
  if (kStats) {
    stats_out[i] = counts.pops;
    stats_out[n_rays + i] = counts.leaf_pops;
    stats_out[2 * static_cast<int64_t>(n_rays) + i] = counts.box_tests;
    stats_out[3 * static_cast<int64_t>(n_rays) + i] = counts.tri_tests;
  }
}

}  // namespace

extern "C" int k1_traverse_wide(const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const float* wnode, const float* leaf,
                                int n_rays, int any_hit, float* t_out,
                                int* prim_out, float* u_out, float* v_out,
                                void* stream) {
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  k1_traverse_wide_kernel<<<blocks, TRV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, t_out,
      prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

// ordered and dual do not combine (the JAX package picks the dual kernel
// only when not ordered); stats_out is (4, n_rays) int32 or null.
extern "C" int k3_traverse_wide(const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const float* wnode, const float* leaf,
                                int n_rays, int any_hit, int ordered, int dual,
                                float* t_out, int* prim_out, float* u_out,
                                float* v_out, int* stats_out, void* stream) {
  if (ordered && dual) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = stats_out != nullptr;
#define K3_WIDE_LAUNCH(O, D, S)                                                  \
  k3_traverse_wide_kernel<O, D, S><<<blocks, TRV_THREADS, 0, s>>>(              \
      origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, t_out,     \
      prim_out, u_out, v_out, stats_out)
  if (ordered) {
    if (stats) K3_WIDE_LAUNCH(true, false, true);
    else K3_WIDE_LAUNCH(true, false, false);
  } else if (dual) {
    if (stats) K3_WIDE_LAUNCH(false, true, true);
    else K3_WIDE_LAUNCH(false, true, false);
  } else {
    if (stats) K3_WIDE_LAUNCH(false, false, true);
    else K3_WIDE_LAUNCH(false, false, false);
  }
#undef K3_WIDE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

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
// K1: what bounds it on an H100, and the design. Its operations (the slab
// and triangle tests that K3's stats count) bound it at 0.09-0.26 ms on the
// 1080p fronts of chip_smoke.py; a walk with scalar loads in slot order took
// 3.3x that on the primary fronts and 14-15x on the bounce fronts (PERF.md).
// The chain of dependent loads does not explain it: K3's binary walk, whose
// chain is longer, keeps pace. What does: (1) a popped node read as 112
// scalar 4-byte loads: on an incoherent front each load instruction of a
// warp touches up to 32 rows, so the L1's tag and data throughput, not its
// latency, is spent; (2) children
// taken in slot order: a far subtree is often walked before the near one
// that would have shortened best.t; K3's ordered walk, which only changes
// that, runs the bounce fronts in 0.60-0.71x the time. The design:
//   - a node is read as 28 16-byte loads (load_wide_group), a leaf row as at
//     most 30 (leaf_test_v4), through the read-only path;
//   - closest hit: the 16 children are slab-tested against best.t, the hit
//     ones kept as (ref, tnear) in a per-thread list in shared memory sorted
//     by tnear (insertion, stable, so slot order breaks ties); the hit leaves
//     are tested nearest first, each only while its tnear <= best.t (the slab
//     test at the current best.t, so K1 culls what the plain walk culls);
//     then the inner children are pushed far to near with their tnear, and a
//     popped entry whose tnear exceeds best.t is dropped unread;
//   - any hit: the hit leaves are tested in slot order before any inner child
//     is pushed, since a hit ends the walk; no ordering (it does not pay on
//     the NEE fronts, PERF.md);
//   - the stack holds (ref, tnear) pairs in local memory, sized by the
//     wrapper's bound on the tree's wide depth.
// K1's stats form (kStats, `traverse(..., phase_stats=True)`) counts per ray
// the loop iterations (pops), the entries expanded, the leaf rows tested, the
// pops culled by tnear > best.t, the child-box slab tests (non-empty slots of
// the expanded nodes) and the triangle tests (live slots reached): the work
// of this walk, which its bound counts. The JAX kernel's phase_stats count
// TPU phases per 1024-ray block; they have no meaning here.
//
// K3 keeps its scalar loads: its walks are the JAX package's other
// schedules, and the yardstick K1 is timed beside.

#include "traverse_common.cuh"

#define K1_STACK_CAP 256  // ops/traversal.py K1_STACK_CAP
#define K3_STACK_CAP 512  // ops/traversal.py K3_STACK_CAP

namespace {

using trv::Best;
using trv::Ray;

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(TRV_THREADS)
k1_traverse_wide_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_min_in,
                        const float* __restrict__ t_max_in,
                        const float* __restrict__ wnode,
                        const float* __restrict__ leaf, int n_rays,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ stats_out) {
  // The hit children of the node being expanded, [entry][thread].
  __shared__ int hit_ref[TRV_WIDTH][TRV_THREADS];
  __shared__ float hit_tn[TRV_WIDTH][TRV_THREADS];
  const int lane = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + lane;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  // kStats: loop iterations, entries expanded, leaf rows tested, pops culled,
  // child-box slab tests, triangle tests.
  int st[6] = {0, 0, 0, 0, 0, 0};
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    int2 stack[K1_STACK_CAP];  // (ref, tnear bits); the wrapper sizes the cap
    int sp = 0;
    stack[sp++] = make_int2(0, __float_as_int(-TRV_INF));
    while (sp > 0) {
      const int2 top = stack[--sp];
      if (kStats) ++st[0];
      if (!kAnyHit && !(__int_as_float(top.y) <= best.t)) {
        if (kStats) ++st[3];
        continue;
      }
      if (kStats) ++st[1];
      const float* row = wnode + static_cast<size_t>(top.x) * TRV_NODE_COLS;
      int n = 0;
#pragma unroll
      for (int g = 0; g < TRV_WIDTH / 4; ++g) {
        const trv::WideGroup w = trv::load_wide_group(row, g);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int child = trv::lane4(w.ref, c);
          if (child == TRV_WIDE_EMPTY) continue;
          if (kStats) ++st[4];
          float tnear;
          if (!trv::slab(r, trv::lane4(w.p[0], c), trv::lane4(w.p[1], c),
                         trv::lane4(w.p[2], c), trv::lane4(w.p[3], c),
                         trv::lane4(w.p[4], c), trv::lane4(w.p[5], c), best.t,
                         tnear)) {
            continue;
          }
          int a = n++;
          if (!kAnyHit) {  // insertion by tnear; an equal tnear stays behind
            for (; a > 0 && hit_tn[a - 1][lane] > tnear; --a) {
              hit_ref[a][lane] = hit_ref[a - 1][lane];
              hit_tn[a][lane] = hit_tn[a - 1][lane];
            }
          }
          hit_ref[a][lane] = child;
          hit_tn[a][lane] = tnear;
        }
      }
      bool done = false;
      for (int a = 0; a < n && !done; ++a) {  // leaves, nearest first
        const int child = hit_ref[a][lane];
        if (child >= 0 || !(kAnyHit || hit_tn[a][lane] <= best.t)) continue;
        if (kStats) ++st[2];
        done = trv::leaf_test_v4<kStats>(trv::leaf_row(leaf, -(child + 2)), r, best,
                                         kAnyHit, &st[5]) &&
               kAnyHit;
      }
      if (done) break;
      for (int a = n - 1; a >= 0; --a) {  // inner nodes, far to near
        const int child = hit_ref[a][lane];
        const float tn = hit_tn[a][lane];
        if (child >= 0 && (kAnyHit || tn <= best.t)) {
          stack[sp++] = make_int2(child, __float_as_int(tn));
        }
      }
    }
  }
  trv::store_hit(i, best, kAnyHit, t_out, prim_out, u_out, v_out);
  if (kStats) {
#pragma unroll
    for (int k = 0; k < 6; ++k) stats_out[k * static_cast<int64_t>(n_rays) + i] = st[k];
  }
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

// stats_out is (6, n_rays) int32 (K1's stats form) or null.
extern "C" int k1_traverse_wide(const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const float* wnode, const float* leaf,
                                int n_rays, int any_hit, float* t_out,
                                int* prim_out, float* u_out, float* v_out,
                                int* stats_out, void* stream) {
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_LAUNCH(A, S)                                                         \
  k1_traverse_wide_kernel<A, S><<<blocks, TRV_THREADS, 0, s>>>(                 \
      origin, direction, t_min, t_max, wnode, leaf, n_rays, t_out, prim_out,    \
      u_out, v_out, stats_out)
  if (stats_out != nullptr) {
    if (any_hit) K1_LAUNCH(true, true);
    else K1_LAUNCH(false, true);
  } else {
    if (any_hit) K1_LAUNCH(true, false);
    else K1_LAUNCH(false, false);
  }
#undef K1_LAUNCH
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

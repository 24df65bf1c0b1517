// K2: the steady-drain walk of the width-16 BVH, one thread per ray.
//
// Replaces the TPU kernels rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_sd (:823, one expand per iteration) and
// _make_kernel_wide_sdd (:1008, two), with _steady_drain (:139), launched by
// _run / traverse_packet_pallas(steady_drain=D). Same contract as K1
// (traverse_wide.cu). Each iteration pops one internal node (two with dual:
// A the top, B the next), tests their children's boxes against the same
// best_t, pushes hit leaf rows on a leaf queue and hit internal nodes on the
// stack (B's children first, so A's subtree pops first, :1159-1180), then
// tests up to `drain` queued rows, newest first. drain_first tests the queue
// before the expand instead (:1083-1093). Deferring the leaf tests tightens
// best_t later than a strict depth-first walk, which changes only how exact
// ties in t resolve (:843-845). Any-hit walks stop at the ray's first hit.
// With stats: per-ray internal pops, leaf rows tested and peak queue depth,
// rows 0-2 of the JAX stats output (which counts them per 1024-ray packet).
//
// K2 is the kernel for trees K1 cannot take, so neither structure has a
// fixed capacity in the kernel. Both live in global scratch that the wrapper
// allocates, slot-major ([slot][walker]) so that a warp's entries at one
// depth are adjacent: the stack holds stack_cap entries, sized from the
// tree's wide depth by a bound no walk exceeds (ops/traversal.py
// level_stack_need); the queue holds queue_cap rows (K2_QUEUE_CAP, set from
// the peak depths measured on real fronts), and a push onto a full queue
// first tests its newest row, so no row is dropped and no depth is refused.
// A grid of `walkers` threads strides over the rays, so the scratch scales
// with the card, not with the front.
//
// What bounds it on an H100: dependent loads, as K1; the queue and stack
// traffic goes through L1/L2 as K1's local stack does.

#include "traverse_common.cuh"

namespace {

using trv::Best;
using trv::Ray;

struct Walk {
  int* stack;
  int* queue;
  int64_t stride;  // walkers: the distance between two slots of one walker
  int sp, qn;
  int pops, rows, max_q;

  __device__ __forceinline__ int& st(int k) { return stack[k * stride]; }
  __device__ __forceinline__ int& qu(int k) { return queue[k * stride]; }
};

// Tests up to `count` queued rows, newest first. Returns true when an
// any-hit walk is done.
__device__ __forceinline__ bool drain_rows(Walk& w, int count,
                                           const float* __restrict__ leaf,
                                           const Ray& r, Best& best,
                                           bool any_hit) {
  for (int k = 0; k < count && w.qn > 0; ++k) {
    const int row = w.qu(--w.qn);
    ++w.rows;
    if (trv::leaf_test(trv::leaf_row(leaf, row), r, best, any_hit) && any_hit) {
      return true;
    }
  }
  return false;
}

// Child-hit mask of wide node `ref` (bit c: slot c is hit and not empty).
__device__ __forceinline__ unsigned child_mask(const float* __restrict__ wnode,
                                               int ref, const Ray& r,
                                               float best_t) {
  const float* row = wnode + static_cast<size_t>(ref) * TRV_NODE_COLS;
  const int* refs = reinterpret_cast<const int*>(row + 6 * TRV_WIDTH);
  unsigned mask = 0;
  for (int c = 0; c < TRV_WIDTH; ++c) {
    if (__ldg(refs + c) == TRV_WIDE_EMPTY) continue;
    float tnear;
    if (trv::wide_child_hit(row, c, r, best_t, tnear)) mask |= 1u << c;
  }
  return mask;
}

// Pushes the hit children of `ref` in slot order: leaf rows on the queue
// (testing the newest first when it is full), nodes on the stack. Returns
// true when an any-hit walk is done.
__device__ __forceinline__ bool push_children(
    Walk& w, const float* __restrict__ wnode, const float* __restrict__ leaf,
    int ref, unsigned mask, int queue_cap, const Ray& r, Best& best,
    bool any_hit) {
  const int* refs = reinterpret_cast<const int*>(
      wnode + static_cast<size_t>(ref) * TRV_NODE_COLS + 6 * TRV_WIDTH);
  for (int c = 0; c < TRV_WIDTH; ++c) {
    if (!(mask >> c & 1u)) continue;
    const int child = __ldg(refs + c);
    if (child >= 0) {
      w.st(w.sp++) = child;
      continue;
    }
    if (w.qn == queue_cap && drain_rows(w, 1, leaf, r, best, any_hit)) return true;
    w.qu(w.qn++) = -(child + 2);
  }
  return false;
}

__global__ void __launch_bounds__(TRV_THREADS)
k2_traverse_drain_kernel(const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_min_in,
                         const float* __restrict__ t_max_in,
                         const float* __restrict__ wnode,
                         const float* __restrict__ leaf, int n_rays,
                         int any_hit, int drain, int dual, int drain_first,
                         int* __restrict__ stack, int* __restrict__ queue,
                         int queue_cap, float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ stats_out) {
  const int64_t walker = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t walkers = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = walker; i < n_rays; i += walkers) {
    Ray r;
    Best best;
    Walk w{stack + walker, queue + walker, walkers, 0, 0, 0, 0, 0};
    if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
      w.st(w.sp++) = 0;
      bool done = false;
      while (!done && (w.sp > 0 || w.qn > 0)) {
        if (drain_first && (done = drain_rows(w, drain, leaf, r, best, any_hit))) break;
        const bool has_a = w.sp > 0;
        const int ref_a = has_a ? w.st(w.sp - 1) : 0;
        const bool has_b = dual && w.sp > 1;
        const int ref_b = has_b ? w.st(w.sp - 2) : 0;
        w.sp -= has_a + has_b;
        w.pops += has_a + has_b;
        const unsigned mask_a = has_a ? child_mask(wnode, ref_a, r, best.t) : 0u;
        const unsigned mask_b = has_b ? child_mask(wnode, ref_b, r, best.t) : 0u;
        done = (has_b && push_children(w, wnode, leaf, ref_b, mask_b, queue_cap,
                                       r, best, any_hit)) ||
               (has_a && push_children(w, wnode, leaf, ref_a, mask_a, queue_cap,
                                       r, best, any_hit));
        w.max_q = max(w.max_q, w.qn);
        if (!done && !drain_first) done = drain_rows(w, drain, leaf, r, best, any_hit);
      }
    }
    trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
    if (stats_out != nullptr) {
      stats_out[i] = w.pops;
      stats_out[n_rays + i] = w.rows;
      stats_out[2 * static_cast<int64_t>(n_rays) + i] = w.max_q;
    }
  }
}

}  // namespace

// stack: (stack_cap, walkers) int32, queue: (queue_cap, walkers) int32, with
// walkers = blocks * TRV_THREADS; stats_out (3, n_rays) int32 or null.
extern "C" int k2_traverse_drain(const float* origin, const float* direction,
                                 const float* t_min, const float* t_max,
                                 const float* wnode, const float* leaf,
                                 int n_rays, int any_hit, int drain, int dual,
                                 int drain_first, int blocks, int* stack,
                                 int* queue, int queue_cap, float* t_out,
                                 int* prim_out, float* u_out, float* v_out,
                                 int* stats_out, void* stream) {
  k2_traverse_drain_kernel<<<blocks, TRV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, drain, dual,
      drain_first, stack, queue, queue_cap, t_out, prim_out, u_out, v_out,
      stats_out);
  return static_cast<int>(cudaGetLastError());
}

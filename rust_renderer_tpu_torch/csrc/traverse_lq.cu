// K3-lq: closest-hit / any-hit traversal of the width-16 BVH with a deferred
// leaf queue, one thread per ray.
//
// Replaces the TPU kernel rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_lq (:620; launched by _run under
// traverse_packet_pallas(leaf_queue=flush_k)). Same contract as K1
// (traverse_wide.cu): per ray, the nearest Moller-Trumbore hit in
// (t_min, min(INF, t_max)) as (t, prim, u, v); with any_hit the walk stops at
// the first hit. The schedule is the JAX kernel's, per ray:
//   - the stack holds internal nodes only; a popped node's hit children go,
//     in slot order, to the stack (internal) or to the leaf queue (leaf rows,
//     :737-753);
//   - after each pop the queue is flushed when it holds flush_k rows, or when
//     the stack is empty and the queue is not (:758-760); a flush tests up to
//     16 rows, newest first (:764-768).
// Leaf tests are deferred, so best_t tightens later than in K1 and ties (and
// hits that lie outside their own leaf box) may resolve differently; hits
// are otherwise the plain walk's.
//
// The queue holds fewer than flush_k rows before a pop, a pop appends at most
// 16 and a flush takes up to 16, so it never exceeds flush_k - 1 + 16 rows:
// the wrapper (ops/traversal.py::traverse_lq_cuda) refuses a flush_k whose
// need passes LQ_QUEUE_CAP. The stack holds at most 16 entries per wide level
// (ops/traversal.py::level_stack_need), which the wrapper checks against
// K3_STACK_CAP.
//
// What bounds it on an H100: as K1, chains of dependent row loads from the
// L2-resident tables (PERF.md). On the TPU the queue amortized a branch
// context per flush; one thread per ray has no such cost, so the queue only
// reorders the leaf tests (and costs local-memory traffic). Stack and queue
// live in local memory (L1-cached).

#include "traverse_common.cuh"

#define K3_STACK_CAP 512   // ops/traversal.py K3_STACK_CAP
#define LQ_QUEUE_CAP 64    // ops/traversal.py LQ_QUEUE_CAP

namespace {

using trv::Best;
using trv::Ray;

template <bool kStats>
__global__ void __launch_bounds__(TRV_THREADS)
k3_traverse_lq_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_min_in,
                      const float* __restrict__ t_max_in,
                      const float* __restrict__ wnode,
                      const float* __restrict__ leaf, int n_rays, int any_hit,
                      int flush_k, float* __restrict__ t_out,
                      int* __restrict__ prim_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ stats_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  int pops = 0, leaf_pops = 0, box_tests = 0, tri_tests = 0;
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    int stack[K3_STACK_CAP];
    int queue[LQ_QUEUE_CAP];
    int sp = 0, qn = 0;
    stack[sp++] = 0;
    bool done = false;
    while ((sp > 0 || qn > 0) && !done) {
      if (sp > 0) {
        ++pops;
        const float* row = wnode + static_cast<size_t>(stack[--sp]) * TRV_NODE_COLS;
        const int* refs = reinterpret_cast<const int*>(row + 6 * TRV_WIDTH);
        for (int c = 0; c < TRV_WIDTH; ++c) {
          const int child = __ldg(refs + c);
          if (child == TRV_WIDE_EMPTY) continue;
          if (kStats) ++box_tests;
          float tnear;
          if (!trv::wide_child_hit(row, c, r, best.t, tnear)) continue;
          if (child < 0) {
            queue[qn++] = -(child + 2);
          } else {
            stack[sp++] = child;
          }
        }
      }
      if (qn >= flush_k || (sp == 0 && qn > 0)) {
        const int take = qn < TRV_WIDTH ? qn : TRV_WIDTH;
        for (int k = 0; k < take; ++k) {
          ++leaf_pops;
          if (trv::leaf_test(trv::leaf_row(leaf, queue[qn - 1 - k]), r, best, any_hit,
                             kStats ? &tri_tests : nullptr) &&
              any_hit) {
            done = true;
            break;
          }
        }
        qn -= take;
      }
    }
  }
  trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
  if (kStats) {
    stats_out[i] = pops;
    stats_out[n_rays + i] = leaf_pops;
    stats_out[2 * static_cast<int64_t>(n_rays) + i] = box_tests;
    stats_out[3 * static_cast<int64_t>(n_rays) + i] = tri_tests;
  }
}

}  // namespace

// stats_out is (4, n_rays) int32 (internal pops, leaf rows tested, slab
// tests, triangle tests) or null.
extern "C" int k3_traverse_lq(const float* origin, const float* direction,
                              const float* t_min, const float* t_max,
                              const float* wnode, const float* leaf, int n_rays,
                              int any_hit, int flush_k, float* t_out, int* prim_out,
                              float* u_out, float* v_out, int* stats_out,
                              void* stream) {
  if (flush_k < 1 || flush_k - 1 + TRV_WIDTH > LQ_QUEUE_CAP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats_out != nullptr) {
    k3_traverse_lq_kernel<true><<<blocks, TRV_THREADS, 0, s>>>(
        origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, flush_k,
        t_out, prim_out, u_out, v_out, stats_out);
  } else {
    k3_traverse_lq_kernel<false><<<blocks, TRV_THREADS, 0, s>>>(
        origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, flush_k,
        t_out, prim_out, u_out, v_out, stats_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 (binary): closest-hit / any-hit traversal of the binary skip-pointer
// tree, one thread per ray.
//
// Replaces the TPU kernels rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel (:173, the stackless skip walk) and _make_kernel_ordered
// (:264, near child first with a stack), launched by _run /
// traverse_packet_pallas(wide=False). Same contract as K1 (traverse_wide.cu).
//
// Table (ops/bvh.py): node (N, 8) f32 in DFS pre-order: min.xyz, max.xyz,
// skip pointer (int32 bits, -1 = done), leaf row (int32 bits, -1 =
// internal). An internal node's left child is node + 1, its right child the
// left child's skip pointer.
//   skip walk: a node whose box is hit moves to node + 1 (testing its leaf
//     first), any other to its skip pointer. It is the plain walk's own
//     algorithm (ops/traversal.py::traverse_plain), so t, prim, u, v match
//     it bit for bit.
//   ordered: a popped node whose box is hit tests its leaf or both
//     children's boxes, then pushes the hit children far child first, so the
//     near one pops next (a tie goes to the left child). The stack holds one
//     deferred child per level: max_depth + 2 entries (the wrapper checks
//     K3B_STACK_CAP).
//
// What bounds it on an H100: dependent loads, as K1, but one 32-byte node per
// step: a walk is a longer chain of shorter loads (the skip walk also steps
// through missed nodes). Measured on chip_smoke.py's 1080p fronts, that
// chain costs no more than K1's (0.77-1.06x K1's time; PERF.md).

#include "traverse_common.cuh"

#define K3B_STACK_CAP 256  // ops/traversal.py K3B_STACK_CAP
#define K3B_NODE_COLS 8

namespace {

using trv::Best;
using trv::Ray;

__device__ __forceinline__ bool node_hit(const float* __restrict__ row,
                                         const Ray& r, float best_t,
                                         float& tnear) {
  return trv::slab(r, __ldg(row + 0), __ldg(row + 1), __ldg(row + 2),
                   __ldg(row + 3), __ldg(row + 4), __ldg(row + 5), best_t, tnear);
}

__device__ __forceinline__ int node_int(const float* __restrict__ row, int col) {
  return __ldg(reinterpret_cast<const int*>(row) + col);
}

template <bool kOrdered>
__global__ void __launch_bounds__(TRV_THREADS)
k3_traverse_binary_kernel(const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_min_in,
                          const float* __restrict__ t_max_in,
                          const float* __restrict__ node,
                          const float* __restrict__ leaf, int n_nodes,
                          int n_rays, int any_hit, float* __restrict__ t_out,
                          int* __restrict__ prim_out, float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    if (!kOrdered) {
      int cur = 0;
      while (cur >= 0) {
        const float* row = node + static_cast<size_t>(cur) * K3B_NODE_COLS;
        float tnear;
        const bool hit = node_hit(row, r, best.t, tnear);
        const int leaf_row = node_int(row, 7);
        if (hit && leaf_row >= 0 &&
            trv::leaf_test(trv::leaf_row(leaf, leaf_row), r, best, any_hit) &&
            any_hit) {
          break;
        }
        cur = (hit && leaf_row < 0) ? cur + 1 : node_int(row, 6);
      }
    } else {
      int stack[K3B_STACK_CAP];
      int sp = 0;
      stack[sp++] = 0;
      while (sp > 0) {
        const int cur = stack[--sp];
        const float* row = node + static_cast<size_t>(cur) * K3B_NODE_COLS;
        float tnear;
        if (!node_hit(row, r, best.t, tnear)) continue;
        const int leaf_row = node_int(row, 7);
        if (leaf_row >= 0) {
          if (trv::leaf_test(trv::leaf_row(leaf, leaf_row), r, best, any_hit) &&
              any_hit) {
            break;
          }
          continue;
        }
        const int left = min(cur + 1, n_nodes - 1);
        const float* lrow = node + static_cast<size_t>(left) * K3B_NODE_COLS;
        const int right = max(0, min(node_int(lrow, 6), n_nodes - 1));
        const float* rrow = node + static_cast<size_t>(right) * K3B_NODE_COLS;
        float tn_l, tn_r;
        const bool hit_l = node_hit(lrow, r, best.t, tn_l);
        const bool hit_r = node_hit(rrow, r, best.t, tn_r);
        const bool near_is_left = (hit_l ? tn_l : TRV_INF) <= (hit_r ? tn_r : TRV_INF);
        const int first = near_is_left ? left : right;
        const int second = near_is_left ? right : left;
        if (near_is_left ? hit_r : hit_l) stack[sp++] = second;
        if (near_is_left ? hit_l : hit_r) stack[sp++] = first;
      }
    }
  }
  trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
}

}  // namespace

extern "C" int k3_traverse_binary(const float* origin, const float* direction,
                                  const float* t_min, const float* t_max,
                                  const float* node, const float* leaf,
                                  int n_nodes, int n_rays, int any_hit,
                                  int ordered, float* t_out, int* prim_out,
                                  float* u_out, float* v_out, void* stream) {
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ordered) {
    k3_traverse_binary_kernel<true><<<blocks, TRV_THREADS, 0, s>>>(
        origin, direction, t_min, t_max, node, leaf, n_nodes, n_rays, any_hit,
        t_out, prim_out, u_out, v_out);
  } else {
    k3_traverse_binary_kernel<false><<<blocks, TRV_THREADS, 0, s>>>(
        origin, direction, t_min, t_max, node, leaf, n_nodes, n_rays, any_hit,
        t_out, prim_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}

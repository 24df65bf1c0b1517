// K3-multi: closest-hit / any-hit traversal of the width-16 BVH with M rays
// interleaved in one thread (M = 2, 4 or 8).
//
// Replaces the TPU kernel rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_multi (:2296; launched by _run under
// traverse_packet_pallas(multi=M)). Same contract as K1 (traverse_wide.cu).
// Each ray walks exactly as in K3 wide (_make_kernel_wide): leaf children are
// pushed on the ray's own stack and tested when popped, hit children pushed in
// slot order; so each ray's hits are K3 wide's, bit for bit. As in the JAX
// kernel (:2378-2437), every iteration pops and expands one node, or tests one
// leaf row, for each of the thread's rays that still walks, so the M
// dependent row loads of an iteration are independent of one another and can
// be in flight together. The TPU's gang reduction (:2439-2474) shared one
// vector-to-scalar extract between blocks; a thread's rays have nothing to
// share, so it has no counterpart.
//
// Which rays a thread takes: thread t of T = ceil(R / M) walks rays t, t + T,
// ..., t + (M - 1) T. A warp's k-th rays are then 32 consecutive rays, as in
// K1 (image neighbours on a camera front, so their walks are coherent across
// the warp), and every load of a ray and store of a hit is coalesced.
// Neighbouring rays in one thread would instead strip each warp over 32 M
// rays and stride its loads by M.
//
// Each ray's stack holds at most 16 entries per level, leaf refs included
// (ops/traversal.py::level_stack_need(wide_depth + 1)); the M stacks live in
// local memory, K3_STACK_CAP entries each, as K3 wide's.

#include "traverse_common.cuh"

#define K3_STACK_CAP 512  // ops/traversal.py K3_STACK_CAP

namespace {

using trv::Best;
using trv::Ray;

template <int M>
__global__ void __launch_bounds__(TRV_THREADS)
k3_traverse_multi_kernel(const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_min_in,
                         const float* __restrict__ t_max_in,
                         const float* __restrict__ wnode,
                         const float* __restrict__ leaf, int n_rays, int any_hit,
                         int64_t n_threads, float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  Ray r[M];
  Best best[M];
  int sp[M];
  int stack[M][K3_STACK_CAP];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int64_t i = t + k * n_threads;
    sp[k] = 0;
    best[k].prim = -1;
    if (i < n_rays && trv::load_ray(origin, direction, t_min_in, t_max_in, i, r[k],
                                    best[k])) {
      stack[k][0] = 0;
      sp[k] = 1;
    }
  }
  bool walking = true;
  while (walking) {
    walking = false;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (sp[k] == 0) continue;
      const int ref = stack[k][--sp[k]];
      if (ref < 0) {
        if (trv::leaf_test(trv::leaf_row(leaf, -(ref + 2)), r[k], best[k], any_hit) &&
            any_hit) {
          sp[k] = 0;  // any-hit: this ray is done
        }
      } else {
        const float* row = wnode + static_cast<size_t>(ref) * TRV_NODE_COLS;
        const int* refs = reinterpret_cast<const int*>(row + 6 * TRV_WIDTH);
        for (int c = 0; c < TRV_WIDTH; ++c) {
          const int child = __ldg(refs + c);
          if (child == TRV_WIDE_EMPTY) continue;
          float tnear;
          if (!trv::wide_child_hit(row, c, r[k], best[k].t, tnear)) continue;
          stack[k][sp[k]++] = child;
        }
      }
      walking = walking || sp[k] > 0;
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int64_t i = t + k * n_threads;
    if (i < n_rays) trv::store_hit(i, best[k], any_hit, t_out, prim_out, u_out, v_out);
  }
}

template <int M>
int launch_multi(const float* origin, const float* direction, const float* t_min,
                 const float* t_max, const float* wnode, const float* leaf,
                 int n_rays, int any_hit, float* t_out, int* prim_out, float* u_out,
                 float* v_out, cudaStream_t s) {
  const int64_t n_threads = (static_cast<int64_t>(n_rays) + M - 1) / M;
  const int blocks = static_cast<int>((n_threads + TRV_THREADS - 1) / TRV_THREADS);
  k3_traverse_multi_kernel<M><<<blocks, TRV_THREADS, 0, s>>>(
      origin, direction, t_min, t_max, wnode, leaf, n_rays, any_hit, n_threads, t_out,
      prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: rays per thread (2, 4 or 8). The wrapper checks the tree's stack need
// against K3_STACK_CAP.
extern "C" int k3_traverse_multi(const float* origin, const float* direction,
                                 const float* t_min, const float* t_max,
                                 const float* wnode, const float* leaf, int n_rays,
                                 int any_hit, int m, float* t_out, int* prim_out,
                                 float* u_out, float* v_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 2:
      return launch_multi<2>(origin, direction, t_min, t_max, wnode, leaf, n_rays,
                             any_hit, t_out, prim_out, u_out, v_out, s);
    case 4:
      return launch_multi<4>(origin, direction, t_min, t_max, wnode, leaf, n_rays,
                             any_hit, t_out, prim_out, u_out, v_out, s);
    case 8:
      return launch_multi<8>(origin, direction, t_min, t_max, wnode, leaf, n_rays,
                             any_hit, t_out, prim_out, u_out, v_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

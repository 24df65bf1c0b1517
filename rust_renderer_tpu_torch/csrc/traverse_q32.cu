// K1q: closest-hit / any-hit traversal of the quantized width-32 BVH, one
// thread per ray.
//
// Replaces the TPU kernel rust_renderer_tpu/ops/pallas/traversal.py::
// _make_kernel_wide_row32 (:1242), launched by _run /
// traverse_packet_pallas(row_cursors > 0, q32=True). Same contract as K1
// (traverse_wide.cu).
//
// Tables (ops/bvh.py, _quantize_wide32 and _collapse_wide(width=32)):
//   q32 (W32, 128) int32: lanes 32p + c (p < 3) hold child c's 16-bit planes
//     [qlo.x | qlo.y << 16, qlo.z | qhi.x << 16, qhi.y | qhi.z << 16]; lanes
//     96-98 the node's grid origin, 99-101 its scale (f32 bits). The rows
//     carry no child pointers.
//   meta32 (W32 + 1, 4) int32: [int_last, leaf_last, static_int, static_leaf]
//     with bit 31 - c set for an internal (leaf) child in slot c. A child's
//     index is last - popcount(static & (bit - 1)); row W32 is the synthetic
//     parent of the root (int_last 0, static_int 1 << 31).
//   perm (n,) int32 maps the collapse's leaf ids to rows of leaf (L, 120).
//
// The stack holds (node, mask of its hit internal children still to visit)
// pairs, one per level, as the JAX kernel's stack does; the lowest mask bit
// (the highest slot) pops first, K1's order. An expanded node's hit leaves
// are tested at once (the JAX kernel queues and drains them: that is its
// schedule, not its contract).
//
// Exactness rests on conservativeness: each dequantized box must contain the
// f32 box, so the walk visits a superset of K1's nodes and the triangle
// tests decide. In exact arithmetic origin + q * scale lies outside the f32
// box (the 2-ulp grid widening and one step of padding of _quantize_wide32;
// tests/test_torch_traversal_variants.py checks it). The JAX kernel computes
// the slab as fma(q, scale * inv_d, (origin - o) * inv_d), whose roundings
// the padding is relied on to cover. Here the planes are dequantized with
// directed rounding instead, lower planes down and upper planes up
// (__fmaf_rd / __fmaf_ru), so each stays outside its f32 plane after
// rounding; the slab is then K1's (plane - o) * inv_d, which is monotone in
// the plane. The quantized slab therefore contains K1's slab for every ray,
// with no assumption about how far the ray starts from the node.
//
// What bounds it on an H100: dependent loads, as K1: one 512-byte row tests
// 32 children where K1's 448-byte row tests 16, so a walk is about one level
// shorter; the dequantization adds 6 fma per child.

#include "traverse_common.cuh"

#define K1Q_STACK_CAP 64  // ops/traversal.py K1Q_STACK_CAP
#define K1Q_WIDTH 32
#define K1Q_ROW 128

namespace {

using trv::Best;
using trv::Ray;

__global__ void __launch_bounds__(TRV_THREADS)
k1q_traverse_q32_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_min_in,
                        const float* __restrict__ t_max_in,
                        const int* __restrict__ q32,
                        const int* __restrict__ meta,
                        const int* __restrict__ perm,
                        const float* __restrict__ leaf, int root_row,
                        int n_rays, int any_hit, float* __restrict__ t_out,
                        int* __restrict__ prim_out, float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Best best;
  if (trv::load_ray(origin, direction, t_min_in, t_max_in, i, r, best)) {
    int sptr[K1Q_STACK_CAP];
    unsigned smask[K1Q_STACK_CAP];
    int sp = 0;
    sptr[sp] = root_row;
    smask[sp++] = 1u << (K1Q_WIDTH - 1);
    bool done = false;
    while (sp > 0 && !done) {
      const unsigned m = smask[sp - 1];
      const int parent = sptr[sp - 1];
      const unsigned low = m & (~m + 1u);
      if (m ^ low) {
        smask[sp - 1] = m ^ low;
      } else {
        --sp;
      }
      const int* pm = meta + 4 * static_cast<int64_t>(parent);
      const int node = __ldg(pm) - __popc(static_cast<unsigned>(__ldg(pm + 2)) & (low - 1u));

      const int* row = q32 + static_cast<int64_t>(node) * K1Q_ROW;
      const float gx = __int_as_float(__ldg(row + 96));
      const float gy = __int_as_float(__ldg(row + 97));
      const float gz = __int_as_float(__ldg(row + 98));
      const float sx = __int_as_float(__ldg(row + 99));
      const float sy = __int_as_float(__ldg(row + 100));
      const float sz = __int_as_float(__ldg(row + 101));
      const int* nm = meta + 4 * static_cast<int64_t>(node);
      const unsigned st_int = static_cast<unsigned>(__ldg(nm + 2));
      const unsigned st_leaf = static_cast<unsigned>(__ldg(nm + 3));
      unsigned hits = 0;
      for (int c = 0; c < K1Q_WIDTH; ++c) {
        const unsigned bit = 1u << (K1Q_WIDTH - 1 - c);
        if (!((st_int | st_leaf) & bit)) continue;
        const unsigned p0 = static_cast<unsigned>(__ldg(row + c));
        const unsigned p1 = static_cast<unsigned>(__ldg(row + K1Q_WIDTH + c));
        const unsigned p2 = static_cast<unsigned>(__ldg(row + 2 * K1Q_WIDTH + c));
        const float lox = __fmaf_rd(static_cast<float>(p0 & 0xFFFFu), sx, gx);
        const float loy = __fmaf_rd(static_cast<float>(p0 >> 16), sy, gy);
        const float loz = __fmaf_rd(static_cast<float>(p1 & 0xFFFFu), sz, gz);
        const float hix = __fmaf_ru(static_cast<float>(p1 >> 16), sx, gx);
        const float hiy = __fmaf_ru(static_cast<float>(p2 & 0xFFFFu), sy, gy);
        const float hiz = __fmaf_ru(static_cast<float>(p2 >> 16), sz, gz);
        float tnear;
        if (trv::slab(r, lox, loy, loz, hix, hiy, hiz, best.t, tnear)) hits |= bit;
      }
      // Leaves first, highest slot first; leaf id = leaf_last - popcount.
      for (unsigned lh = hits & st_leaf; lh != 0 && !done;) {
        const unsigned lb = lh & (~lh + 1u);
        lh ^= lb;
        const int id = __ldg(nm + 1) - __popc(st_leaf & (lb - 1u));
        done = trv::leaf_test(trv::leaf_row(leaf, __ldg(perm + id)), r, best,
                              any_hit) &&
               any_hit;
      }
      const unsigned ih = hits & st_int;
      if (ih != 0 && !done) {  // the wrapper sizes K1Q_STACK_CAP for the tree
        sptr[sp] = node;
        smask[sp++] = ih;
      }
    }
  }
  trv::store_hit(i, best, any_hit, t_out, prim_out, u_out, v_out);
}

}  // namespace

// meta: (root_row + 1, 4) int32, root_row = W32 (the synthetic root parent).
extern "C" int k1q_traverse_q32(const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const int* q32, const int* meta, const int* perm,
                                const float* leaf, int root_row, int n_rays,
                                int any_hit, float* t_out, int* prim_out,
                                float* u_out, float* v_out, void* stream) {
  const int blocks = (n_rays + TRV_THREADS - 1) / TRV_THREADS;
  k1q_traverse_q32_kernel<<<blocks, TRV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_min, t_max, q32, meta, perm, leaf, root_row, n_rays,
      any_hit, t_out, prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

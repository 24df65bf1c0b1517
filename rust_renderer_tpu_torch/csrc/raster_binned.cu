// K4 (depth) and K5 (visibility buffer): tile-binned triangle rasterization,
// one thread block per 32x256-pixel tile.
//
// Replaces the TPU kernels rust_renderer_tpu/ops/raster_binned.py::
// _depth_kernel (K4, launched by _run / rasterize_depth_binned) and
// _vis_kernel (K5, launched by _run_vis / rasterize_binned). Same contract
// over the table that ops/raster_binned.py::bin_triangles builds:
//   table (R, 16) f32 for K4, (R, 24) f32 for K5, rows contiguous:
//     [A0,B0,C0, A1,B1,C1, A2,B2,C2, z0,z1,z2, inv_abs_area, ...]; K5 rows go
//     on with [iw0,iw1,iw2, b0u,b0v,b1u,b1v,b2u,b2v, orig_id, 0].
//   rows [g_base, g_base + g_count) are the global list, every tile's
//   segment is rows [starts[t], starts[t] + counts[t]).
// A tile walks the global list, then its segment, in table order.
//   K4: depth = min(1, least z of the rows whose three edge functions are
//       >= 0 at the pixel center), z = (e1*z0 + e2*z1 + e0*z2) * inv_abs_area.
//   K5: (depth, tri, u, v) from a clear of (1, -1, 0, 0); a row is taken
//       where inside, z <= depth and z <= 1, so the later row wins a tie.
//
// What bounds it on an H100: arithmetic. Each (row, pixel) test is ~20 flops
// with no memory traffic, and every tile walks the whole global list (the
// floors and walls), so the work is (rows walked) x 8192 pixels per tile.
// The design keeps the rows out of the inner loop's memory path: the block
// stages rows in shared memory in chunks that all 512 threads load together
// (coalesced), and every thread then reads the same row (a broadcast) and
// tests it against the 16 pixels of its column that it keeps in registers.
// A*x is computed once per row and column. Binning on the card, per-row
// tile rejection and rebalancing the global list are left to later work.
//
// The operation order follows the JAX kernels and the plain PyTorch
// versions; build with -fmad=false so no multiply-add is contracted and K4's
// depth is bit-equal to the plain version on the same table.

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#define RB_TILE_H 32
#define RB_TILE_W 256
#define RB_THREADS 512
#define RB_PIX 16  // pixels of one column per thread: TILE_H * TILE_W / THREADS
#define RB_DEPTH_STRIDE 16
#define RB_VIS_STRIDE 24
#define RB_DEPTH_CHUNK 512  // rows staged at once: 32 KB
#define RB_VIS_CHUNK 256    // 24 KB
#define RB_FAR 3.0e38f

namespace {

// Copies rows [first, first + n) of the table into shared memory, all
// threads of the block together.
template <int STRIDE>
__device__ __forceinline__ void stage_rows(const float* __restrict__ table,
                                           int64_t first, int n,
                                           float* rows) {
  const float* src = table + first * STRIDE;
  for (int i = threadIdx.x; i < n * STRIDE; i += blockDim.x) rows[i] = src[i];
}

struct Pixels {
  float x;           // this thread's pixel-center column
  float y[RB_PIX];   // its pixel-center rows
  int col, row0;     // pixel coordinates of the first one
};

__device__ __forceinline__ Pixels tile_pixels() {
  Pixels p;
  const int local_col = threadIdx.x % RB_TILE_W;
  const int local_row = (threadIdx.x / RB_TILE_W) * RB_PIX;
  p.col = blockIdx.x * RB_TILE_W + local_col;
  p.row0 = blockIdx.y * RB_TILE_H + local_row;
  p.x = static_cast<float>(p.col) + 0.5f;
#pragma unroll
  for (int k = 0; k < RB_PIX; ++k) p.y[k] = static_cast<float>(p.row0 + k) + 0.5f;
  return p;
}

__global__ void __launch_bounds__(RB_THREADS)
k4_depth_kernel(const float* __restrict__ table, const int* __restrict__ starts,
                const int* __restrict__ counts, int g_base, int g_count,
                int width, int height, float* __restrict__ out) {
  __shared__ float rows[RB_DEPTH_CHUNK * RB_DEPTH_STRIDE];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const Pixels p = tile_pixels();
  float depth[RB_PIX];
#pragma unroll
  for (int k = 0; k < RB_PIX; ++k) depth[k] = 1.0f;

  for (int part = 0; part < 2; ++part) {
    const int64_t first = part == 0 ? g_base : starts[tile];
    const int n = part == 0 ? g_count : counts[tile];
    for (int c = 0; c < n; c += RB_DEPTH_CHUNK) {
      const int m = min(RB_DEPTH_CHUNK, n - c);
      __syncthreads();
      stage_rows<RB_DEPTH_STRIDE>(table, first + c, m, rows);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float* q = rows + j * RB_DEPTH_STRIDE;
        const float ax0 = q[0] * p.x, ax1 = q[3] * p.x, ax2 = q[6] * p.x;
#pragma unroll
        for (int k = 0; k < RB_PIX; ++k) {
          const float e0 = ax0 + q[1] * p.y[k] + q[2];
          const float e1 = ax1 + q[4] * p.y[k] + q[5];
          const float e2 = ax2 + q[7] * p.y[k] + q[8];
          const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
          const float z = (e1 * q[9] + e2 * q[10] + e0 * q[11]) * q[12];
          const float cand = inside ? z : RB_FAR;
          // minimum that keeps a NaN, like jnp.minimum / torch.minimum
          if (cand < depth[k] || cand != cand) depth[k] = cand;
        }
      }
    }
  }
  if (p.col >= width) return;
#pragma unroll
  for (int k = 0; k < RB_PIX; ++k) {
    const int y = p.row0 + k;
    if (y < height) out[static_cast<int64_t>(y) * width + p.col] = depth[k];
  }
}

__global__ void __launch_bounds__(RB_THREADS)
k5_vis_kernel(const float* __restrict__ table, const int* __restrict__ starts,
              const int* __restrict__ counts, int g_base, int g_count,
              int width, int height, float* __restrict__ depth_out,
              int* __restrict__ tri_out, float* __restrict__ u_out,
              float* __restrict__ v_out) {
  __shared__ float rows[RB_VIS_CHUNK * RB_VIS_STRIDE];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const Pixels p = tile_pixels();
  float depth[RB_PIX], bu[RB_PIX], bv[RB_PIX];
  int tri[RB_PIX];
#pragma unroll
  for (int k = 0; k < RB_PIX; ++k) {
    depth[k] = 1.0f;
    tri[k] = -1;
    bu[k] = 0.0f;
    bv[k] = 0.0f;
  }

  for (int part = 0; part < 2; ++part) {
    const int64_t first = part == 0 ? g_base : starts[tile];
    const int n = part == 0 ? g_count : counts[tile];
    for (int c = 0; c < n; c += RB_VIS_CHUNK) {
      const int m = min(RB_VIS_CHUNK, n - c);
      __syncthreads();
      stage_rows<RB_VIS_STRIDE>(table, first + c, m, rows);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float* q = rows + j * RB_VIS_STRIDE;
        const float ax0 = q[0] * p.x, ax1 = q[3] * p.x, ax2 = q[6] * p.x;
        const float ia = q[12];
#pragma unroll
        for (int k = 0; k < RB_PIX; ++k) {
          const float e0 = ax0 + q[1] * p.y[k] + q[2];
          const float e1 = ax1 + q[4] * p.y[k] + q[5];
          const float e2 = ax2 + q[7] * p.y[k] + q[8];
          const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
          // barycentrics from the edge functions (l0 = edge v1->v2, ...)
          const float l0 = e1 * ia, l1 = e2 * ia, l2 = e0 * ia;
          const float z = l0 * q[9] + l1 * q[10] + l2 * q[11];
          if (inside && z <= depth[k] && z <= 1.0f) {
            // perspective correction, composed through the original
            // triangle's barycentrics (ops/raster.py semantics)
            const float lw0 = l0 * q[13], lw1 = l1 * q[14], lw2 = l2 * q[15];
            const float denom = lw0 + lw1 + lw2;
            const float rden = 1.0f / (fabsf(denom) < 1e-12f ? 1.0f : denom);
            depth[k] = z;
            tri[k] = static_cast<int>(q[22]);
            bu[k] = (lw0 * q[16] + lw1 * q[18] + lw2 * q[20]) * rden;
            bv[k] = (lw0 * q[17] + lw1 * q[19] + lw2 * q[21]) * rden;
          }
        }
      }
    }
  }
  if (p.col >= width) return;
#pragma unroll
  for (int k = 0; k < RB_PIX; ++k) {
    const int y = p.row0 + k;
    if (y >= height) continue;
    const int64_t i = static_cast<int64_t>(y) * width + p.col;
    depth_out[i] = depth[k];
    tri_out[i] = tri[k];
    u_out[i] = bu[k];
    v_out[i] = bv[k];
  }
}

}  // namespace

#if defined(__CUDACC__)
// The wrapper (ops/raster_binned.py) checks shapes, types and the grid
// limits; these return cudaGetLastError() after the launch.
extern "C" int k4_depth_binned(const float* table, const int* starts,
                               const int* counts, int g_base, int g_count,
                               int nx, int ny, int width, int height,
                               float* out, void* stream) {
  k4_depth_kernel<<<dim3(nx, ny), RB_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      table, starts, counts, g_base, g_count, width, height, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k5_vis_binned(const float* table, const int* starts,
                             const int* counts, int g_base, int g_count,
                             int nx, int ny, int width, int height,
                             float* depth, int* tri, float* u, float* v,
                             void* stream) {
  k5_vis_kernel<<<dim3(nx, ny), RB_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      table, starts, counts, g_base, g_count, width, height, depth, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}
#endif

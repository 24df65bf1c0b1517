// K4 (depth) and K5 (visibility buffer): tile-binned triangle rasterization
// over 32x256-pixel tiles.
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
//   K4: depth = min(1, least z of the rows whose three edge functions are
//       >= 0 at the pixel center), z = (e1*z0 + e2*z1 + e0*z2) * inv_abs_area.
//   K5: (depth, tri, u, v) from a clear of (1, -1, 0, 0); a row is taken
//       where inside, z <= depth and z <= 1, so the later row wins a tie.
//
// K4: what bounds it on an H100, and the design. The work the data needs is
// each row tested on the pixels of its triangle's box widened by one pixel
// (inside its tile for a segment row): ~20 operations per (row, pixel) pair
// and no memory traffic beyond the table, so at 4096^2 the output's 67 MB
// (~0.02 ms at 3.35 TB/s) binds it, not the pairs. Two things stood in the
// way of a tile-per-block kernel: every row was tested on all 8,192 pixels
// of its tile, and one tile's segment (27k rows on a far cascade) was one
// block's work while the other SMs idled. So:
//   - each row carries its pixel box (int32, made by the wrapper; a segment
//     row's already clipped to its tile, a global row's clipped here), and is
//     tested only there: K4 tests exactly the plain version's pairs, in its
//     operation order, and a global row that misses the tile costs one
//     comparison;
//   - the work is cut into items of at most K4_ITEM_ROWS rows of one tile
//     (the global list, then the segment), numbered by a cumulative sum per
//     tile (`plan`, made on the device from counts); a persistent grid sized
//     to the SMs takes items from a counter in `plan`, so no item count is
//     needed on the host and no block walks a long segment alone;
//   - a row whose box holds at most K4_SMALL_BOX pixels is tested by one
//     thread; a larger one by a warp, its pixels spread over the lanes;
//   - the item's tile depth lives in shared memory (32 KB) and is lowered with
//     integer atomics on the float's bits (`depth_min`); the item then writes
//     the pixels it lowered: a plain store where it is its tile's only item,
//     else the same atomic minimum onto the output, which the wrapper clears
//     to 1.0. The minimum does not depend on the order, so the result does
//     not depend on the schedule.
//
// K5 runs one 512-thread block per tile: the block stages rows in shared
// memory in chunks that all its threads load together, every thread reads
// the same row (a broadcast) and tests it on the 16 pixels of its column that
// it keeps in registers, in table order (its last-wins tie rule needs it).
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
#define RB_TILE_PIX (RB_TILE_H * RB_TILE_W)
#define RB_THREADS 512
#define RB_PIX 16  // pixels of one column per thread: TILE_H * TILE_W / THREADS
#define RB_DEPTH_STRIDE 16
#define RB_VIS_STRIDE 24
#define RB_VIS_CHUNK 256  // 24 KB
#define RB_ONE_BITS 0x3F800000  // 1.0f
#define K4_THREADS 512
#define K4_ITEM_ROWS 1024   // ops/raster_binned.py K4_ITEM_ROWS
#define K4_SMALL_BOX 32     // pixels a thread tests alone

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

// min(*slot, z) on float storage by integer atomics: a non-negative float
// orders as its bits read as a signed int, a negative one inversely as its
// bits read unsigned. -0.0 is stored as 0.0 (they compare equal), and a NaN
// as all ones, which both atomics keep: a NaN candidate wins, as in the
// plain version's and the JAX kernel's minimum.
__device__ __forceinline__ void depth_min(float* slot, float z) {
  int bits = z != z ? -1 : __float_as_int(z);
  if (bits == static_cast<int>(0x80000000u)) bits = 0;
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(slot), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(slot), static_cast<unsigned int>(bits));
  }
}

struct DepthRow {
  float a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, z1, z2, ia;
};

__device__ __forceinline__ DepthRow load_depth_row(const float* __restrict__ table,
                                                   int row) {
  const float4* q = reinterpret_cast<const float4*>(table) +
                    static_cast<int64_t>(row) * (RB_DEPTH_STRIDE / 4);
  const float4 u = __ldg(q), v = __ldg(q + 1), w = __ldg(q + 2), s = __ldg(q + 3);
  return {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w, s.x};
}

// One (row, pixel) test in the plain version's order ((A*x + B*y) + C per
// edge); lowers the tile's depth at pixel (x, y) of the tile at (tx0, ty0).
__device__ __forceinline__ void depth_test(const DepthRow& q, int x, int y,
                                           int tx0, int ty0, float* depth) {
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float e0 = q.a0 * px + q.b0 * py + q.c0;
  const float e1 = q.a1 * px + q.b1 * py + q.c1;
  const float e2 = q.a2 * px + q.b2 * py + q.c2;
  if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
    const float z = (e1 * q.z0 + e2 * q.z1 + e0 * q.z2) * q.ia;
    float* slot = depth + (y - ty0) * RB_TILE_W + (x - tx0);
    if (!(z >= *slot)) depth_min(slot, z);  // skips most atomics; a stale read only costs one
  }
}

struct Box {
  int x0, x1, y0, y1;
};

// Row `row`'s pixel box clipped to the tile at (tx0, ty0); empty where
// x1 < x0 or y1 < y0.
__device__ __forceinline__ Box tile_box(const int4* __restrict__ boxes, int row,
                                        int tx0, int ty0) {
  const int4 b = __ldg(boxes + row);  // x0, x1, y0, y1
  return {max(b.x, tx0), min(b.y, tx0 + RB_TILE_W - 1), max(b.z, ty0),
          min(b.w, ty0 + RB_TILE_H - 1)};
}

__global__ void __launch_bounds__(K4_THREADS)
k4_depth_kernel(const float* __restrict__ table, const int4* __restrict__ boxes,
                const int* __restrict__ starts, const int* __restrict__ counts,
                int* __restrict__ plan, int n_tiles, int nx, int g_base,
                int g_count, int g_items, int width, float* __restrict__ out) {
  __shared__ float depth[RB_TILE_PIX];
  __shared__ int big[K4_ITEM_ROWS];  // rows of the item for the warp path
  __shared__ int n_big, item;
  const int total = __ldg(plan + n_tiles - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(plan + n_tiles, 1);
    __syncthreads();
    const int i = item;
    if (i >= total) return;
    // The item's tile: the first t with plan[t] > i.
    int lo = 0, hi = n_tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(plan + mid) > i) hi = mid; else lo = mid + 1;
    }
    const int t = lo;
    const int tile_first = t > 0 ? __ldg(plan + t - 1) : 0;
    const bool alone = __ldg(plan + t) - tile_first == 1;
    const int k = i - tile_first;
    int first, n;
    if (k < g_items) {
      first = g_base + k * K4_ITEM_ROWS;
      n = min(K4_ITEM_ROWS, g_count - k * K4_ITEM_ROWS);
    } else {
      const int s = (k - g_items) * K4_ITEM_ROWS;
      first = __ldg(starts + t) + s;
      n = min(K4_ITEM_ROWS, __ldg(counts + t) - s);
    }
    const int tx0 = (t % nx) * RB_TILE_W, ty0 = (t / nx) * RB_TILE_H;
    for (int p = threadIdx.x; p < RB_TILE_PIX; p += blockDim.x) depth[p] = 1.0f;
    if (threadIdx.x == 0) n_big = 0;
    __syncthreads();

    // Small boxes: a row per thread.
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const Box b = tile_box(boxes, first + j, tx0, ty0);
      if (b.x1 < b.x0 || b.y1 < b.y0) continue;
      if ((b.x1 - b.x0 + 1) * (b.y1 - b.y0 + 1) > K4_SMALL_BOX) {
        big[atomicAdd(&n_big, 1)] = first + j;
        continue;
      }
      const DepthRow q = load_depth_row(table, first + j);
      for (int y = b.y0; y <= b.y1; ++y) {
        for (int x = b.x0; x <= b.x1; ++x) depth_test(q, x, y, tx0, ty0, depth);
      }
    }
    __syncthreads();

    // Large boxes: a row per warp, its pixels over the lanes.
    for (int j = warp; j < n_big; j += K4_THREADS / 32) {
      const int row = big[j];
      const Box b = tile_box(boxes, row, tx0, ty0);
      const int bw = b.x1 - b.x0 + 1;
      const int area = bw * (b.y1 - b.y0 + 1);
      const DepthRow q = load_depth_row(table, row);
      for (int p = lane; p < area; p += 32) {
        depth_test(q, b.x0 + p % bw, b.y0 + p / bw, tx0, ty0, depth);
      }
    }
    __syncthreads();

    // The pixels this item lowered (boxes lie on the screen).
    for (int p = threadIdx.x; p < RB_TILE_PIX; p += blockDim.x) {
      const float v = depth[p];
      if (__float_as_int(v) == RB_ONE_BITS) continue;
      float* o = out + static_cast<int64_t>(ty0 + p / RB_TILE_W) * width + tx0 +
                 p % RB_TILE_W;
      if (alone) *o = v; else depth_min(o, v);
    }
    __syncthreads();  // before the next item clears `depth` and sets `item`
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
// The wrapper (ops/raster_binned.py) checks shapes, types and limits and
// clears `out` to 1.0; these return cudaGetLastError() after the launch.
// K4's grid: as many blocks as stay resident on the card's SMs at once.
extern "C" int k4_depth_binned(const float* table, const int* boxes,
                               const int* starts, const int* counts, int* plan,
                               int n_tiles, int nx, int g_base, int g_count,
                               int g_items, int width, float* out, void* stream) {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k4_depth_kernel,
                                                          K4_THREADS, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  k4_depth_kernel<<<grid, K4_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, reinterpret_cast<const int4*>(boxes), starts, counts, plan, n_tiles,
      nx, g_base, g_count, g_items, width, out);
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

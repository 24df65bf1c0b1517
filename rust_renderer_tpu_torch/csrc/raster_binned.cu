// K4 (depth) and K5 (visibility buffer): tile-binned triangle rasterization
// over 32x256-pixel tiles.
//
// Replaces the TPU kernels rust_renderer_tpu/ops/raster_binned.py::
// _depth_kernel (K4, launched by _run / rasterize_depth_binned) and
// _vis_kernel (K5, launched by _run_vis / rasterize_binned). Same contract
// over the table that ops/raster_binned.py::bin_triangles builds:
//   table (R, 16) f32 for K4, (R, 28) f32 for K5, rows contiguous:
//     [A0,B0,C0, A1,B1,C1, A2,B2,C2, z0,dzdx,dzdy, inv_abs_area, x0,y0, 0],
//     (x0, y0) the first vertex's screen position, z0 its depth and (dzdx,
//     dzdy) the depth's gradient; K5 rows go on with [iw0,iw1,iw2,
//     b0u,b0v,b1u,b1v,b2u,b2v, orig_id, 0,0].
//   rows [g_base, g_base + g_count) are the global list, every tile's
//   segment is rows [starts[t], starts[t] + counts[t]). g_base is static
//   (the table's shape); g_count lives on the device (Bins.g_count), and the
//   plan kernel copies it into `gmeta` = (g_count, g_items) beside the
//   plan, where K4 and K5 read it, so a launch needs no host read.
//   K4: depth = min(1, least z of the rows whose three edge functions are
//       >= 0 at the pixel center), z = (z0 + dzdx*dx) + dzdy*dy, (dx, dy) the
//       center's offset from the first vertex.
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
//   - each row is tested only on its pixel box (Bins.row_box, clipped here to
//     the item's tile; a segment row meets only its own tile's items): K4
//     tests exactly the plain version's pairs, in its operation order, and a
//     global row that misses the tile costs one comparison;
//   - the work is cut into items of at most K4_ITEM_ROWS rows of one tile
//     (the global list, then the segment), numbered by a cumulative sum per
//     tile (`plan`, made on the device from counts by plan_kernel, which
//     ops/raster_binned.py::depth_plan launches); a persistent grid sized to
//     the SMs takes items from a counter in `plan`, so no item count is
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
// K5: the same work (each row on its box's pixels, ~20 operations a pair), and
// the same two obstacles, so the same scheme: K4's plan and persistent grid,
// each row tested on its box only. K5 keeps the row that is inside, has the
// least z <= 1 and is the latest of the walk on a tie (global list, then the
// segment). That is the least key (float_order_key(z) << 32) | (0x7FFFFFFF -
// pos) over the pixel's candidates, pos the row's place in the walk: the key
// vis_binned_plain reduces, kept with its sign bit flipped so that the
// unsigned order is its order. An item lowers its tile's keys in shared
// memory (64 KB) with 64-bit atomic minima and then the global key plane, so
// the result does not depend on the schedule. A second pass decodes each
// pixel's row and computes (depth, tri, u, v) once, in the plain version's
// operation order. A call is the plan kernel, a memset of the key plane and
// the two passes: as PyTorch's small operations, the plan and the boxes'
// clip had cost K5 about as much device time as its kernels (PERF.md).
//
// The operation order follows the plain PyTorch versions; build with
// -fmad=false so no multiply-add is contracted and K4's depth is bit-equal
// to the plain version on the same table. The edge functions decide
// coverage as the JAX kernels do; depth and barycentrics are interpolated
// from the first vertex, since at texel coordinates in the thousands A*x and
// C cancel in float32 (the JAX kernels' (e1*z0 + e2*z1 + e0*z2) * ia was off
// by up to 0.03 on a 4096^2 shadow cascade; the depth plane by 7.2e-8 at most).

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#define RB_TILE_H 32
#define RB_TILE_W 256
#define RB_TILE_PIX (RB_TILE_H * RB_TILE_W)
#define RB_DEPTH_STRIDE 16
#define RB_VIS_STRIDE 28
#define RB_ONE_BITS 0x3F800000  // 1.0f
#define K4_THREADS 512
#define K4_ITEM_ROWS 1024   // ops/raster_binned.py K4_ITEM_ROWS
#define K4_SMALL_BOX 32     // pixels a thread tests alone
#define K5_THREADS 512
#define K5_DECODE_THREADS 256
#define PLAN_THREADS 1024
#define K5_KEY_NONE 0xFFFFFFFFFFFFFFFFull  // a pixel no row covers

namespace {

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
  float a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, dzdx, dzdy, ia, x0, y0;
};

__device__ __forceinline__ DepthRow load_depth_row(const float* __restrict__ table,
                                                   int row) {
  const float4* q = reinterpret_cast<const float4*>(table) +
                    static_cast<int64_t>(row) * (RB_DEPTH_STRIDE / 4);
  const float4 u = __ldg(q), v = __ldg(q + 1), w = __ldg(q + 2), s = __ldg(q + 3);
  return {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w, s.x, s.y, s.z};
}

// Whether the pixel center (px, py) is inside row q: its three edge
// functions, (A*x + B*y) + C each, >= 0.
__device__ __forceinline__ bool inside(const DepthRow& q, float px, float py) {
  const float e0 = q.a0 * px + q.b0 * py + q.c0;
  const float e1 = q.a1 * px + q.b1 * py + q.c1;
  const float e2 = q.a2 * px + q.b2 * py + q.c2;
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
}

// The depth of row q at (px, py), in the plain version's order (_depth): its
// plane from the first vertex.
__device__ __forceinline__ float depth_at(const DepthRow& q, float px, float py) {
  return q.z0 + q.dzdx * (px - q.x0) + q.dzdy * (py - q.y0);
}

// The depth and barycentrics of row q at (px, py), in the plain version's
// order (_interpolate): l1 and l2 from the edge functions through the first
// vertex, taken relative to it, over the area; l0 = 1 - l1 - l2.
__device__ __forceinline__ float interpolate(const DepthRow& q, float px, float py,
                                             float& l0, float& l1, float& l2) {
  const float dx = px - q.x0, dy = py - q.y0;
  l1 = (q.a2 * dx + q.b2 * dy) * q.ia;
  l2 = (q.a0 * dx + q.b0 * dy) * q.ia;
  l0 = 1.0f - l1 - l2;
  return q.z0 + q.dzdx * dx + q.dzdy * dy;
}

// One (row, pixel) test; lowers the tile's depth at pixel (x, y) of the
// tile at (tx0, ty0).
__device__ __forceinline__ void depth_test(const DepthRow& q, int x, int y,
                                           int tx0, int ty0, float* depth) {
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  if (inside(q, px, py)) {
    const float z = depth_at(q, px, py);
    float* slot = depth + (y - ty0) * RB_TILE_W + (x - tx0);
    if (!(z >= *slot)) depth_min(slot, z);  // skips most atomics; a stale read only costs one
  }
}

struct Box {
  int x0, x1, y0, y1;
};

// Row `row`'s pixel box (Bins.row_box: int64 x0, x1, y0, y1, the triangle's
// box widened by one pixel) clipped to the tile at (tx0, ty0); empty where
// x1 < x0 or y1 < y0. For a segment row, which the kernels meet only in its
// own tile's items, this is row_boxes'.
__device__ __forceinline__ Box tile_box(const long long* __restrict__ x0,
                                        const long long* __restrict__ x1,
                                        const long long* __restrict__ y0,
                                        const long long* __restrict__ y1, int row, int tx0,
                                        int ty0) {
  return {static_cast<int>(max(__ldg(x0 + row), static_cast<long long>(tx0))),
          static_cast<int>(min(__ldg(x1 + row), static_cast<long long>(tx0 + RB_TILE_W - 1))),
          static_cast<int>(max(__ldg(y0 + row), static_cast<long long>(ty0))),
          static_cast<int>(min(__ldg(y1 + row), static_cast<long long>(ty0 + RB_TILE_H - 1)))};
}

// The plan of K4 and K5, one block on the device: gmeta = (g_count, g_items
// = ceil(g_count / K4_ITEM_ROWS)), ends[t] the items of tiles 0..t (each
// tile g_items global items and ceil(counts[t] / K4_ITEM_ROWS) segment
// items), then the item counter ends[n_tiles] = 0.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ counts, const int* __restrict__ g_count, int n_tiles,
            int* __restrict__ ends, int* __restrict__ gmeta) {
  __shared__ int warp_sums[PLAN_THREADS / 32];
  __shared__ int carry, g_items;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    const int g = __ldg(g_count);
    carry = 0;
    g_items = (g + K4_ITEM_ROWS - 1) / K4_ITEM_ROWS;
    gmeta[0] = g;
    gmeta[1] = g_items;
  }
  __syncthreads();
  for (int base = 0; base < n_tiles; base += PLAN_THREADS) {
    const int t = base + threadIdx.x;
    int v = t < n_tiles ? (__ldg(counts + t) + K4_ITEM_ROWS - 1) / K4_ITEM_ROWS + g_items : 0;
    for (int o = 1; o < 32; o <<= 1) {  // inclusive scan of the warp
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    if (t < n_tiles) ends[t] = before + v;
    __syncthreads();
    if (threadIdx.x == PLAN_THREADS - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) ends[n_tiles] = 0;
}

__global__ void __launch_bounds__(K4_THREADS)
k4_depth_kernel(const float* __restrict__ table, const long long* __restrict__ x0,
                const long long* __restrict__ x1, const long long* __restrict__ y0,
                const long long* __restrict__ y1, const int* __restrict__ starts, const int* __restrict__ counts,
                int* __restrict__ plan, const int* __restrict__ gmeta, int n_tiles, int nx,
                int g_base, int width, float* __restrict__ out) {
  __shared__ float depth[RB_TILE_PIX];
  __shared__ int big[K4_ITEM_ROWS];  // rows of the item for the warp path
  __shared__ int n_big, item;
  const int total = __ldg(plan + n_tiles - 1);
  const int g_count = __ldg(gmeta), g_items = __ldg(gmeta + 1);
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
      const Box b = tile_box(x0, x1, y0, y1, first + j, tx0, ty0);
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
      const Box b = tile_box(x0, x1, y0, y1, row, tx0, ty0);
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

// K5's key of a candidate at walk position pos (vis_binned_plain's int64
// key, its sign bit flipped): z orders as float_order_key(z), -0.0 as 0.0.
__device__ __forceinline__ unsigned long long vis_key(float z, int pos) {
  int bits = __float_as_int(z);
  if (bits == static_cast<int>(0x80000000u)) bits = 0;
  const long long order = bits < 0 ? -static_cast<long long>(bits & 0x7FFFFFFF) : bits;
  const long long key = order * 4294967296LL + (0x7FFFFFFF - pos);
  return static_cast<unsigned long long>(key) ^ 0x8000000000000000ull;
}

// A K5 row's first 16 columns, which are a K4 row.
__device__ __forceinline__ DepthRow load_vis_row(const float* __restrict__ table,
                                               int row) {
  const float4* q = reinterpret_cast<const float4*>(table) +
                    static_cast<int64_t>(row) * (RB_VIS_STRIDE / 4);
  const float4 u = __ldg(q), v = __ldg(q + 1), w = __ldg(q + 2), s = __ldg(q + 3);
  return {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w, s.x, s.y, s.z};
}

// One (row, pixel) test in the plain version's order (_depth): where
// inside and z <= 1, lowers the tile's key at pixel (x, y). The high word of
// a key only falls, so a candidate whose high word is above it can skip the
// atomic; a 32-bit read of it is never torn.
__device__ __forceinline__ void vis_test(const DepthRow& q, int x, int y, int tx0,
                                         int ty0, int pos,
                                         unsigned long long* keys) {
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  if (!inside(q, px, py)) return;
  const float z = depth_at(q, px, py);
  if (!(z <= 1.0f)) return;
  const unsigned long long key = vis_key(z, pos);
  unsigned long long* slot = keys + (y - ty0) * RB_TILE_W + (x - tx0);
  const unsigned high = reinterpret_cast<const volatile unsigned*>(slot)[1];
  if (static_cast<unsigned>(key >> 32) <= high) atomicMin(slot, key);
}

// K5's first pass: K4's items over the same plan, lowering a key plane
// (cleared to K5_KEY_NONE) instead of a depth.
__global__ void __launch_bounds__(K5_THREADS)
k5_key_kernel(const float* __restrict__ table, const long long* __restrict__ x0,
              const long long* __restrict__ x1, const long long* __restrict__ y0,
              const long long* __restrict__ y1,
              const int* __restrict__ starts, const int* __restrict__ counts,
              int* __restrict__ plan, const int* __restrict__ gmeta, int n_tiles, int nx,
              int g_base, int width, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long keys[];  // RB_TILE_PIX
  __shared__ int big[K4_ITEM_ROWS];
  __shared__ int n_big, item;
  const int total = __ldg(plan + n_tiles - 1);
  const int g_count = __ldg(gmeta), g_items = __ldg(gmeta + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(plan + n_tiles, 1);
    __syncthreads();
    const int i = item;
    if (i >= total) return;
    int lo = 0, hi = n_tiles - 1;  // the item's tile: the first t with plan[t] > i
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(plan + mid) > i) hi = mid; else lo = mid + 1;
    }
    const int t = lo;
    const int tile_first = t > 0 ? __ldg(plan + t - 1) : 0;
    const bool alone = __ldg(plan + t) - tile_first == 1;
    const int k = i - tile_first;
    int first, n, pos0;  // pos0: the walk position of row `first`
    if (k < g_items) {
      pos0 = k * K4_ITEM_ROWS;
      first = g_base + pos0;
      n = min(K4_ITEM_ROWS, g_count - pos0);
    } else {
      const int s = (k - g_items) * K4_ITEM_ROWS;
      first = __ldg(starts + t) + s;
      n = min(K4_ITEM_ROWS, __ldg(counts + t) - s);
      pos0 = g_count + s;
    }
    const int tx0 = (t % nx) * RB_TILE_W, ty0 = (t / nx) * RB_TILE_H;
    for (int p = threadIdx.x; p < RB_TILE_PIX; p += blockDim.x) keys[p] = K5_KEY_NONE;
    if (threadIdx.x == 0) n_big = 0;
    __syncthreads();

    for (int j = threadIdx.x; j < n; j += blockDim.x) {  // small boxes: a row per thread
      const Box b = tile_box(x0, x1, y0, y1, first + j, tx0, ty0);
      if (b.x1 < b.x0 || b.y1 < b.y0) continue;
      if ((b.x1 - b.x0 + 1) * (b.y1 - b.y0 + 1) > K4_SMALL_BOX) {
        big[atomicAdd(&n_big, 1)] = j;
        continue;
      }
      const DepthRow q = load_vis_row(table, first + j);
      for (int y = b.y0; y <= b.y1; ++y) {
        for (int x = b.x0; x <= b.x1; ++x) vis_test(q, x, y, tx0, ty0, pos0 + j, keys);
      }
    }
    __syncthreads();

    for (int w = warp; w < n_big; w += K5_THREADS / 32) {  // large: a row per warp
      const int j = big[w];
      const Box b = tile_box(x0, x1, y0, y1, first + j, tx0, ty0);
      const int bw = b.x1 - b.x0 + 1;
      const int area = bw * (b.y1 - b.y0 + 1);
      const DepthRow q = load_vis_row(table, first + j);
      for (int p = lane; p < area; p += 32) {
        vis_test(q, b.x0 + p % bw, b.y0 + p / bw, tx0, ty0, pos0 + j, keys);
      }
    }
    __syncthreads();

    for (int p = threadIdx.x; p < RB_TILE_PIX; p += blockDim.x) {
      const unsigned long long v = keys[p];
      if (v == K5_KEY_NONE) continue;
      unsigned long long* o = out + static_cast<int64_t>(ty0 + p / RB_TILE_W) * width +
                              tx0 + p % RB_TILE_W;
      if (alone) *o = v; else atomicMin(o, v);
    }
    __syncthreads();  // before the next item clears `keys` and sets `item`
  }
}

// K5's second pass, a thread per pixel: the winning row of its key, and
// (depth, tri, u, v) computed from it in vis_binned_plain's operation order;
// (1, -1, 0, 0) where no row covers the pixel.
__global__ void __launch_bounds__(K5_DECODE_THREADS)
k5_decode_kernel(const float* __restrict__ table,
                 const unsigned long long* __restrict__ keys,
                 const int* __restrict__ starts, const int* __restrict__ gmeta, int g_base,
                 int nx, int width, int n_pix, float* __restrict__ depth,
                 int* __restrict__ tri, float* __restrict__ u_out,
                 float* __restrict__ v_out) {
  const int i = blockIdx.x * K5_DECODE_THREADS + threadIdx.x;
  if (i >= n_pix) return;
  const int g_count = __ldg(gmeta);
  const unsigned long long key = keys[i];
  if (key == K5_KEY_NONE) {
    depth[i] = 1.0f;
    tri[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    return;
  }
  const int pos = 0x7FFFFFFF - static_cast<int>(key & 0xFFFFFFFFull);
  const int x = i % width, y = i / width;
  const int tile = (y / RB_TILE_H) * nx + x / RB_TILE_W;
  const int row = pos < g_count ? g_base + pos : __ldg(starts + tile) + pos - g_count;
  const DepthRow r = load_vis_row(table, row);
  const float* q = table + static_cast<int64_t>(row) * RB_VIS_STRIDE;
  float l0, l1, l2;
  const float z = interpolate(r, static_cast<float>(x) + 0.5f, static_cast<float>(y) + 0.5f,
                              l0, l1, l2);
  // perspective correction, composed through the original triangle's
  // barycentrics (ops/raster.py semantics)
  const float lw0 = l0 * __ldg(q + 16), lw1 = l1 * __ldg(q + 17), lw2 = l2 * __ldg(q + 18);
  const float denom = lw0 + lw1 + lw2;
  const float rden = 1.0f / (fabsf(denom) < 1e-12f ? 1.0f : denom);
  depth[i] = z;
  tri[i] = static_cast<int>(__ldg(q + 25));
  u_out[i] = (lw0 * __ldg(q + 19) + lw1 * __ldg(q + 21) + lw2 * __ldg(q + 23)) * rden;
  v_out[i] = (lw0 * __ldg(q + 20) + lw1 * __ldg(q + 22) + lw2 * __ldg(q + 24)) * rden;
}

}  // namespace

#if defined(__CUDACC__)
// The wrappers (ops/raster_binned.py) check shapes, types and limits; these
// return cudaGetLastError() after the launches. x0, x1, y0, y1 are
// Bins.row_box, `plan` holds n_tiles + 1 ints and `gmeta` 2 (raster_plan's,
// from Bins.counts and the device int Bins.g_count). The kernels' grids: as
// many blocks as stay resident on the card's SMs at once.
extern "C" int raster_plan(const int* counts, const int* g_count, int n_tiles, int* plan,
                           int* gmeta, void* stream) {
  plan_kernel<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(counts, g_count,
                                                                         n_tiles, plan, gmeta);
  return static_cast<int>(cudaGetLastError());
}

// K4: `out` cleared to 1.0 by the wrapper.
extern "C" int k4_depth_binned(const float* table, const long long* x0,
                               const long long* x1, const long long* y0,
                               const long long* y1, const int* starts,
                               const int* counts, int* plan, const int* gmeta,
                               int n_tiles, int nx, int g_base, int width, float* out,
                               void* stream) {
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
      table, x0, x1, y0, y1, starts, counts, plan, gmeta, n_tiles, nx, g_base, width, out);
  return static_cast<int>(cudaGetLastError());
}

// K5: `keys` holds height * width keys; this clears them, runs the key pass
// and then the decode.
extern "C" int k5_vis_binned(const float* table, const long long* x0,
                             const long long* x1, const long long* y0,
                             const long long* y1, const int* starts,
                             const int* counts, int* plan, const int* gmeta,
                             int n_tiles, int nx, int g_base, int width,
                             int height, unsigned long long* keys, float* depth,
                             int* tri, float* u, float* v, void* stream) {
  const int smem = RB_TILE_PIX * static_cast<int>(sizeof(unsigned long long));
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        k5_key_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_key_kernel,
                                                          K5_THREADS, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = width * height;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, sizeof(unsigned long long) * n_pix, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  k5_key_kernel<<<grid, K5_THREADS, smem, s>>>(table, x0, x1, y0, y1, starts, counts, plan,
                                              gmeta, n_tiles, nx, g_base, width, keys);
  k5_decode_kernel<<<(n_pix + K5_DECODE_THREADS - 1) / K5_DECODE_THREADS,
                     K5_DECODE_THREADS, 0, s>>>(table, keys, starts, gmeta, g_base, nx,
                                                width, n_pix, depth, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}
#endif

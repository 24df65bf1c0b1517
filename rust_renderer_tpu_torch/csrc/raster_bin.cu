// The binning of K4 and K5 (csrc/raster_binned.cu) as one library:
// ops/raster_binned.py's `tri_rows`, then `bin_triangles`, on the card.
//
// Same contract as those two functions, which stay as its plain version:
// from clip-space vertices (V, 4) f32 and triangles (T, 3) i32, the Bins that
// K4 and K5 walk, bit for bit in every slot. With t2 = 2T (each triangle's
// two near-clip pieces: piece j < T is triangle j's first, piece T + j its
// second) and R = 9 * t2 slots:
//   table (R, stride) f32, stride 16 (depth rows) or 28 (visibility rows):
//     [8 * t2 segment slots | t2 global slots]; a slot no walk reads holds
//     the dead row (C = -1: never inside; a visibility row's triangle -1);
//   starts, counts (n_tiles,) i32: each tile's segment;
//   g_count () i32: the global list's rows, on the device;
//   row_tile (R,) i64: a live segment slot's tile, -1 elsewhere;
//   row_box (R,) i64 x 4: each slot's pixel box (0, -1, 0, -1 where dead).
// Pair p = s * t2 + j is piece j's span slot s (its tile (ty0 + s / 2, tx0 +
// s % 2) where the piece spans it); the segments list the live pairs sorted
// by tile, p's order within a tile (torch.sort(stable=True)'s), and the
// global list the global pieces in id order.
//
// What bounds it on an H100: the bytes the contract fixes. A 4096^2 shadow
// cascade of 259,932 triangles has R = 4,678,776 slots: the table 299 MB,
// the boxes 150 MB, row_tile 37 MB, ~487 MB a call (~0.15 ms at 3.35 TB/s).
// The eager version took ~5.6 ms a cascade in ~430 launches: the [src]
// gathers of the table and boxes, and a multi-pass radix sort of 8 * t2
// int64 keys whose tile needs 12 bits. Here a call is five kernels:
//   bin_setup_kernel, a thread a piece: the near clip (clip_triangles_near),
//     the viewport (clip_to_screen), the row, its validity, tile span and
//     pixel box (tri_rows), into scratch; a piece that is live (on screen,
//     binned or global) writes its row, its box and its tile code;
//   bin_hist_kernel, a block a pair row (span slot s, BIN_CHUNK pieces): its
//     live pairs counted by tile in shared memory, and its global pieces;
//   bin_colscan_kernel: each tile's counts scanned over the pair rows in
//     their order (exclusive), and each tile's total (`counts`);
//   bin_tilescan_kernel, one block: `starts` (the totals scanned), the live
//     pairs' count, the global pieces' offsets by chunk and `g_count`;
//   bin_fill_kernel, a block a pair row: each live pair's slot, its rank
//     among the row's earlier pairs of its tile counted warp after warp
//     (within a warp by __match_any_sync), so that a tile's pairs keep p's
//     order; each global piece's slot by a ballot scan; the live slots copied
//     from scratch; then, over the whole grid, every other slot written as
//     the dead row with an empty box. Every slot is written once.
// The scratch comes from the wrapper's torch.empty and nothing is read back
// to the host, so a frame that calls it stays capturable.
//
// The float32 operations are the plain version's, in its order: build with
// -fmad=false (no multiply-add contracted) and IEEE division, so each
// operation rounds as PyTorch's elementwise kernel does. Its division by a
// Python scalar (v / TILE_W) is a product by the reciprocal there; the tile
// sizes are powers of two, so both are exact.

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <float.h>
#include <stdint.h>

#define BIN_TILE_H 32
#define BIN_TILE_W 256
#define BIN_SPAN_X 2
#define BIN_SPAN_Y 4
#define BIN_SLOTS (BIN_SPAN_X * BIN_SPAN_Y)
#define BIN_CHUNK 4096        // pieces of a pair row (ops/raster_binned.py BIN_CHUNK)
#define BIN_MAX_TILES 49152   // tile counters in shared memory (ops/raster_binned.py)
#define BIN_THREADS 256
#define BIN_WARPS (BIN_THREADS / 32)
#define BIN_SCAN_THREADS 1024
#define BIN_NOT_LIVE -1       // a piece's tile code: not on screen, or no area
#define BIN_GLOBAL -2         // spans more than BIN_SPAN_X x BIN_SPAN_Y tiles

namespace {

struct V4 {
  float x, y, z, w;
};

struct B2 {
  float u, v;
};

__device__ __forceinline__ V4 load_vertex(const float* __restrict__ clip, int i) {
  const float* p = clip + 4LL * i;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

template <typename T>
__device__ __forceinline__ T pick3(int k, T a, T b, T c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// clip_triangles_near's isect: the parameter of the crossing of clip z = 0
// on the edge a -> b, and the points there.
__device__ __forceinline__ float isect_t(float za, float zb) {
  const float d = za - zb;
  return za / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__device__ __forceinline__ V4 lerp4(V4 a, V4 b, float t) {
  return {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t, a.z + (b.z - a.z) * t,
          a.w + (b.w - a.w) * t};
}

__device__ __forceinline__ B2 lerp2(B2 a, B2 b, float t) {
  return {a.u + (b.u - a.u) * t, a.v + (b.v - a.v) * t};
}

// torch's amin / amax: NaN wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// tri_rows' tile(): nan_to_num, clip to +-1e9, floor of v / size, clip to
// the grid.
__device__ __forceinline__ int tile_of(float v, float size, int n) {
  if (v != v) v = 0.0f;
  if (isinf(v)) v = v > 0.0f ? FLT_MAX : -FLT_MAX;
  v = fminf(fmaxf(v, -1e9f), 1e9f);
  const long long t = static_cast<long long>(floorf(v / size));
  return static_cast<int>(min(max(t, 0LL), static_cast<long long>(n - 1)));
}

// pixel_box's lo / hi: floor of the clamped coordinate, -1 / +1.
__device__ __forceinline__ long long box_floor(float v, int n) {
  return static_cast<long long>(floorf(clamp_nan(v, -4.0f, static_cast<float>(n + 4))));
}

// A pair's tile: piece code `code` (its first tile, span and flags) in span
// slot (dy, dx); -1 where the pair is not live.
__device__ __forceinline__ int pair_tile(int code, int dy, int dx, int nx) {
  if (code < 0) return -1;
  const int span_h = (code & 3) + 1, span_w = ((code >> 2) & 1) + 1;
  if (dy >= span_h || dx >= span_w) return -1;
  return (code >> 3) + dy * nx + dx;
}

// One piece: its clip-space triangle, screen rows and tiles, as tri_rows
// computes them (the plain version's operation order throughout). Writes
// its tile code, and where live its row and pixel box.
__global__ void __launch_bounds__(BIN_THREADS)
bin_setup_kernel(const float* __restrict__ clip, const int* __restrict__ indices, int t_count,
                 int width, int height, int nx, int ny, int stride, float* __restrict__ rows,
                 int4* __restrict__ boxes, int* __restrict__ codes) {
  const int j = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (j >= 2 * t_count) return;
  const bool second = j >= t_count;
  const int t = second ? j - t_count : j;
  const V4 p0 = load_vertex(clip, __ldg(indices + 3LL * t));
  const V4 p1 = load_vertex(clip, __ldg(indices + 3LL * t + 1));
  const V4 p2 = load_vertex(clip, __ldg(indices + 3LL * t + 2));

  // clip_triangles_near: rotate so that A, B are the kept pair (2 inside) or
  // A the kept vertex (1 inside).
  const bool in0 = p0.z >= 0.0f, in1 = p1.z >= 0.0f, in2 = p2.z >= 0.0f;
  const int n_inside = in0 + in1 + in2;
  int rot = 0;
  const bool ins[3] = {in0, in1, in2};
  for (int r = 0; r < 3; ++r) {
    if (n_inside == 1 && ins[r]) rot = r;
    if (n_inside == 2 && !ins[r]) rot = (r + 1) % 3;
  }
  const B2 q0 = {0.0f, 0.0f}, q1 = {1.0f, 0.0f}, q2 = {0.0f, 1.0f};
  const V4 pa = pick3(rot, p0, p1, p2), pb = pick3(rot, p1, p2, p0), pc = pick3(rot, p2, p0, p1);
  const B2 ba = pick3(rot, q0, q1, q2), bb = pick3(rot, q1, q2, q0), bc = pick3(rot, q2, q0, q1);
  const bool one = n_inside == 1, two = n_inside == 2;
  V4 v[3];
  B2 b[3];
  bool kept;
  v[0] = pa;
  b[0] = ba;
  if (!second) {
    kept = n_inside >= 1;
    if (one) {
      const float tab = isect_t(pa.z, pb.z), tac = isect_t(pa.z, pc.z);
      v[1] = lerp4(pa, pb, tab);
      b[1] = lerp2(ba, bb, tab);
      v[2] = lerp4(pa, pc, tac);
      b[2] = lerp2(ba, bc, tac);
    } else if (two) {
      const float tbc = isect_t(pb.z, pc.z);
      v[1] = pb;
      b[1] = bb;
      v[2] = lerp4(pb, pc, tbc);
      b[2] = lerp2(bb, bc, tbc);
    } else {
      v[1] = pb;
      b[1] = bb;
      v[2] = pc;
      b[2] = bc;
    }
  } else {
    kept = two;
    const float tbc = isect_t(pb.z, pc.z), tac = isect_t(pa.z, pc.z);
    v[1] = lerp4(pb, pc, tbc);
    b[1] = lerp2(bb, bc, tbc);
    v[2] = lerp4(pa, pc, tac);
    b[2] = lerp2(ba, bc, tac);
  }
  if (!kept) {
    for (int k = 0; k < 3; ++k) v[k] = {0.0f, 0.0f, 0.0f, 0.0f};
  }

  // clip_to_screen, with the negative-viewport Y flip.
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  float x[3], y[3], z[3];
  for (int k = 0; k < 3; ++k) {
    const float sw = fabsf(v[k].w) < 1e-9f ? 1e-9f : v[k].w;
    x[k] = (v[k].x / sw * 0.5f + 0.5f) * fw;
    y[k] = (1.0f - (v[k].y / sw * 0.5f + 0.5f)) * fh;
    z[k] = v[k].z / sw;
  }
  const float area = (x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0]);
  bool valid = v[0].w > 1e-6f && v[1].w > 1e-6f && v[2].w > 1e-6f && fabsf(area) > 1e-12f;
  const float xmin = min_nan(min_nan(x[0], x[1]), x[2]);
  const float xmax = max_nan(max_nan(x[0], x[1]), x[2]);
  const float ymin = min_nan(min_nan(y[0], y[1]), y[2]);
  const float ymax = max_nan(max_nan(y[0], y[1]), y[2]);
  valid = valid && xmax >= 0.0f && xmin < fw && ymax >= 0.0f && ymin < fh;
  if (!valid) {
    codes[j] = BIN_NOT_LIVE;
    return;
  }
  const int tx0 = tile_of(xmin, static_cast<float>(BIN_TILE_W), nx);
  const int tx1 = tile_of(xmax, static_cast<float>(BIN_TILE_W), nx);
  const int ty0 = tile_of(ymin, static_cast<float>(BIN_TILE_H), ny);
  const int ty1 = tile_of(ymax, static_cast<float>(BIN_TILE_H), ny);
  const int span_w = tx1 - tx0 + 1, span_h = ty1 - ty0 + 1;
  codes[j] = (span_w > BIN_SPAN_X || span_h > BIN_SPAN_Y)
                 ? BIN_GLOBAL
                 : ((ty0 * nx + tx0) << 3) | ((span_w - 1) << 2) | (span_h - 1);
  boxes[j] = make_int4(
      static_cast<int>(max(box_floor(xmin, width) - 1, 0LL)),
      static_cast<int>(min(box_floor(xmax, width) + 1, static_cast<long long>(width - 1))),
      static_cast<int>(max(box_floor(ymin, height) - 1, 0LL)),
      static_cast<int>(min(box_floor(ymax, height) + 1, static_cast<long long>(height - 1))));

  // The row: three sign-normalized edge functions, the depth plane from the
  // first vertex, the inverse area and the first vertex's position.
  const float sgn = area > 0.0f ? 1.0f : -1.0f;  // torch.sign of a valid area
  const float ia = fabsf(1.0f / area);
  float e[9];
  for (int k = 0; k < 3; ++k) {
    const int m = (k + 1) % 3;
    e[3 * k] = -(y[m] - y[k]) * sgn;
    e[3 * k + 1] = (x[m] - x[k]) * sgn;
    e[3 * k + 2] = ((y[m] - y[k]) * x[k] - (x[m] - x[k]) * y[k]) * sgn;
  }
  const float dz1 = z[1] - z[0], dz2 = z[2] - z[0];
  float4* out = reinterpret_cast<float4*>(rows + static_cast<int64_t>(j) * stride);
  out[0] = make_float4(e[0], e[1], e[2], e[3]);
  out[1] = make_float4(e[4], e[5], e[6], e[7]);
  out[2] = make_float4(e[8], z[0], (e[6] * dz1 + e[0] * dz2) * ia, (e[7] * dz1 + e[1] * dz2) * ia);
  out[3] = make_float4(ia, x[0], y[0], 0.0f);
  if (stride > 16) {
    // Visibility columns: 1 / w, the original triangle's barycentrics, its id.
    out[4] = make_float4(1.0f / fmaxf(v[0].w, 1e-9f), 1.0f / fmaxf(v[1].w, 1e-9f),
                         1.0f / fmaxf(v[2].w, 1e-9f), b[0].u);
    out[5] = make_float4(b[0].v, b[1].u, b[1].v, b[2].u);
    out[6] = make_float4(b[2].v, static_cast<float>(t), 0.0f, 0.0f);
  }
}

// A pair row's live pairs counted by tile (hist[row][tile]), its live pairs'
// total (row_live) and, for span slot 0, its chunk's global pieces (g_chunk).
__global__ void __launch_bounds__(BIN_THREADS)
bin_hist_kernel(const int* __restrict__ codes, int t2, int n_chunks, int nx, int n_tiles,
                int* __restrict__ hist, int* __restrict__ row_live, int* __restrict__ g_chunk) {
  extern __shared__ int cnt[];  // n_tiles
  __shared__ int live, globals;
  const int row = blockIdx.x, s = row / n_chunks, c = row % n_chunks;
  const int dy = s / BIN_SPAN_X, dx = s % BIN_SPAN_X;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < n_tiles; t += BIN_THREADS) cnt[t] = 0;
  if (threadIdx.x == 0) live = globals = 0;
  __syncthreads();
  const int first = c * BIN_CHUNK, end = min(first + BIN_CHUNK, t2);
  int my_live = 0, my_globals = 0;
  for (int base = first; base < end; base += BIN_THREADS) {
    const int j = base + threadIdx.x;
    const int code = j < end ? __ldg(codes + j) : BIN_NOT_LIVE;
    const int key = pair_tile(code, dy, dx, nx);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[key], __popc(peers));
    my_live += key >= 0;
    my_globals += s == 0 && code == BIN_GLOBAL;
  }
  for (int o = 16; o > 0; o >>= 1) {
    my_live += __shfl_down_sync(0xffffffffu, my_live, o);
    my_globals += __shfl_down_sync(0xffffffffu, my_globals, o);
  }
  if (lane == 0) {
    atomicAdd(&live, my_live);
    atomicAdd(&globals, my_globals);
  }
  __syncthreads();
  int* out = hist + static_cast<int64_t>(row) * n_tiles;
  for (int t = threadIdx.x; t < n_tiles; t += BIN_THREADS) out[t] = cnt[t];
  if (threadIdx.x == 0) {
    row_live[row] = live;
    if (s == 0) g_chunk[c] = globals;
  }
}

// Each tile's column of hist scanned over the pair rows (exclusive, in
// place) and its total into counts: 32 tiles a block, a warp a run of rows.
__global__ void __launch_bounds__(BIN_SCAN_THREADS)
bin_colscan_kernel(int* __restrict__ hist, int n_rows, int n_tiles, int* __restrict__ counts) {
  __shared__ int part[BIN_SCAN_THREADS / 32][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tile = blockIdx.x * 32 + lane;
  const int per_warp = (n_rows + BIN_SCAN_THREADS / 32 - 1) / (BIN_SCAN_THREADS / 32);
  const int r0 = min(warp * per_warp, n_rows), r1 = min(r0 + per_warp, n_rows);
  int sum = 0;
  if (tile < n_tiles) {
    for (int r = r0; r < r1; ++r) sum += hist[static_cast<int64_t>(r) * n_tiles + tile];
  }
  part[warp][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (tile >= n_tiles) return;
  if (warp == BIN_SCAN_THREADS / 32 - 1) counts[tile] = run + sum;
  for (int r = r0; r < r1; ++r) {
    int* h = hist + static_cast<int64_t>(r) * n_tiles + tile;
    const int v = *h;
    *h = run;
    run += v;
  }
}

// out[i] = in[0] + ... + in[i - 1] over n values, by one block; returns the
// sum to every thread.
__device__ int block_exclusive_scan(const int* __restrict__ in, int* __restrict__ out, int n) {
  __shared__ int warp_sums[BIN_SCAN_THREADS / 32];
  __shared__ int carry;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // every thread has read a previous call's carry
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += BIN_SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int x = i < n ? in[i] : 0;
    int v = x;
    for (int o = 1; o < 32; o <<= 1) {  // inclusive scan of the warp
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    if (i < n) out[i] = before + v - x;
    __syncthreads();
    if (threadIdx.x == BIN_SCAN_THREADS - 1) carry = before + v;
    __syncthreads();
  }
  return carry;
}

// starts (the tiles' totals scanned) and the live pairs' count; the global
// pieces' offset by chunk and g_count.
__global__ void __launch_bounds__(BIN_SCAN_THREADS)
bin_tilescan_kernel(const int* __restrict__ counts, int n_tiles, const int* __restrict__ g_chunk,
                    int n_chunks, int* __restrict__ starts, int* __restrict__ n_live,
                    int* __restrict__ g_off, int* __restrict__ g_count) {
  const int live = block_exclusive_scan(counts, starts, n_tiles);
  const int globals = block_exclusive_scan(g_chunk, g_off, n_chunks);
  if (threadIdx.x == 0) {
    *n_live = live;
    *g_count = globals;
  }
}

// Slot `slot` of the table, the boxes and row_tile from piece j's scratch.
__device__ __forceinline__ void copy_row(const float* __restrict__ rows,
                                         const int4* __restrict__ boxes, int j, int64_t slot,
                                         int stride, float* __restrict__ table,
                                         long long* __restrict__ x0, long long* __restrict__ x1,
                                         long long* __restrict__ y0, long long* __restrict__ y1) {
  const float4* src = reinterpret_cast<const float4*>(rows + static_cast<int64_t>(j) * stride);
  float4* dst = reinterpret_cast<float4*>(table + slot * stride);
  for (int k = 0; k < stride / 4; ++k) dst[k] = __ldg(src + k);
  const int4 b = __ldg(boxes + j);
  x0[slot] = b.x;
  x1[slot] = b.y;
  y0[slot] = b.z;
  y1[slot] = b.w;
}

// The dead row's float4 `col` (ops/raster_binned.py::dead_row).
__device__ __forceinline__ float4 dead_quad(int col) {
  switch (col) {
    case 0: return make_float4(0.0f, 0.0f, -1.0f, 0.0f);
    case 1: return make_float4(0.0f, -1.0f, 0.0f, 0.0f);
    case 2: return make_float4(-1.0f, 0.0f, 0.0f, 0.0f);
    case 6: return make_float4(0.0f, -1.0f, 0.0f, 0.0f);  // a visibility row's triangle -1
    default: return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A block a pair row: its live pairs' and (span slot 0) its global pieces'
// slots, the slots copied from scratch; then a share of the dead slots.
__global__ void __launch_bounds__(BIN_THREADS)
bin_fill_kernel(const float* __restrict__ rows, const int4* __restrict__ boxes,
                const int* __restrict__ codes, const int* __restrict__ hist,
                const int* __restrict__ row_live, const int* __restrict__ g_chunk,
                const int* __restrict__ g_off,
                const int* __restrict__ starts, const int* __restrict__ n_live_p,
                const int* __restrict__ g_count_p, int t2, int n_chunks, int nx, int n_tiles,
                int stride, float* __restrict__ table, long long* __restrict__ row_tile,
                long long* __restrict__ x0, long long* __restrict__ x1,
                long long* __restrict__ y0, long long* __restrict__ y1) {
  extern __shared__ int cnt[];  // n_tiles: the next slot of each tile's pairs in this row
  __shared__ int warp_live[BIN_WARPS], warp_globals[BIN_WARPS];
  __shared__ int g_next;
  const int row = blockIdx.x, s = row / n_chunks, c = row % n_chunks;
  const int dy = s / BIN_SPAN_X, dx = s % BIN_SPAN_X;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t g_base = static_cast<int64_t>(BIN_SLOTS) * t2;
  const bool pairs = __ldg(row_live + row) > 0;
  const bool globals = s == 0 && __ldg(g_chunk + c) > 0;
  if (pairs) {
    const int* h = hist + static_cast<int64_t>(row) * n_tiles;
    for (int t = threadIdx.x; t < n_tiles; t += BIN_THREADS) cnt[t] = __ldg(starts + t) + __ldg(h + t);
  }
  if (threadIdx.x == 0) g_next = s == 0 ? __ldg(g_off + c) : 0;
  const int first = c * BIN_CHUNK, end = min(first + BIN_CHUNK, t2);
  for (int base = first; (pairs || globals) && base < end; base += BIN_THREADS) {
    const int j = base + threadIdx.x;
    const int code = j < end ? __ldg(codes + j) : BIN_NOT_LIVE;
    const int key = pair_tile(code, dy, dx, nx);
    const bool glob = s == 0 && code == BIN_GLOBAL;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    const unsigned gmask = __ballot_sync(0xffffffffu, glob);
    const unsigned lmask = __ballot_sync(0xffffffffu, key >= 0);
    if (lane == 0) {
      warp_live[warp] = lmask != 0u;
      warp_globals[warp] = __popc(gmask);
    }
    __syncthreads();
    int g_slot = g_next, g_round = 0;
    for (int w = 0; w < BIN_WARPS; ++w) {
      g_slot += w < warp ? warp_globals[w] : 0;
      g_round += warp_globals[w];
    }
    g_slot += __popc(gmask & lanes_below);
    // The warps in order, each taking its pairs' next slots of their tiles:
    // a tile's pairs keep the order of p within the row.
    int slot = -1;
    for (int w = 0; w < BIN_WARPS; ++w) {
      if (!warp_live[w]) continue;
      if (warp == w) {
        int first_slot = 0;
        if (key >= 0 && lane == leader) {
          first_slot = cnt[key];
          cnt[key] = first_slot + __popc(peers);
        }
        first_slot = __shfl_sync(0xffffffffu, first_slot, leader);
        if (key >= 0) slot = first_slot + __popc(peers & lanes_below);
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read warp_live, warp_globals and g_next
    if (threadIdx.x == 0) g_next += g_round;
    if (slot >= 0) {
      copy_row(rows, boxes, j, slot, stride, table, x0, x1, y0, y1);
      row_tile[slot] = key;
    }
    if (glob) copy_row(rows, boxes, j, g_base + g_slot, stride, table, x0, x1, y0, y1);
  }

  // The dead slots: [n_live, g_base) and [g_base + g_count, R), over the
  // whole grid; row_tile is -1 from n_live on.
  const int64_t n_live = __ldg(n_live_p), g_count = __ldg(g_count_p);
  const int64_t r_slots = g_base + t2;
  const int64_t dead_a = g_base - n_live, dead = dead_a + (t2 - g_count);
  const int64_t threads = static_cast<int64_t>(gridDim.x) * BIN_THREADS;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * BIN_THREADS + threadIdx.x;
  const int quads = stride / 4;
  float4* table4 = reinterpret_cast<float4*>(table);
  for (int64_t f = id; f < dead * quads; f += threads) {
    const int64_t q = f < dead_a * quads ? n_live * quads + f
                                         : (g_base + g_count) * quads + (f - dead_a * quads);
    table4[q] = dead_quad(static_cast<int>(q % quads));
  }
  for (int64_t v = id; v < dead; v += threads) {
    const int64_t i = v < dead_a ? n_live + v : g_base + g_count + (v - dead_a);
    x0[i] = 0;
    x1[i] = -1;
    y0[i] = 0;
    y1[i] = -1;
  }
  for (int64_t i = n_live + id; i < r_slots; i += threads) row_tile[i] = -1;
}

}  // namespace

#if defined(__CUDACC__)
// The wrapper (ops/raster_binned.py::bins_cuda) checks types, shapes and
// limits and allocates: rows (2T, stride) f32 and boxes (2T, 4) i32 of
// scratch, `work` of BIN_WORK ints (below), and the Bins' tensors. Returns
// cudaGetLastError() after the five launches.
extern "C" int raster_bin(const float* clip, const int* indices, int t_count, int width,
                          int height, int stride, float* rows, int* boxes, int* work,
                          float* table, int* starts, int* counts, int* g_count,
                          long long* row_tile, long long* x0, long long* x1, long long* y0,
                          long long* y1, void* stream) {
  static bool configured = false;
  if (!configured) {
    const int most = BIN_MAX_TILES * static_cast<int>(sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(bin_hist_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(bin_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t2 = 2 * t_count;
  const int nx = (width + BIN_TILE_W - 1) / BIN_TILE_W, ny = (height + BIN_TILE_H - 1) / BIN_TILE_H;
  const int n_tiles = nx * ny;
  const int n_chunks = (t2 + BIN_CHUNK - 1) / BIN_CHUNK, n_rows = BIN_SLOTS * n_chunks;
  // work: codes (t2) | hist (n_rows * n_tiles) | row_live (n_rows) |
  // g_chunk, g_off (n_chunks each) | n_live (1)
  int* codes = work;
  int* hist = codes + t2;
  int* row_live = hist + static_cast<int64_t>(n_rows) * n_tiles;
  int* g_chunk = row_live + n_rows;
  int* g_off = g_chunk + n_chunks;
  int* n_live = g_off + n_chunks;
  const int smem = n_tiles * static_cast<int>(sizeof(int));
  int4* box4 = reinterpret_cast<int4*>(boxes);
  bin_setup_kernel<<<(t2 + BIN_THREADS - 1) / BIN_THREADS, BIN_THREADS, 0, s>>>(
      clip, indices, t_count, width, height, nx, ny, stride, rows, box4, codes);
  bin_hist_kernel<<<n_rows, BIN_THREADS, smem, s>>>(codes, t2, n_chunks, nx, n_tiles, hist,
                                                    row_live, g_chunk);
  bin_colscan_kernel<<<(n_tiles + 31) / 32, BIN_SCAN_THREADS, 0, s>>>(hist, n_rows, n_tiles,
                                                                      counts);
  bin_tilescan_kernel<<<1, BIN_SCAN_THREADS, 0, s>>>(counts, n_tiles, g_chunk, n_chunks, starts,
                                                     n_live, g_off, g_count);
  bin_fill_kernel<<<n_rows, BIN_THREADS, smem, s>>>(
      rows, box4, codes, hist, row_live, g_chunk, g_off, starts, n_live, g_count, t2, n_chunks, nx,
      n_tiles, stride, table, row_tile, x0, x1, y0, y1);
  return static_cast<int>(cudaGetLastError());
}
#endif

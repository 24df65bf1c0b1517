// The seed test: per ray, whether one of the live triangles of the k
// largest-area leaf rows occludes it, and the direction the walk then takes
// (zero where occluded, so that the walk retires the ray on entry).
//
// The port of rust_renderer_tpu/ops/bvh.py::make_seed_test (:843-911) and of
// the direction rewrite of its caller make_any_hit (:1501-1505). Neither has a
// Pallas kernel: the JAX function closes over the triangles as trace-time
// constants, and XLA fused its per-triangle tensor operations into one pass.
// Each value of a test is the JAX package's Moller-Trumbore in its operation
// order (built with -fmad=false), with t in (t_min, t_max), so the verdicts
// are the plain version's.
//
// What bounds it on an H100: operations (15 to 53 f32 operations per test,
// against 33 bytes of rays, limits and verdict and 12 of direction per ray).
// The design, one thread per ray:
//   - the live triangles come compacted once per tree into a
//     structure-of-arrays table (ops/bvh.py::seed_table); up to SEED_MAX_TRIS
//     of them are passed by value as a kernel parameter and staged once per
//     block into shared memory: no dead slot, no id load, no global load per
//     test, and every lane of a warp reads the same triangle (a broadcast). A
//     larger table runs as several launches, each on the rays that the ones
//     before left open (their walk direction is not zero);
//   - a test stops at the first condition that fails: the determinant, u in
//     [0, 1] (u > 1 fails u + v <= 1 whenever v >= 0 holds), then v and
//     u + v, then t. The values it computes are the ones the JAX order
//     computes; the ones it skips cannot change the verdict. Rays of one warp
//     are neighbours on the screen, so they mostly leave a triangle at the
//     same stage;
//   - a ray stops at its first occluder (the verdict is an OR), and a ray
//     with a zero direction takes no test: its determinant is 0 (or NaN) for
//     every triangle.
// Measured and dropped (PERF.md): lanes refilled from their warp's rays as
// their rays are answered, with and without loading the next ray ahead (the
// warp-wide votes and the refills cost more than the idle lanes did), and a
// correctly rounded reciprocal in place of the division (the same code).

#include "traverse_common.cuh"

#define SEED_MAX_TRIS 96  // per launch (ops/bvh.py SEED_LAUNCH_TRIS): 8 leaf rows of 12 slots
#define SEED_THREADS 128

namespace {

// Component c of triangle j at g[c][j]: v0.xyz, e1.xyz, e2.xyz.
struct SeedTris {
  float g[9][SEED_MAX_TRIS];
};

struct SeedRay {
  float ox, oy, oz, dx, dy, dz, t_min, t_max;
};

// Whether triangle j of the table occludes ray `r`.
__device__ __forceinline__ bool occludes(const float (*g)[SEED_MAX_TRIS], int j,
                                         const SeedRay& r) {
  const float e1x = g[3][j], e1y = g[4][j], e1z = g[5][j];
  const float e2x = g[6][j], e2y = g[7][j], e2z = g[8][j];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - g[0][j], tvy = r.oy - g[1][j], tvz = r.oz - g[2][j];
  const float u = (tvx * px + tvy * py + tvz * pz) * inv;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.t_min && t < r.t_max;
}

// The first launch of a table writes every ray's verdict and walk
// direction; a later one reads the direction the launches before it wrote
// (`direction` is then `walk_dir`) and writes only the rays it seeds.
__global__ void __launch_bounds__(SEED_THREADS)
seed_occlusion_kernel(const float* __restrict__ origin, const float* direction,
                      const float* __restrict__ t_min_in,
                      const float* __restrict__ t_max_in,
                      const __grid_constant__ SeedTris tris, int n_tris,
                      int n_rays, bool first, bool* __restrict__ occluded,
                      float* walk_dir) {
  __shared__ float g[9][SEED_MAX_TRIS];
  for (int k = threadIdx.x; k < 9 * n_tris; k += SEED_THREADS) {
    g[k / n_tris][k % n_tris] = tris.g[k / n_tris][k % n_tris];
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * SEED_THREADS + threadIdx.x;
  if (i >= n_rays) return;
  SeedRay r;
  r.dx = direction[3 * i + 0];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  bool occ = false;
  if (r.dx != 0.0f || r.dy != 0.0f || r.dz != 0.0f) {
    r.ox = origin[3 * i + 0];
    r.oy = origin[3 * i + 1];
    r.oz = origin[3 * i + 2];
    r.t_min = t_min_in[i];
    r.t_max = t_max_in[i];
    for (int j = 0; j < n_tris && !occ; ++j) occ = occludes(g, j, r);
  }
  if (first || occ) {
    occluded[i] = occ;
    walk_dir[3 * i + 0] = occ ? 0.0f : r.dx;
    walk_dir[3 * i + 1] = occ ? 0.0f : r.dy;
    walk_dir[3 * i + 2] = occ ? 0.0f : r.dz;
  }
}

}  // namespace

// tris: host (9, n_tris) f32, n_tris >= 1, copied into the launches'
// parameters SEED_MAX_TRIS at a time; occluded: (n_rays,) bool; walk_dir:
// (n_rays, 3) f32.
extern "C" int seed_occlusion(const float* origin, const float* direction,
                              const float* t_min, const float* t_max,
                              const float* tris, int n_tris, int n_rays,
                              bool* occluded, float* walk_dir, void* stream) {
  if (n_tris < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + SEED_THREADS - 1) / SEED_THREADS;
  for (int j0 = 0; j0 < n_tris; j0 += SEED_MAX_TRIS) {
    const int n = n_tris - j0 < SEED_MAX_TRIS ? n_tris - j0 : SEED_MAX_TRIS;
    SeedTris table;
    for (int c = 0; c < 9; ++c) {
      for (int j = 0; j < SEED_MAX_TRIS; ++j) {
        table.g[c][j] = j < n ? tris[c * n_tris + j0 + j] : 0.0f;
      }
    }
    seed_occlusion_kernel<<<blocks, SEED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        origin, j0 == 0 ? direction : walk_dir, t_min, t_max, table, n, n_rays, j0 == 0,
        occluded, walk_dir);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// Screen-space ambient occlusion in its stencil form (ssao.frag's 32-sample
// hemisphere kernel, each tap snapped to a static offset): what
// ops/ssao.py::ssao_stencil_plain computes with 48 edge-clamped shifted
// copies of the view-depth image and ~2,400 full-frame tensor operations, in
// two launches.
//
// No Pallas kernel is replaced: the JAX package writes the stencil form as
// tensor code (rust_renderer_tpu/ops/ssao.py::ssao_stencil), which XLA fuses
// inside the jitted frame. The port's eager body runs each operation as a
// launch and a round trip of a full-frame intermediate through device memory.
//
// What bounds it on an H100: a pixel reads its position and normal (16 B
// each) and writes one float; its 32 taps read the 4-byte view-depth plane
// within 32 pixels of it, which stays in L2 (8.3 MB a 1080p frame). So the
// bytes are ~44 a pixel (0.027 ms a 1080p frame at 3.35 TB/s), and the
// arithmetic bounds it: 32 samples of a 4x4 projection, two IEEE divisions,
// sqrtf, atan2f and log2f each (chip_smoke.py's SSAO_OPS_PER_PIXEL counts
// them). The design:
//   - `ssao_depth_kernel` writes the view-depth plane of the rows given (the
//     expression of the view-space position's z); on a row band of the image
//     the wrapper gathers the bands' planes to full height between the two
//     launches, so the taps above and below the band read its neighbours'
//     rows and the edge clamp holds only at the image's top and bottom;
//   - `ssao_occlusion_kernel` runs one thread a pixel in 32 x 8 tiles (a
//     warp's taps fall on neighbouring texels), the 32 samples unrolled; the
//     sample table and the 48 static offsets travel in the launch's
//     parameters, the offsets staged in shared memory once a block (a tap
//     picks one by its sector and ring); a sample whose tap is "tiny" skips
//     its sector, ring, tap and range check (it adds 0), and a sky or
//     disabled pixel writes 1;
//   - radius, bias, the view matrix, the normal matrix, the projection and
//     the pass's `ssao_enabled` are read from device memory, so a launch
//     captured into a CUDA graph replays with the values they hold then;
//   - every kept value is computed by the plain body's float32 operations in
//     its order (built with -fmad=false; atan2f, log2f, IEEE sqrtf and
//     division, no fast math): apply_rows term by term, a 3-vector's
//     vector_norm as (x*x + z*z) + y*y (PyTorch's reduction order on the
//     card), torch.round as rintf (half to even), remainder with the
//     divisor's sign, clamp_min / clamp keeping a NaN; a division by a host
//     scalar is a multiply by its float32 reciprocal, as PyTorch's is.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#define SSAO_BX 32
#define SSAO_BY 8
#define SSAO_THREADS (SSAO_BX * SSAO_BY)
#define SSAO_KERNEL_SIZE 32
#define SSAO_DIRS 8
#define SSAO_RINGS 6
#define SSAO_TAPS (SSAO_DIRS * SSAO_RINGS)

// The launch's inputs; ops/ssao.py::_Args mirrors it field for field.
struct SsaoArgs {
  // (rows, width, 4) gbuffer planes of the rows computed, contiguous.
  const float4* position;
  const float4* normal;
  // (rows, width): the view-depth plane of those rows (ssao_depth writes it).
  float* depth;
  // (full_height, width): the plane the taps read (the depth plane itself,
  // or on a row band every band's, gathered).
  const float* depth_full;
  // (rows, width) occlusion.
  float* out;
  // (4, 4) row-major view and projection; the normal matrix's (4, 4) at its
  // strides (nm_row, nm_col) in floats.
  const float* view_matrix;
  const float* normal_matrix;
  const float* projection;
  // Uniforms: radius, bias (float32), the pass's ssao_enabled (int32; null:
  // always enabled).
  const float* radius;
  const float* bias;
  const int* enabled;
  // ops/ssao.py's _KERNEL, (32, 3), and the stencil's (dy, dx) offsets by
  // direction, then ring.
  float kernel[SSAO_KERNEL_SIZE * 3];
  int offset[SSAO_TAPS * 2];
  // The plain body's Python scalars in float32: 0.5 w, 0.5 h, 8 / (2 pi),
  // log2 of the innermost ring, half the innermost ring, the strength, and
  // 1 / 32 (the reciprocal PyTorch multiplies by for `/ 32`).
  float half_w;
  float half_h;
  float sector_scale;
  float log_r0;
  float tiny;
  float strength;
  float inv_kernel_size;
  int nm_row;
  int nm_col;
  int rows;
  int width;
  int full_height;
  int row_offset;
};

namespace {

// PyTorch's clamp_min / clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.linalg.vector_norm of a 3-vector on the card: its reduction sums
// x^2 + z^2 first, then y^2.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

// v / clamp_min(|v|, 1e-9).
__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = clamp_min(norm3(x, y, z), 1e-9f);
  x = x / n;
  y = y / n;
  z = z / n;
}

// ops/rays.py::apply_rows of one point and one (4,) row m: term by term.
__device__ __forceinline__ float row4(const float* m, float x, float y, float z) {
  return ((x * m[0] + y * m[1]) + z * m[2]) + m[3];
}

// ssao._to_ndc_xy: clip / clamp_min(|w|, 1e-9) * sign(w), from the
// projection's rows 0, 1 and 3.
__device__ __forceinline__ void to_ndc(const float* p, float x, float y, float z, float* nx,
                                       float* ny) {
  const float cx = row4(p, x, y, z), cy = row4(p + 4, x, y, z);
  const float cw = row4(p + 12, x, y, z);
  const float aw = clamp_min(fabsf(cw), 1e-9f);
  const float sign = static_cast<float>((0.0f < cw) - (cw < 0.0f));
  *nx = cx / aw * sign;
  *ny = cy / aw * sign;
}

// Float to an integer as PyTorch's .to(torch.int64) of a rounded value: the
// conversion truncates (a NaN gives 0, and a value beyond the range
// saturates, in 32 bits as in 64 for every use below: a sector from
// |angle| <= pi and a ring clamped to [0, 5]).
__device__ __forceinline__ int to_int(float v) { return static_cast<int>(v); }

// The view-space depth of the rows given: ((x v20 + y v21) + z v22) + v23.
__global__ void __launch_bounds__(SSAO_THREADS)
ssao_depth_kernel(const __grid_constant__ SsaoArgs a) {
  const int col = blockIdx.x * SSAO_BX + threadIdx.x;
  const int row = blockIdx.y * SSAO_BY + threadIdx.y;
  if (col >= a.width || row >= a.rows) return;
  const int64_t i = static_cast<int64_t>(row) * a.width + col;
  const float4 p = __ldg(a.position + i);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __ldg(a.view_matrix + 8 + k);
  a.depth[i] = row4(v, p.x, p.y, p.z);
}

// One thread a pixel of the (rows, width) planes.
__global__ void __launch_bounds__(SSAO_THREADS)
ssao_occlusion_kernel(const __grid_constant__ SsaoArgs a) {
  // The view matrix's rows 0-2 (12), the normal matrix's 3x3 (9), the
  // projection (16), radius and bias.
  __shared__ float s_m[12 + 9 + 16 + 2];
  __shared__ int2 s_offset[SSAO_TAPS];  // (dy, dx)
  __shared__ int s_enabled;
  const int tid = threadIdx.y * SSAO_BX + threadIdx.x;
  if (tid < SSAO_TAPS) s_offset[tid] = make_int2(a.offset[2 * tid], a.offset[2 * tid + 1]);
  if (tid < 12) {
    s_m[tid] = __ldg(a.view_matrix + tid);
  } else if (tid < 21) {
    const int r = (tid - 12) / 3, c = (tid - 12) % 3;
    s_m[tid] = __ldg(a.normal_matrix + r * a.nm_row + c * a.nm_col);
  } else if (tid < 37) {
    s_m[tid] = __ldg(a.projection + (tid - 21));
  } else if (tid == 37) {
    s_m[37] = __ldg(a.radius);
  } else if (tid == 38) {
    s_m[38] = __ldg(a.bias);
  } else if (tid == 39) {
    s_enabled = a.enabled == nullptr ? 1 : __ldg(a.enabled);
  }
  __syncthreads();

  const int col = blockIdx.x * SSAO_BX + threadIdx.x;
  const int row = blockIdx.y * SSAO_BY + threadIdx.y;
  if (col >= a.width || row >= a.rows) return;
  const int64_t i = static_cast<int64_t>(row) * a.width + col;
  const float4 gp = __ldg(a.position + i);
  // The sky (position cleared to (1, 1, 1)) is unoccluded, and the pass's
  // select writes 1 where SSAO is off.
  if ((gp.x == 1.0f && gp.y == 1.0f && gp.z == 1.0f) || s_enabled != 1) {
    a.out[i] = 1.0f;
    return;
  }
  const float4 gn = __ldg(a.normal + i);
  const float* vm = s_m;
  const float* nm = s_m + 12;
  const float* proj = s_m + 21;
  const float radius = s_m[37], bias = s_m[38];

  // ssao._view_frame: view-space position and unit normal, the TBN from the
  // fixed vector (1, 1, 0).
  const float pvx = row4(vm, gp.x, gp.y, gp.z), pvy = row4(vm + 4, gp.x, gp.y, gp.z),
              pvz = row4(vm + 8, gp.x, gp.y, gp.z);
  float nx = (gn.x * nm[0] + gn.y * nm[1]) + gn.z * nm[2];
  float ny = (gn.x * nm[3] + gn.y * nm[4]) + gn.z * nm[5];
  float nz = (gn.x * nm[6] + gn.y * nm[7]) + gn.z * nm[8];
  unit3(nx, ny, nz);
  const float d = (1.0f * nx + 1.0f * ny) + 0.0f * nz;
  float tx = 1.0f - nx * d, ty = 1.0f - ny * d, tz = 0.0f - nz * d;
  unit3(tx, ty, tz);
  const float bx = ty * nz - tz * ny, by = tz * nx - tx * nz, bz = tx * ny - ty * nx;

  float ccx, ccy;
  to_ndc(proj, pvx, pvy, pvz, &ccx, &ccy);

  const int img_row = a.row_offset + row;
  const int last_row = a.full_height - 1, last_col = a.width - 1;
  float occlusion = 0.0f;
#pragma unroll
  for (int s = 0; s < SSAO_KERNEL_SIZE; ++s) {
    const float k0 = a.kernel[3 * s], k1 = a.kernel[3 * s + 1], k2 = a.kernel[3 * s + 2];
    const float svx = ((tx * k0 + bx * k1) + nx * k2) * radius + pvx;
    const float svy = ((ty * k0 + by * k1) + ny * k2) * radius + pvy;
    const float svz = ((tz * k0 + bz * k1) + nz * k2) * radius + pvz;
    float sx, sy;
    to_ndc(proj, svx, svy, svz, &sx, &sy);
    // The pixel offset from the pixel's own tap (screen y runs opposite to
    // ndc y); within half the innermost ring it would read the pixel
    // itself and counts as unoccluded: it adds 0.
    const float fx = (sx - ccx) * a.half_w;
    const float fy = (ccy - sy) * a.half_h;
    const float rad = sqrtf(fx * fx + fy * fy);
    if (rad < a.tiny) continue;
    // Snapped to the nearest sector and log2 ring.
    int sector = to_int(rintf(atan2f(fy, fx) * a.sector_scale)) % SSAO_DIRS;
    if (sector < 0) sector += SSAO_DIRS;
    const int ring = min(max(to_int(rintf(log2f(clamp_min(rad, 1e-6f)) - a.log_r0)), 0),
                         SSAO_RINGS - 1);
    const int2 off = s_offset[sector * SSAO_RINGS + ring];
    const int tap_row = min(max(img_row + off.x, 0), last_row);
    const int tap_col = min(max(col + off.y, 0), last_col);
    const float sample_depth =
        __ldg(a.depth_full + static_cast<int64_t>(tap_row) * a.width + tap_col);
    // ssao._occlusion: the smoothstep range check.
    const float denom = clamp_min(fabsf(pvz - sample_depth), 1e-9f);
    float range = clamp(radius / denom, 0.0f, 1.0f);
    range = range * range * (3.0f - 2.0f * range);
    const float hit = sample_depth >= svz + bias ? 1.0f : 0.0f;
    occlusion = occlusion + hit * range;
  }
  a.out[i] = 1.0f - (occlusion * a.inv_kernel_size) * a.strength;
}

bool valid(const SsaoArgs* a) {
  return a->rows >= 1 && a->width >= 1 && a->full_height >= a->rows && a->row_offset >= 0 &&
         a->row_offset + a->rows <= a->full_height;
}

dim3 grid_of(const SsaoArgs* a) {
  return dim3((a->width + SSAO_BX - 1) / SSAO_BX, (a->rows + SSAO_BY - 1) / SSAO_BY);
}

}  // namespace

// sizeof(SsaoArgs), for the wrapper's check of its mirror.
extern "C" int ssao_args_size() { return static_cast<int>(sizeof(SsaoArgs)); }

// The view-depth plane of the rows, on `stream`. Returns the launch's
// cudaError_t.
extern "C" int ssao_depth(const SsaoArgs* args, void* stream) {
  if (!valid(args)) return static_cast<int>(cudaErrorInvalidValue);
  ssao_depth_kernel<<<grid_of(args), dim3(SSAO_BX, SSAO_BY), 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The occlusion of the rows, reading `depth_full`, on `stream`. Returns the
// launch's cudaError_t.
extern "C" int ssao_occlusion(const SsaoArgs* args, void* stream) {
  if (!valid(args)) return static_cast<int>(cudaErrorInvalidValue);
  ssao_occlusion_kernel<<<grid_of(args), dim3(SSAO_BX, SSAO_BY), 0,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

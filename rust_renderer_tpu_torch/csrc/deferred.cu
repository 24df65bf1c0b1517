// The deferred composite (utopian/shaders/deferred/deferred.frag): per pixel
// of the gbuffer planes, the material decoded, Cook-Torrance over the sun and
// the scene's lights, the ambient term (split-sum IBL or a flat 0.03), RT
// reflections on metal, the shadow factor (cascaded shadow maps with 3x3 PCF,
// or the ray-traced sun visibility), the cascade debug tint and SSAO: what
// ops/deferred.py::deferred_composite_plain computes with ~1,000 full-frame
// tensor operations, in one launch.
//
// No Pallas kernel is replaced: the JAX package writes the pass as tensor
// code (rust_renderer_tpu/renderers/passes.py), which XLA fuses inside the
// jitted frame. The port's eager body runs each operation as a launch and a
// round trip of a (rows, width, 3) intermediate through device memory.
//
// What bounds it on an H100: a pixel reads 4 gbuffer planes, the
// reflections (16 B each) and two scalar planes (4 B each) and writes 16 B,
// 104 B (0.064 ms a 1080p frame at 3.35 TB/s); its lookups (9 shadow taps, a
// bilinear irradiance tap, a trilinear specular tap, a LUT texel) stay local
// and mostly hit in L2. Its arithmetic (~1,100 float32 operations, with ~40
// IEEE divisions and a powf a light) is of the same order. The design, one
// thread a pixel in 32 x 8 blocks:
//   - a block is a 32 x 8 tile of the image, so a warp's shadow and cubemap
//     taps fall on neighbouring texels; the 4-channel planes are read and the
//     output written as one float4 a thread;
//   - the view's toggles, eye, sun and view matrix row, the cascade matrices
//     and splits are staged in shared memory once a block, and the lights a
//     chunk at a time, with their pixel-independent directions computed once
//     a block; materials, cubemaps, the LUT and the shadow map are read
//     through the read-only path;
//   - every value a frame can change (toggles, num_lights, eye, sun, view and
//     cascade matrices, the light and material tables) is read from device
//     memory, so a launch captured into a CUDA graph replays with the view's
//     current values; the specular chain's level pointers and sizes travel
//     in the launch's parameters, with every other address;
//   - a term that the plain body computes and then discards is skipped (the
//     lights and the ambient of a metal pixel that takes its reflection, the
//     cascades when shadows_enabled is 0, the lights at or beyond num_lights,
//     the ambient not chosen); every kept value is computed by the plain
//     body's float32 operations in its order (built with -fmad=false, powf /
//     sqrtf and IEEE division, no fast math). Where PyTorch's CUDA kernels
//     divide by a host scalar they multiply by its float32 reciprocal, so the
//     kernel does the same. clamp_min / clamp keep a NaN and torch.maximum /
//     minimum return one, as PyTorch's do; an index from a NaN is clamped
//     into its table, where the plain body would fault.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#define DEFERRED_BX 32
#define DEFERRED_BY 8
#define DEFERRED_THREADS (DEFERRED_BX * DEFERRED_BY)
#define DEFERRED_MAX_LEVELS 16    // specular mip levels
#define DEFERRED_MAX_CASCADES 8
#define DEFERRED_LIGHT_CHUNK 32   // lights staged in shared memory at a time

// The launch's inputs; ops/deferred.py::_Args mirrors it field for field.
struct DeferredArgs {
  // (rows, width, 4) planes and (rows, width) planes, contiguous.
  const float4* position;
  const float4* normal;
  const float4* albedo;
  const float4* pbr;
  const float4* reflections;
  const float* rt_shadows;
  const float* ssao;
  float4* out;
  // The view: eye (3), sun direction (3), view matrix (4, 4), int32 scalars.
  const float* eye_pos;
  const float* sun_dir;
  const float* view_matrix;
  const int* num_lights;
  const int* ibl_enabled;
  const int* shadows_enabled;
  const int* raytracing_supported;
  const int* cascade_debug;
  const int* ssao_enabled;
  // Cascades: (C, 4, 4) light view-projections, (C,) split depths, (C, S, S).
  const float* cascade_vp;
  const float* cascade_splits;
  const float* shadow_map;
  // Materials (K, 4) / (K,); lights (L, 4), (L, 3) or (L,).
  const float* mat_base_color;
  const float* mat_metallic;
  const float* mat_roughness;
  const int* mat_rt_type;
  const float* light_color;
  const float* light_pos;
  const float* light_dir;
  const float* light_type;
  const float* light_att;
  const float* light_spot;
  // IBL: (6, Si, Si, 3) irradiance, (Sl, Sl, 2) LUT, the (6, s, s, 3) levels.
  const float* irradiance;
  const float* brdf_lut;
  const float* specular[DEFERRED_MAX_LEVELS];
  int specular_size[DEFERRED_MAX_LEVELS];
  int rows;
  int width;
  int n_materials;
  int n_lights;
  int n_cascades;
  int shadow_size;
  int irradiance_size;
  int lut_size;
  int n_levels;
};

namespace {

// float32 values of the Python constants (ops/brdf.py PI, ops/shadow.py).
constexpr float kPi = 0x1.921fb6p+1f;       // 3.14159265359
constexpr float kInvPi = 0x1.45f306p-2f;    // 1 / PI in float32
constexpr float kInvNine = 0x1.c71c72p-4f;  // 1 / 9 in float32
constexpr float kShadowBias = 0.0005f;
constexpr float kShadowFactor = 0.3f;
constexpr float kMaxReflectionLod = 7.0f;

// A light as the shading loop reads it: color, position, the directional
// light's unit(direction * (-1, 1, -1)), the spot's unit(direction), type,
// spot exponent and attenuation.
struct Light {
  float cx, cy, cz, px, py, pz, ldx, ldy, ldz, sdx, sdy, sdz, type, spot, a0, a1, a2;
};

// PyTorch's clamp_min / clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum / torch.minimum: NaN where either is NaN.
__device__ __forceinline__ float maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// ops/rays.py::dot, left to right.
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}

// torch.linalg.vector_norm of a 3-vector on the card: its reduction sums
// x^2 + z^2 first, then y^2.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

// pbr._unit: v / clamp_min(|v|, 1e-9).
__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = clamp_min(norm3(x, y, z), 1e-9f);
  x = x / n;
  y = y / n;
  z = z / n;
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t lo, int64_t hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// Float to int64 as PyTorch's .to(torch.int64), then clamped into [0, hi]
// (the plain body clamps where it clamps; elsewhere only a NaN is out).
__device__ __forceinline__ int64_t index_in(float v, int64_t hi) {
  return clamp_index(static_cast<int64_t>(v), 0, hi);
}

// brdf.geometry_schlick_ggx: k = (r + 1)^2 / 8.
__device__ __forceinline__ float schlick_ggx(float ndotv, float roughness) {
  const float r = roughness + 1.0f;
  const float k = (r * r) * 0.125f;
  return ndotv / (ndotv * (1.0f - k) + k);
}

// The per-pixel values every light's shading reads.
struct Surface {
  float px, py, pz, nx, ny, nz, vx, vy, vz;  // position, normal, unit view
  float bc[3], f0[3];                        // base colour, F0
  float metallic, roughness;
};

// pbr.surface_shading of one light of direction (lx, ly, lz), attenuation
// `att` and color (cx, cy, cz), added to lo.
__device__ __forceinline__ void add_light(const Surface& s, float lx, float ly, float lz,
                                          float att, float cx, float cy, float cz,
                                          float* lo) {
  float hx = lx + s.vx, hy = ly + s.vy, hz = lz + s.vz;
  unit3(hx, hy, hz);
  const float radiance[3] = {cx * att, cy * att, cz * att};

  const float a = s.roughness * s.roughness;
  const float a2 = a * a;
  const float ndoth = clamp_min(dot3(s.nx, s.ny, s.nz, hx, hy, hz), 0.0f);
  const float denom = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
  const float ndf = a2 / (kPi * denom * denom);

  const float ndotv = clamp_min(dot3(s.nx, s.ny, s.nz, s.vx, s.vy, s.vz), 0.0f);
  const float ndotl = clamp_min(dot3(s.nx, s.ny, s.nz, lx, ly, lz), 0.0f);
  const float g = schlick_ggx(ndotv, s.roughness) * schlick_ggx(ndotl, s.roughness);
  const float hdotv = clamp_min(dot3(hx, hy, hz, s.vx, s.vy, s.vz), 0.0f);
  const float fw = powf(clamp(1.0f - hdotv, 0.0f, 1.0f), 5.0f);
  const float spec_denom = 4.0f * ndotv * ndotl + 0.0001f;
  const float ndf_g = ndf * g;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f = s.f0[c] + (1.0f - s.f0[c]) * fw;
    const float kd = (1.0f - f) * (1.0f - s.metallic);
    const float specular = ndf_g * f / spec_denom;
    lo[c] = lo[c] + (kd * s.bc[c] * kInvPi + specular) * radiance[c] * ndotl;
  }
}

// cubemap.direction_to_face_uv.
__device__ __forceinline__ void face_uv(float x, float y, float z, int* face, float* u,
                                        float* v) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = (ay > ax) && (ay >= az);
  *face = is_x ? (x > 0.0f ? 0 : 1) : is_y ? (y > 0.0f ? 2 : 3) : (z > 0.0f ? 4 : 5);
  const float major = clamp_min(is_x ? ax : (is_y ? ay : az), 1e-12f);
  const float uu = is_x ? (x > 0.0f ? -z : z) : (is_y ? x : (z > 0.0f ? x : -x));
  const float vv = is_x ? -y : (is_y ? (y > 0.0f ? z : -z) : -y);
  *u = uu / major * 0.5f + 0.5f;
  *v = vv / major * 0.5f + 0.5f;
}

// cubemap._bilinear: the clamp-to-edge bilinear tap at (face, u, v) of a
// (6, size, size, 3) level, into out.
__device__ __forceinline__ void bilinear(const float* __restrict__ level, int size, int face,
                                         float u, float v, float* out) {
  const float fsize = static_cast<float>(size);
  const float fx = minimum(clamp_min(u * fsize - 0.5f, 0.0f), fsize - 1.0f);
  const float fy = minimum(clamp_min(v * fsize - 0.5f, 0.0f), fsize - 1.0f);
  const float x0f = floorf(fx), y0f = floorf(fy);
  const float wx = fx - x0f, wy = fy - y0f;
  const int64_t last = size - 1;
  const int64_t x0 = index_in(x0f, last), y0 = index_in(y0f, last);
  const int64_t x1 = x0 + 1 < last ? x0 + 1 : last, y1 = y0 + 1 < last ? y0 + 1 : last;
  const int64_t base = static_cast<int64_t>(face) * size * size;
  const float* c00 = level + 3 * (base + y0 * size + x0);
  const float* c10 = level + 3 * (base + y0 * size + x1);
  const float* c01 = level + 3 * (base + y1 * size + x0);
  const float* c11 = level + 3 * (base + y1 * size + x1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(c00 + c) * (1.0f - wx) + __ldg(c10 + c) * wx;
    const float bot = __ldg(c01 + c) * (1.0f - wx) + __ldg(c11 + c) * wx;
    out[c] = top * (1.0f - wy) + bot * wy;
  }
}

// pbr.image_based_lighting of surface s (occlusion occ) into out.
__device__ __forceinline__ void ibl(const DeferredArgs& a, const Surface& s, float occ,
                                    float* out) {
  const float t = 2.0f * dot3(s.vx, s.vy, s.vz, s.nx, s.ny, s.nz);
  const float rx = -(s.vx - t * s.nx), ry = -(s.vy - t * s.ny), rz = -(s.vz - t * s.nz);
  const float ndotv = clamp_min(dot3(s.nx, s.ny, s.nz, s.vx, s.vy, s.vz), 0.0f);
  const float fw = powf(clamp(1.0f - ndotv, 0.0f, 1.0f), 5.0f);

  int face;
  float u, v, irr[3], lo_tap[3], hi_tap[3];
  face_uv(s.nx, s.ny, s.nz, &face, &u, &v);
  bilinear(a.irradiance, a.irradiance_size, face, u, v, irr);

  // cubemap.sample_cubemap_lod at roughness * 7, clamped to the chain.
  const int last_level = a.n_levels - 1;
  const float lod = clamp(s.roughness * kMaxReflectionLod, 0.0f,
                          static_cast<float>(last_level));
  const float lod_floor = floorf(lod);
  const int lo = static_cast<int>(index_in(lod_floor, last_level));
  const int hi = lo + 1 < last_level ? lo + 1 : last_level;
  const float frac = lod - lod_floor;
  face_uv(rx, ry, rz, &face, &u, &v);
  bilinear(a.specular[lo], a.specular_size[lo], face, u, v, lo_tap);
  bilinear(a.specular[hi], a.specular_size[hi], face, u, v, hi_tap);

  // The LUT at (NdotV, 1 - roughness).
  const int64_t last = a.lut_size - 1;
  const float flast = static_cast<float>(last);
  const int64_t lx = index_in(clamp(ndotv * flast, 0.0f, flast), last);
  const int64_t ly = index_in(clamp((1.0f - s.roughness) * flast, 0.0f, flast), last);
  const float2 ab = __ldg(reinterpret_cast<const float2*>(a.brdf_lut) + ly * a.lut_size + lx);

  const float max_refl = 1.0f - s.roughness;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f = s.f0[c] + (maximum(max_refl, s.f0[c]) - s.f0[c]) * fw;
    const float kd = (1.0f - f) * (1.0f - s.metallic);
    const float diffuse = irr[c] * s.bc[c];
    const float prefiltered = lo_tap[c] * (1.0f - frac) + hi_tap[c] * frac;
    const float specular = prefiltered * (f * ab.x + ab.y);
    out[c] = (kd * diffuse + specular) * occ;
  }
}

// shadow.calculate_shadow's cascade: by view-space depth, from the block's
// staged view matrix row and split depths.
__device__ __forceinline__ int select_cascade(const float* view_row, const float* splits,
                                              int n_cascades, float px, float py, float pz) {
  const float view_z = px * view_row[0] + py * view_row[1] + pz * view_row[2] + view_row[3];
  int cascade = 0;
  for (int i = 0; i < n_cascades - 1; ++i) {
    if (view_z < -splits[i]) cascade = i + 1;
  }
  return cascade;
}

// shadow.calculate_shadow's factor at (px, py, pz) in `cascade`, whose light
// view-projection is m: the 3x3 PCF of the shadow map's layer.
__device__ __forceinline__ float csm(const DeferredArgs& a, int cascade, const float* m,
                                     float px, float py, float pz) {
  float proj[3];
  const float w = px * m[12] + py * m[13] + pz * m[14] + m[15];
  const float aw = clamp_min(fabsf(w), 1e-9f);
  const float sign = static_cast<float>((0.0f < w) - (w < 0.0f));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float l = px * m[4 * j] + py * m[4 * j + 1] + pz * m[4 * j + 2] + m[4 * j + 3];
    proj[j] = l / aw * sign;
  }
  const float uvx = proj[0] * 0.5f + 0.5f, uvy = proj[1] * 0.5f + 0.5f;
  const float depth_ref = proj[2];
  const bool in_range = (depth_ref <= 1.0f) && (depth_ref > -1.0f);

  const int size = a.shadow_size;
  const float fsize = static_cast<float>(size);
  // Clamped first to [-2, size + 1]: the same taps, with no overflow.
  const int64_t x0 = clamp_index(static_cast<int64_t>(floorf(uvx * fsize)), -2, size + 1);
  const int64_t y0 = clamp_index(static_cast<int64_t>(floorf((1.0f - uvy) * fsize)), -2,
                                 size + 1);
  const float* layer = a.shadow_map + static_cast<int64_t>(cascade) * size * size;
  const float ref = depth_ref - kShadowBias;
  float shadow = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      float lit = 1.0f;
      if (in_range) {
        const int64_t cx = clamp_index(x0 + dx, 0, size - 1);
        const int64_t cy = clamp_index(y0 + dy, 0, size - 1);
        lit = ref > __ldg(layer + cy * size + cx) ? kShadowFactor : 1.0f;
      }
      shadow = shadow + lit;
    }
  }
  return shadow * kInvNine;
}

// One thread a pixel of the (rows, width) planes.
__global__ void __launch_bounds__(DEFERRED_THREADS)
deferred_shade_kernel(const __grid_constant__ DeferredArgs a) {
  __shared__ Light s_light[DEFERRED_LIGHT_CHUNK];
  __shared__ float s_vp[DEFERRED_MAX_CASCADES * 16];
  __shared__ float s_split[DEFERRED_MAX_CASCADES];
  // eye (3), the sun's unit(dir * (-1, 1, -1)) (3), the view matrix's row 2 (4)
  __shared__ float s_view[10];
  // num_lights, ibl, shadows, raytracing, cascade debug, ssao
  __shared__ int s_flag[6];

  const int tid = threadIdx.y * DEFERRED_BX + threadIdx.x;
  if (tid == 0) {
    s_flag[0] = __ldg(a.num_lights);
    s_flag[1] = __ldg(a.ibl_enabled);
    s_flag[2] = __ldg(a.shadows_enabled);
    s_flag[3] = __ldg(a.raytracing_supported);
    s_flag[4] = __ldg(a.cascade_debug);
    s_flag[5] = __ldg(a.ssao_enabled);
  } else if (tid == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s_view[k] = __ldg(a.eye_pos + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) s_view[6 + k] = __ldg(a.view_matrix + 8 + k);
  } else if (tid == 2) {
    float x = __ldg(a.sun_dir) * -1.0f, y = __ldg(a.sun_dir + 1) * 1.0f,
          z = __ldg(a.sun_dir + 2) * -1.0f;
    unit3(x, y, z);
    s_view[3] = x;
    s_view[4] = y;
    s_view[5] = z;
  }
  if (tid < 16 * a.n_cascades) s_vp[tid] = __ldg(a.cascade_vp + tid);
  if (tid < a.n_cascades) s_split[tid] = __ldg(a.cascade_splits + tid);
  __syncthreads();

  const int col = blockIdx.x * DEFERRED_BX + threadIdx.x;
  const int row = blockIdx.y * DEFERRED_BY + threadIdx.y;
  const bool live = col < a.width && row < a.rows;
  const int64_t i = live ? static_cast<int64_t>(row) * a.width + col : 0;
  const bool ibl_on = s_flag[1] == 1, shadows_on = s_flag[2] == 1, rt_on = s_flag[3] == 1;

  // The material (ops/pbr.py::material_pixel).
  const float4 gp = __ldg(a.position + i), gn = __ldg(a.normal + i),
               ga = __ldg(a.albedo + i), gm = __ldg(a.pbr + i);
  const int64_t mat = index_in(gm.w, a.n_materials - 1);
  const bool metal = rt_on && __ldg(a.mat_rt_type + mat) == 1;
  Surface s;
  s.px = gp.x, s.py = gp.y, s.pz = gp.z;
  s.nx = gn.x, s.ny = gn.y, s.nz = gn.z;
  s.vx = s_view[0] - gp.x, s.vy = s_view[1] - gp.y, s.vz = s_view[2] - gp.z;
  unit3(s.vx, s.vy, s.vz);
  const float albedo[3] = {ga.x, ga.y, ga.z};
  s.metallic = gm.x * __ldg(a.mat_metallic + mat);
  s.roughness = gm.y * __ldg(a.mat_roughness + mat);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.bc[c] = powf(clamp_min(albedo[c], 0.0f), 2.2f) * __ldg(a.mat_base_color + 4 * mat + c);
    s.f0[c] = 0.04f + (s.bc[c] - 0.04f) * s.metallic;
  }

  // Direct light: the sun (white, directional), then the scene's lights
  // below num_lights, in order (pbr.shade_all_lights).
  const bool lit = live && !metal;
  float lo[3] = {0.0f, 0.0f, 0.0f};
  if (lit) add_light(s, s_view[3], s_view[4], s_view[5], 1.0f, 1.0f, 1.0f, 1.0f, lo);
  const int n_lights = max(0, min(s_flag[0], a.n_lights));
  for (int first = 0; first < n_lights; first += DEFERRED_LIGHT_CHUNK) {
    const int count = min(DEFERRED_LIGHT_CHUNK, n_lights - first);
    __syncthreads();  // the last chunk's readers are done
    if (tid < count) {
      const int k = first + tid;
      Light& L = s_light[tid];
      L.cx = __ldg(a.light_color + 4 * k), L.cy = __ldg(a.light_color + 4 * k + 1),
      L.cz = __ldg(a.light_color + 4 * k + 2);
      L.px = __ldg(a.light_pos + 3 * k), L.py = __ldg(a.light_pos + 3 * k + 1),
      L.pz = __ldg(a.light_pos + 3 * k + 2);
      const float dx = __ldg(a.light_dir + 3 * k), dy = __ldg(a.light_dir + 3 * k + 1),
                  dz = __ldg(a.light_dir + 3 * k + 2);
      L.ldx = dx * -1.0f, L.ldy = dy * 1.0f, L.ldz = dz * -1.0f;
      unit3(L.ldx, L.ldy, L.ldz);
      L.sdx = dx, L.sdy = dy, L.sdz = dz;
      unit3(L.sdx, L.sdy, L.sdz);
      L.type = __ldg(a.light_type + k);
      L.spot = __ldg(a.light_spot + k);
      L.a0 = __ldg(a.light_att + 3 * k), L.a1 = __ldg(a.light_att + 3 * k + 1),
      L.a2 = __ldg(a.light_att + 3 * k + 2);
    }
    __syncthreads();
    if (!lit) continue;
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const Light& L = s_light[j];
      float lx, ly, lz, att;
      if (L.type == 0.0f) {
        lx = L.ldx, ly = L.ldy, lz = L.ldz, att = 1.0f;
      } else {
        lx = L.px - s.px, ly = L.py - s.py, lz = L.pz - s.pz;
        const float d = norm3(lx, ly, lz);
        const float dc = clamp_min(d, 1e-9f);
        lx = lx / dc, ly = ly / dc, lz = lz / dc;
        att = 1.0f / clamp_min(L.a0 + L.a1 * d + L.a2 * d * d, 1e-9f);
        if (L.type == 2.0f) {
          att = powf(clamp_min(dot3(lx, ly, lz, L.sdx, L.sdy, L.sdz), 0.0f), L.spot) * att;
        }
      }
      add_light(s, lx, ly, lz, att, L.cx, L.cy, L.cz, lo);
    }
  }
  if (!live) return;

  // Ambient plus direct light, or the reflection on metal.
  const float occ = gm.z;
  float color[3];
  if (metal) {
    const float4 refl = __ldg(a.reflections + i);
    color[0] = refl.x, color[1] = refl.y, color[2] = refl.z;
  } else if (ibl_on) {
    ibl(a, s, occ, color);
#pragma unroll
    for (int c = 0; c < 3; ++c) color[c] = color[c] + lo[c];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) color[c] = 0.03f * s.bc[c] * occ + lo[c];
  }

  // CSM when enabled, else the RT shadows, else 1; the debug tint; SSAO.
  int cascade = 0;
  float shadow = 1.0f;
  if (shadows_on) {
    cascade = select_cascade(s_view + 6, s_split, a.n_cascades, gp.x, gp.y, gp.z);
    shadow = csm(a, cascade, s_vp + 16 * cascade, gp.x, gp.y, gp.z);
  } else if (rt_on) {
    shadow = clamp_min(__ldg(a.rt_shadows + i), kShadowFactor);
  }
  // shadow._DEBUG_COLORS[min(cascade, 3)] (red, green, blue, yellow), each
  // channel 1 or 0.25: bit `cascade` (0 to 7) of a mask a channel. (The
  // form with min and compares, (k == 0 || k == 3), is miscompiled by ptxas
  // at -O3 for sm_90a: the red channel read 1 in cascades 1 and 2.)
  float tint_r = 1.0f, tint_g = 1.0f, tint_b = 1.0f;
  if (shadows_on && s_flag[4] == 1) {
    tint_r = (0xF9u >> cascade) & 1u ? 1.0f : 0.25f;  // cascades 0, 3 and beyond
    tint_g = (0xFAu >> cascade) & 1u ? 1.0f : 0.25f;  // cascades 1, 3 and beyond
    tint_b = (0x04u >> cascade) & 1u ? 1.0f : 0.25f;  // cascade 2
  }
  const float ao = s_flag[5] == 1 ? __ldg(a.ssao + i) : 1.0f;
  color[0] = color[0] * shadow * tint_r * ao;
  color[1] = color[1] * shadow * tint_g * ao;
  color[2] = color[2] * shadow * tint_b * ao;
  a.out[i] = make_float4(color[0], color[1], color[2], 1.0f);
}

}  // namespace

// sizeof(DeferredArgs), for the wrapper's check of its mirror.
extern "C" int deferred_args_size() { return static_cast<int>(sizeof(DeferredArgs)); }

// One launch over the (rows, width) planes on `stream`. Returns the launch's
// cudaError_t.
extern "C" int deferred_shade(const DeferredArgs* args, void* stream) {
  if (args->rows < 1 || args->width < 1 || args->n_levels < 1 ||
      args->n_levels > DEFERRED_MAX_LEVELS || args->n_cascades < 1 ||
      args->n_cascades > DEFERRED_MAX_CASCADES || args->n_materials < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(DEFERRED_BX, DEFERRED_BY);
  const dim3 grid((args->width + DEFERRED_BX - 1) / DEFERRED_BX,
                  (args->rows + DEFERRED_BY - 1) / DEFERRED_BY);
  deferred_shade_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The atmosphere's single-scattering integral (Felix Westin's ray-marched
// model, utopian/shaders/include/atmosphere.glsl:154-215): per ray, the
// scattered color of ops/atmosphere.py::integrate_scattering, and with a sky
// flag the miss shader's sky_radiance (the color clamped to <= 1, black where
// the flag is not 1).
//
// No Pallas kernel is replaced: the JAX package writes the integral as tensor
// code (rust_renderer_tpu/ops/atmosphere.py), which XLA fuses inside the
// jitted frame. The port's eager loop runs ~5,000 full-screen tensor
// operations a call, each a launch and a round trip of every intermediate
// through device memory; this kernel is that loop in one launch.
//
// What bounds it on an H100: operations. A ray takes 16 view samples, each
// with an 8-sample optical depth toward the light: 16 x (1 + 8) density
// evaluations, 384 expf, 162 sqrtf, 16 powf, 19 divisions and ~6,000 other
// float32 operations (~11,000 instructions with the library calls:
// chip_smoke.py's SKY_OPS_PER_RAY), against 24 bytes of origin and direction
// read and 12 (24 with the transmittance) written. The design, one thread
// per ray:
//   - the whole march stays in registers; a ray reads its origin and
//     direction once and writes its result once;
//   - the model's constants are compile-time constants, and the phase terms
//     and the light direction's quadratic coefficient are computed once a ray;
//   - the light direction and the sky flag are read from device memory, so a
//     launch captured into a CUDA graph replays with the view's current
//     values;
//   - every value is computed by the eager loop's float32 operations in its
//     order (built with -fmad=false, expf / sqrtf / powf from the CUDA math
//     library, no fast math). Where PyTorch's CUDA kernels divide by a host
//     scalar they multiply by its float32 reciprocal, so the kernel does the
//     same; a Python scalar over a tensor is the tensor's reciprocal times the
//     scalar. clamp_min / clamp_max / clamp keep a NaN, as PyTorch's do, so a
//     zero or NaN direction gives what the eager loop gives.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#define SKY_THREADS 256
#define SKY_VIEW_SAMPLES 16   // ops/atmosphere.py _SCATTERING_SAMPLES
#define SKY_LIGHT_SAMPLES 8   // ops/atmosphere.py _OPTICAL_DEPTH_SAMPLES

namespace {

// float32 values of ops/atmosphere.py's constants, as PyTorch's CUDA kernels
// see them (a Python float rounded to float32; 1 / h computed in float32).
constexpr float kPlanetRadius = 6371000.0f;
constexpr float kCenterY = -6371000.0f;              // _PLANET_CENTER
constexpr float kAtmosphereR2 = 0x1.30ac1cp+45f;     // (PLANET_RADIUS + ATMOSPHERE_HEIGHT) ** 2
constexpr float kInvAtmosphereHeight = 0x1.4f8b58p-17f;  // 1 / 100000
constexpr float kInvRayleighHeight = 0x1.0624dep-13f;    // 1 / 8000
constexpr float kInvMieHeight = 0x1.b4e81cp-11f;         // 1 / 1200
constexpr float kInvOzoneWidth = 0x1.179ecap-14f;        // 1 / 15000
constexpr float kOzoneCenter = 25000.0f;
constexpr float kMie = 0x1.0c2ac2p-18f;  // C_MIE, the same in each channel
constexpr float kMieAbsorb = 0x1.19999ap+0f;  // 1.1
constexpr float kDensity = 1.0f;              // ATMOSPHERE_DENSITY
constexpr float kExposure = 20.0f;
constexpr float kInv16Pi = 0x1.45f306p-6f;    // 1 / (16 pi), _phase_rayleigh
constexpr float kMieK = 0x1.f59f56p-1f;       // _phase_mie's k at g = 0.85
constexpr float kMieNum = 0x1.48b7bep-5f;     // 1 - k * k
constexpr float kFourPi = 0x1.921fb6p+3f;     // 4 pi

// C_RAYLEIGH and C_OZONE by channel (c is a constant once the loops unroll).
__device__ __forceinline__ float rayleigh_coef(int c) {
  return c == 0 ? 0x1.855d9ap-18f : c == 1 ? 0x1.c6ee56p-17f : 0x1.15a9b6p-15f;
}

__device__ __forceinline__ float ozone_coef(int c) {
  return c == 0 ? 0x1.5cf752p-21f : c == 1 ? 0x1.f8ed56p-20f : 0x1.6d127ep-24f;
}

// PyTorch's clamp_min / clamp_max: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// ops/rays.py::dot, left to right.
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}

// _sphere_intersection's (t0, t1) about the planet's center: -1 on a miss.
// a is dot(dir, dir); r2 the radius squared.
__device__ __forceinline__ void sphere(float sx, float sy, float sz, float dx, float dy,
                                       float dz, float a, float r2, float* t0, float* t1) {
  const float rx = sx - 0.0f, ry = sy - kCenterY, rz = sz - 0.0f;
  const float b = 2.0f * dot3(rx, ry, rz, dx, dy, dz);
  const float c = dot3(rx, ry, rz, rx, ry, rz) - r2;
  const float d = b * b - 4.0f * a * c;
  const float sq = sqrtf(clamp_min(d, 0.0f));
  const float two_a = 2.0f * a;
  const bool miss = d < 0.0f;
  if (t0 != nullptr) *t0 = miss ? -1.0f : (-b - sq) / two_a;
  *t1 = miss ? -1.0f : (-b + sq) / two_a;
}

// _atmosphere_density(_atmosphere_height(p)): (rayleigh, mie, ozone).
__device__ __forceinline__ void density(float x, float y, float z, float* rho) {
  const float px = x - 0.0f, py = y - kCenterY, pz = z - 0.0f;
  const float h = sqrtf(dot3(px, py, pz, px, py, pz)) - kPlanetRadius;
  const float above = clamp_min(h, 0.0f);
  rho[0] = expf(-above * kInvRayleighHeight);
  rho[1] = expf(-above * kInvMieHeight);
  rho[2] = clamp_min(1.0f - fabsf(h - kOzoneCenter) * kInvOzoneWidth, 0.0f);
}

// _absorb: the transmittance of an optical depth.
__device__ __forceinline__ void absorb(const float* od, float* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = expf(-((od[0] * rayleigh_coef(c) + od[1] * kMie * kMieAbsorb + od[2] * ozone_coef(c))
                    * kDensity));
  }
}

// _integrate_optical_depth from (x, y, z) toward the light (lx, ly, lz), whose
// dot(l, l) is la.
__device__ __forceinline__ void light_depth(float x, float y, float z, float lx, float ly,
                                            float lz, float la, float* od) {
  float t1;
  sphere(x, y, z, lx, ly, lz, la, kAtmosphereR2, nullptr, &t1);
  const float step = t1 * (1.0f / SKY_LIGHT_SAMPLES);
  od[0] = od[1] = od[2] = 0.0f;
#pragma unroll
  for (int j = 0; j < SKY_LIGHT_SAMPLES; ++j) {
    const float s = (static_cast<float>(j) + 0.5f) * step;
    float rho[3];
    density(x + lx * s, y + ly * s, z + lz * s, rho);
#pragma unroll
    for (int c = 0; c < 3; ++c) od[c] = od[c] + rho[c] * step;
  }
}

// One thread a ray. origin and direction: (n_rays, 3); light_dir: (3,);
// sky_flag: null (integrate_scattering) or one int32 (sky_radiance: the
// color clamped to <= 1, and 0 where *sky_flag != 1); transmittance: null or
// (n_rays, 3).
__global__ void __launch_bounds__(SKY_THREADS)
sky_scatter_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ light_dir, const int* __restrict__ sky_flag,
                   float ray_length_max, float light_color, int n_rays,
                   float* __restrict__ color, float* __restrict__ transmittance) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * SKY_THREADS + threadIdx.x;
  if (i >= n_rays) return;
  float sx = origin[3 * i + 0], sy = origin[3 * i + 1], sz = origin[3 * i + 2];
  const float dx = direction[3 * i + 0], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  const float lx = light_dir[0], ly = light_dir[1], lz = light_dir[2];

  // The march's exponent from the start's height, then the start advanced to
  // the atmosphere where it begins outside.
  const float px = sx - 0.0f, py = sy - kCenterY, pz = sz - 0.0f;
  const float ray_height = sqrtf(dot3(px, py, pz, px, py, pz)) - kPlanetRadius;
  const float exponent =
      1.0f + clamp_max(clamp_min(1.0f - ray_height * kInvAtmosphereHeight, 0.0f), 1.0f) * 8.0f;
  float t0, t1;
  sphere(sx, sy, sz, dx, dy, dz, dot3(dx, dy, dz, dx, dy, dz), kAtmosphereR2, &t0, &t1);
  float ray_length = clamp_max(t1, ray_length_max);
  const float advance = clamp_min(t0, 0.0f);
  if (t0 > 0.0f) {
    sx = sx + dx * advance;
    sy = sy + dy * advance;
    sz = sz + dz * advance;
    ray_length = ray_length - advance;
  }

  const float costh = dot3(dx, dy, dz, lx, ly, lz);
  const float phase_r = 3.0f * (1.0f + costh * costh) * kInv16Pi;
  const float mie_kc = 1.0f - kMieK * costh;
  const float phase_m = (1.0f / (kFourPi * mie_kc * mie_kc)) * kMieNum;
  const float la = dot3(lx, ly, lz, lx, ly, lz);

  float od[3] = {0.0f, 0.0f, 0.0f}, rayleigh[3] = {0.0f, 0.0f, 0.0f},
        mie[3] = {0.0f, 0.0f, 0.0f};
  float prev_time = 0.0f;
#pragma unroll 1
  for (int k = 0; k < SKY_VIEW_SAMPLES; ++k) {
    const float ray_time =
        powf(static_cast<float>(k) / SKY_VIEW_SAMPLES, exponent) * ray_length;
    const float step = ray_time - prev_time;
    const float x = sx + dx * ray_time, y = sy + dy * ray_time, z = sz + dz * ray_time;
    float rho[3];
    density(x, y, z, rho);
#pragma unroll
    for (int c = 0; c < 3; ++c) od[c] = od[c] + rho[c] * step;
    float view_t[3], light_od[3], light_t[3];
    absorb(od, view_t);
    light_depth(x, y, z, lx, ly, lz, la, light_od);
    absorb(light_od, light_t);
    const float wr = phase_r * rho[0], wm = phase_m * rho[1];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float common = view_t[c] * light_t[c] * step;
      rayleigh[c] = rayleigh[c] + common * wr;
      mie[c] = mie[c] + common * wm;
    }
    prev_time = ray_time;
  }

  const bool sky_on = sky_flag == nullptr || *sky_flag == 1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = (rayleigh[c] * rayleigh_coef(c) + mie[c] * kMie) * light_color * kExposure;
    if (sky_flag != nullptr) v = sky_on ? clamp_max(v, 1.0f) : 0.0f;
    color[3 * i + c] = v;
  }
  if (transmittance != nullptr) {
    float t[3];
    absorb(od, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) transmittance[3 * i + c] = t[c];
  }
}

}  // namespace

// sky_flag and transmittance may be null. Returns the launch's cudaError_t.
extern "C" int sky_scatter(const float* origin, const float* direction, const float* light_dir,
                           const int* sky_flag, float ray_length_max, float light_color,
                           int n_rays, float* color, float* transmittance, void* stream) {
  if (n_rays < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + SKY_THREADS - 1) / SKY_THREADS;
  sky_scatter_kernel<<<blocks, SKY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, light_dir, sky_flag, ray_length_max, light_color, n_rays, color,
      transmittance);
  return static_cast<int>(cudaGetLastError());
}

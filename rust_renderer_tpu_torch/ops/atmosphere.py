"""Raymarched atmospheric scattering (utopian/shaders/include/atmosphere.glsl,
Felix Westin's model), the port of ``rust_renderer_tpu/ops/atmosphere.py``.

Rayleigh/Mie/ozone densities, 8-sample optical depth toward the light,
16-sample exponentially distributed view-ray integration, exposure 20.
"""

from __future__ import annotations

import math

import torch

from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.rays import dot, length

PLANET_RADIUS = 6371000.0
ATMOSPHERE_HEIGHT = 100000.0
RAYLEIGH_HEIGHT = ATMOSPHERE_HEIGHT * 0.08
MIE_HEIGHT = ATMOSPHERE_HEIGHT * 0.012
C_RAYLEIGH = (5.802e-6, 13.558e-6, 33.100e-6)
C_MIE = (3.996e-6, 3.996e-6, 3.996e-6)
C_OZONE = (0.650e-6, 1.881e-6, 0.085e-6)
ATMOSPHERE_DENSITY = 1.0
EXPOSURE = 20.0

_PLANET_CENTER = (0.0, -PLANET_RADIUS, 0.0)

_OPTICAL_DEPTH_SAMPLES = 8
_SCATTERING_SAMPLES = 16


def _sphere_intersection(ray_start, ray_dir, center, radius):
    """(atmosphere.glsl:55-71): returns (t0, t1); both -1 on miss."""
    rs = ray_start - center
    a = dot(ray_dir, ray_dir)
    b = 2.0 * dot(rs, ray_dir)
    c = dot(rs, rs) - radius * radius
    d = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp_min(d, 0.0))
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    miss = d < 0
    return torch.where(miss, -1.0, t0), torch.where(miss, -1.0, t1)


def planet_intersection(ray_start, ray_dir):
    return _sphere_intersection(ray_start, ray_dir,
                                device_constant(_PLANET_CENTER, ray_start.device),
                                PLANET_RADIUS)


def atmosphere_intersection(ray_start, ray_dir):
    return _sphere_intersection(ray_start, ray_dir,
                                device_constant(_PLANET_CENTER, ray_start.device),
                                PLANET_RADIUS + ATMOSPHERE_HEIGHT)


def _phase_rayleigh(costh):
    return 3.0 * (1.0 + costh * costh) / (16.0 * math.pi)


def _phase_mie(costh, g=0.85):
    g = min(g, 0.9381)
    k = 1.55 * g - 0.55 * g * g * g
    kcosth = k * costh
    return (1.0 - k * k) / ((4.0 * math.pi) * (1.0 - kcosth) * (1.0 - kcosth))


def _atmosphere_height(position):
    return length(position - device_constant(_PLANET_CENTER, position.device)) - PLANET_RADIUS


def _atmosphere_density(h):
    """(rayleigh, mie, ozone) densities at height h; (...,3)."""
    rayleigh = torch.exp(-torch.clamp_min(h, 0.0) / RAYLEIGH_HEIGHT)
    mie = torch.exp(-torch.clamp_min(h, 0.0) / MIE_HEIGHT)
    ozone = torch.clamp_min(1.0 - (h - 25000.0).abs() / 15000.0, 0.0)
    return torch.stack([rayleigh, mie, ozone], dim=-1)


def _integrate_optical_depth(ray_start, ray_dir):
    """8-sample optical depth to the atmosphere boundary (glsl:123-144)."""
    _, t1 = atmosphere_intersection(ray_start, ray_dir)
    step_size = t1 / _OPTICAL_DEPTH_SAMPLES
    optical_depth = torch.zeros(ray_start.shape[:-1] + (3,), dtype=torch.float32,
                                device=ray_start.device)
    for i in range(_OPTICAL_DEPTH_SAMPLES):
        local_pos = ray_start + ray_dir * ((i + 0.5) * step_size)[..., None]
        optical_depth = optical_depth + _atmosphere_density(
            _atmosphere_height(local_pos)) * step_size[..., None]
    return optical_depth


def _absorb(optical_depth):
    """(glsl:147-151); Mie absorbs ~10% more than it scatters."""
    like = optical_depth
    return torch.exp(
        -(
            optical_depth[..., 0:1] * device_constant(C_RAYLEIGH, like.device)
            + optical_depth[..., 1:2] * device_constant(C_MIE, like.device) * 1.1
            + optical_depth[..., 2:3] * device_constant(C_OZONE, like.device)
        )
        * ATMOSPHERE_DENSITY
    )


def integrate_scattering(ray_start, ray_dir, ray_length, light_dir, light_color):
    """Single-light scattering integral (glsl:154-215).

    ray_start/ray_dir: (...,3); ray_length float or (...,); light_dir (3,).
    Returns (color (...,3), transmittance (...,3)).
    """
    ray_height = _atmosphere_height(ray_start)
    exponent = 1.0 + torch.clamp(1.0 - ray_height / ATMOSPHERE_HEIGHT, 0.0, 1.0) * 8.0

    t0, t1 = atmosphere_intersection(ray_start, ray_dir)
    ray_length = torch.clamp_max(t1, ray_length)
    advance = torch.clamp_min(t0, 0.0)
    entered = t0 > 0
    ray_start = torch.where(entered[..., None], ray_start + ray_dir * advance[..., None],
                            ray_start)
    ray_length = torch.where(entered, ray_length - advance, ray_length)

    costh = dot(ray_dir, light_dir)
    phase_r = _phase_rayleigh(costh)
    phase_m = _phase_mie(costh)

    optical_depth = torch.zeros(ray_dir.shape[:-1] + (3,), dtype=torch.float32,
                                device=ray_dir.device)
    rayleigh = torch.zeros_like(optical_depth)
    mie = torch.zeros_like(optical_depth)
    prev_ray_time = torch.zeros_like(ray_length)
    light_dirs = torch.broadcast_to(light_dir, ray_start.shape)

    for i in range(_SCATTERING_SAMPLES):
        ray_time = torch.pow(i / _SCATTERING_SAMPLES, exponent) * ray_length
        step_size = ray_time - prev_ray_time
        local_pos = ray_start + ray_dir * ray_time[..., None]
        local_density = _atmosphere_density(_atmosphere_height(local_pos))
        optical_depth = optical_depth + local_density * step_size[..., None]
        view_transmittance = _absorb(optical_depth)
        light_od = _integrate_optical_depth(local_pos, light_dirs)
        light_transmittance = _absorb(light_od)
        common = view_transmittance * light_transmittance * step_size[..., None]
        rayleigh = rayleigh + common * (phase_r * local_density[..., 0])[..., None]
        mie = mie + common * (phase_m * local_density[..., 1])[..., None]
        prev_ray_time = ray_time

    transmittance = _absorb(optical_depth)
    color = ((rayleigh * device_constant(C_RAYLEIGH, rayleigh.device)
              + mie * device_constant(C_MIE, mie.device))
             * light_color * EXPOSURE)
    return color, transmittance


def sky_radiance(ray_origin, ray_dir, sun_dir, sky_enabled):
    """Miss-shader sky (pathtrace_reference/reference.rmiss): scattering
    clamped to <= 1, black when the sky toggle is off."""
    color, _ = integrate_scattering(ray_origin, ray_dir, 999999999.0, sun_dir, 1.0)
    color = torch.clamp_max(color, 1.0)
    return torch.where(sky_enabled == 1, color, 0.0)

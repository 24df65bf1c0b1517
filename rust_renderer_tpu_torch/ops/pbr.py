"""Cook-Torrance surface shading and split-sum IBL (the port of
``rust_renderer_tpu/ops/pbr.py``; utopian/shaders/include/pbr_lighting.glsl:
`surfaceShading` :20-79 and `imageBasedLighting` :81-108).

Light fields follow GpuLight (renderer.rs:46-59); every function works on
(H, W) planes of PixelParams.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops import brdf
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.cubemap import sample_cubemap, sample_cubemap_lod
from rust_renderer_tpu_torch.ops.rays import dot


class PixelParams(NamedTuple):
    """pbr_lighting.glsl:9-18."""

    position: torch.Tensor  # (..., 3)
    base_color: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3)
    metallic: torch.Tensor  # (...,)
    roughness: torch.Tensor  # (...,)
    occlusion: torch.Tensor  # (...,)


def material_pixel(scene, position, normal, albedo, pbr) -> PixelParams:
    """Gbuffer planes -> PixelParams with the material's factors applied and
    albedo decoded with pow 2.2 (deferred.frag:55-70, forward.frag)."""
    material = pbr[..., 3].to(torch.int64).clamp(0, scene.mat_roughness.shape[0] - 1)
    return PixelParams(
        position=position,
        base_color=torch.pow(torch.clamp_min(albedo, 0.0), 2.2)
        * scene.mat_base_color[material][..., :3],
        normal=normal,
        metallic=pbr[..., 0] * scene.mat_metallic[material],
        roughness=pbr[..., 1] * scene.mat_roughness[material],
        occlusion=pbr[..., 2])


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(_norm(v), 1e-9)[..., None]


def surface_shading(pixel: PixelParams, light_color, light_pos, light_dir,
                    light_type: float, light_att, light_spot, eye_pos,
                    light_color_factor=1.0) -> torch.Tensor:
    """One light's Cook-Torrance contribution (pbr_lighting.glsl:20-79).
    light_type: 0 directional, 1 point, 2 spot; the light's radiance is
    scaled by `light_color_factor` (a number or a tensor)."""
    n = pixel.normal
    v = _unit(eye_pos - pixel.position)
    f0 = 0.04 + (pixel.base_color - 0.04) * pixel.metallic[..., None]

    pos_to_light = light_pos - pixel.position
    d = _norm(pos_to_light)
    l_point = pos_to_light / torch.clamp_min(d, 1e-9)[..., None]
    l_directional = _unit(light_dir * device_constant((-1.0, 1.0, -1.0), light_dir.device))
    att_point = 1.0 / torch.clamp_min(
        light_att[..., 0] + light_att[..., 1] * d + light_att[..., 2] * d * d, 1e-9)
    spot_factor = torch.pow(torch.clamp_min(dot(l_point, _unit(light_dir)), 0.0), light_spot)

    is_dir = light_type == 0.0
    is_spot = light_type == 2.0
    l = torch.where(is_dir[..., None], l_directional, l_point)
    attenuation = torch.where(is_dir, 1.0,
                              torch.where(is_spot, spot_factor * att_point, att_point))
    h = _unit(l + v)
    radiance = light_color[..., :3] * attenuation[..., None]
    if not (isinstance(light_color_factor, (int, float)) and light_color_factor == 1.0):
        radiance = radiance * light_color_factor

    ndf = brdf.distribution_ggx(n, h, pixel.roughness)
    g = brdf.geometry_smith(n, v, l, pixel.roughness)
    f = brdf.fresnel_schlick(torch.clamp_min(dot(h, v), 0.0), f0)
    kd = (1.0 - f) * (1.0 - pixel.metallic[..., None])
    ndotv = torch.clamp_min(dot(n, v), 0.0)
    ndotl = torch.clamp_min(dot(n, l), 0.0)
    specular = (ndf * g)[..., None] * f / (4.0 * ndotv * ndotl + 0.0001)[..., None]
    return (kd * pixel.base_color / brdf.PI + specular) * radiance * ndotl[..., None]


def shade_all_lights(pixel: PixelParams, scene, view, max_lights: int | None = None
                     ) -> torch.Tensor:
    """The sun (directional, white) plus the first view.num_lights scene
    lights (deferred.frag:73-80), of at most the first `max_lights` of the
    scene's light slots."""
    dev = pixel.position.device
    ones = torch.ones(3, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = surface_shading(pixel, ones, torch.zeros(3, device=dev), view.sun_dir,
                          zero, ones, zero, view.eye_pos)
    n_lights = scene.light_pos.shape[0]
    if max_lights is not None:
        n_lights = min(n_lights, max_lights)
    for i in range(n_lights):
        contrib = surface_shading(
            pixel, scene.light_color[i], scene.light_pos[i], scene.light_dir[i],
            scene.light_type[i], scene.light_att[i], scene.light_spot[i], view.eye_pos)
        out = out + torch.where(i < view.num_lights, contrib, 0.0)
    return out


def image_based_lighting(pixel: PixelParams, eye_pos, irradiance_map,
                         specular_map: list, brdf_lut, max_reflection_lod: float = 7.0):
    """Split-sum ambient (pbr_lighting.glsl:81-108)."""
    v = _unit(eye_pos - pixel.position)
    n = pixel.normal
    r = -(v - 2.0 * dot(v, n)[..., None] * n)  # R = -reflect(V, N)
    f0 = 0.04 + (pixel.base_color - 0.04) * pixel.metallic[..., None]
    ndotv = torch.clamp_min(dot(n, v), 0.0)
    f = brdf.fresnel_schlick_roughness(ndotv, f0, pixel.roughness)
    kd = (1.0 - f) * (1.0 - pixel.metallic[..., None])
    diffuse = sample_cubemap(irradiance_map, n) * pixel.base_color
    prefiltered = sample_cubemap_lod(specular_map, r, pixel.roughness * max_reflection_lod)
    # LUT indexed by (NdotV, 1 - roughness) (pbr_lighting.glsl:103).
    size = brdf_lut.shape[0]
    lx = torch.clamp(ndotv * (size - 1), 0, size - 1).to(torch.int64)
    ly = torch.clamp((1.0 - pixel.roughness) * (size - 1), 0, size - 1).to(torch.int64)
    ab = brdf_lut[ly, lx]
    specular = prefiltered * (f * ab[..., 0:1] + ab[..., 1:2])
    return (kd * diffuse + specular) * pixel.occlusion[..., None]

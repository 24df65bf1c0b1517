"""RTIOW-style material scattering (reference.rchit:12-91), the port of
``rust_renderer_tpu/ops/materials.py``.

Every lane evaluates all four material branches and selects by type. Every
lane consumes one unit-sphere sample and one float per scatter, so per-lane
random streams stay aligned with the JAX package's.

Material types (renderer.rs:31-34): 0 lambertian, 1 metal (prop = fuzz),
2 dielectric (prop = index of refraction), 3 diffuse light.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops import rays as rayops
from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.ops.texture import sample_texture_bilinear


def schlick_reflectance(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (reference.rchit:12-18)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp_min(1.0 - cosine, 0.0), 5.0)


class Scatter(NamedTuple):
    color: torch.Tensor  # (..., 3) attenuation
    direction: torch.Tensor  # (..., 3) scattered ray dir (unnormalized)
    is_scattered: torch.Tensor  # (...,) bool


def scatter(scene, material, ray_dir, world_normal, uv, state):
    """The hit 'shader' for a batch of hits (reference.rchit:20-91).

    material: (...,) ids into the material table; world_normal already
    flipped toward the incident ray. Returns (new_rng_state, Scatter).
    """
    material = material.to(torch.int64)
    mat_type = scene.mat_rt_type[material]
    mat_prop = scene.mat_rt_prop[material]
    base_color = scene.mat_base_color[material][..., :3]
    diffuse_map = scene.mat_diffuse_map[material]

    # Albedo: texture * base_color_factor (reference.rchit:42-43).
    tex_rgb = sample_texture_bilinear(scene.textures, diffuse_map, uv)[..., :3]
    albedo = tex_rgb * base_color

    state, unit_sphere = rngmod.random_in_unit_sphere_fast(state)
    state, rand_refl = rngmod.random_float(state)

    dirn = rayops.normalize(ray_dir)

    # Lambertian (reference.rchit:47-50).
    lam_dir = world_normal + unit_sphere
    lam_scattered = rayops.dot(ray_dir, world_normal) < 0.0

    # Metal (reference.rchit:52-59): fuzzed mirror, white.
    metal_dir = rayops.reflect(dirn, world_normal) + mat_prop[..., None] * unit_sphere

    # Dielectric (reference.rchit:61-81), on the flipped normal as the JAX
    # package computes it.
    dir_normal_dot = rayops.dot(dirn, world_normal)
    outward_normal = torch.where((dir_normal_dot > 0)[..., None], -world_normal,
                                 world_normal)
    refraction_ratio = torch.where(dir_normal_dot > 0, mat_prop,
                                   1.0 / torch.clamp_min(mat_prop, 1e-6))
    cos_theta = torch.clamp_max(rayops.dot(-dirn, outward_normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    reflectance = schlick_reflectance(cos_theta, refraction_ratio)
    must_reflect = cannot_refract | (reflectance > rand_refl)
    diel_dir = torch.where(
        must_reflect[..., None],
        rayops.reflect(dirn, outward_normal),
        rayops.refract(dirn, outward_normal, refraction_ratio),
    )

    is_lam = (mat_type == 0)[..., None]
    is_metal = (mat_type == 1)[..., None]
    is_diel = (mat_type == 2)[..., None]

    color = torch.where(is_lam, albedo, 1.0)  # metal/dielectric/light = white
    direction = torch.where(
        is_lam, lam_dir,
        torch.where(is_metal, metal_dir, torch.where(is_diel, diel_dir, 0.0)))
    is_scattered = torch.where(mat_type == 0, lam_scattered, mat_type != 3)
    return state, Scatter(color=color, direction=direction, is_scattered=is_scattered)

"""Microfacet BRDF pieces (the port of ``rust_renderer_tpu/ops/brdf.py``,
utopian/shaders/include/brdf.glsl): GGX distribution, Schlick-GGX / Smith
geometry, Fresnel-Schlick, the Hammersley sequence and GGX importance
sampling, over batches of pixels or samples."""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.ops.rays import cross, dot
from rust_renderer_tpu_torch.ops.rng import MASK32

PI = 3.14159265359


def _dot_clamped(a, b):
    return torch.clamp_min(dot(a, b), 0.0)


def distribution_ggx(n, h, roughness):
    """GGX NDF (brdf.glsl:3-16)."""
    a = roughness * roughness
    a2 = a * a
    ndoth = _dot_clamped(n, h)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv, roughness):
    """Direct-lighting k remapping (brdf.glsl:18-28)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(n, v, l, roughness):
    """(brdf.glsl:30-37)."""
    return (geometry_schlick_ggx(_dot_clamped(n, v), roughness)
            * geometry_schlick_ggx(_dot_clamped(n, l), roughness))


def fresnel_schlick(cos_theta, f0):
    """(brdf.glsl:82-85). f0: (...,3); cos_theta: (...,)."""
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]


def fresnel_schlick_roughness(cos_theta, f0, roughness):
    """(brdf.glsl:87-91)."""
    max_refl = torch.maximum(1.0 - roughness[..., None], f0)
    return f0 + (max_refl - f0) * torch.pow(
        torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]


def _glsl_random(cx, cy):
    """byteblacksmith one-liner rand (brdf.glsl:40-48)."""
    dt = cx * 12.9898 + cy * 78.233
    sn = torch.remainder(dt, 3.14)
    return torch.remainder(torch.sin(sn) * 43758.5453, 1.0)


def hammersley2d(i: torch.Tensor, n: int) -> torch.Tensor:
    """Radical-inverse pair (brdf.glsl:51-60); the uint32 bit reversal is
    done in int64 and masked to 32 bits. i: int tensor -> (..., 2)."""
    bits = i.to(torch.int64) & MASK32
    bits = ((bits << 16) | (bits >> 16)) & MASK32
    for mask, shift in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        bits = ((bits & mask) << shift) | ((bits >> shift) & mask)
    rdi = bits.to(torch.float32) * 2.3283064365386963e-10
    return torch.stack([i.to(torch.float32) / n, rdi], dim=-1)


def importance_sample_ggx(xi, roughness, normal):
    """A GGX-distributed half vector about `normal` (brdf.glsl:63-80), with
    the reference's small random phi jitter. xi (...,2), roughness (...,),
    normal (...,3) -> (...,3)."""
    alpha = roughness * roughness
    phi = 2.0 * PI * xi[..., 0] + _glsl_random(normal[..., 0], normal[..., 2]) * 0.1
    cos_theta = torch.sqrt((1.0 - xi[..., 1]) / (1.0 + (alpha * alpha - 1.0) * xi[..., 1]))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    hx, hy, hz = sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta

    z_up = (normal[..., 2].abs() < 0.999)[..., None]
    up = torch.where(z_up, normal.new_tensor([0.0, 0.0, 1.0]),
                     normal.new_tensor([1.0, 0.0, 0.0]))
    tx = cross(up, normal)
    tx = tx / torch.clamp_min(tx.norm(dim=-1, keepdim=True), 1e-12)
    ty = cross(normal, tx)
    ty = ty / torch.clamp_min(ty.norm(dim=-1, keepdim=True), 1e-12)
    out = tx * hx[..., None] + ty * hy[..., None] + normal * hz[..., None]
    return out / torch.clamp_min(out.norm(dim=-1, keepdim=True), 1e-12)

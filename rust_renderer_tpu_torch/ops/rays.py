"""Ray generation, origin offsetting and primitive intersection, vectorized
over ray arrays (the port of ``rust_renderer_tpu/ops/rays.py``).

Rays are (..., 3) float32 tensors; every op broadcasts over leading dims.
"""

from __future__ import annotations

import torch

INF = 3.0e38  # the miss distance


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of products over the last axis of length 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def generate_camera_rays(
    inverse_view: torch.Tensor,
    inverse_projection: torch.Tensor,
    pixel_centers_x: torch.Tensor,
    pixel_centers_y: torch.Tensor,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays through (jittered) pixel centers (reference.rgen:30-38).
    Returns (origin (...,3), direction (...,3)); direction normalized."""
    u = pixel_centers_x / float(width)
    v = 1.0 - pixel_centers_y / float(height)  # inUV.y flip (reference.rgen:33)
    dx = u * 2.0 - 1.0
    dy = v * 2.0 - 1.0

    ip = inverse_projection
    target = (
        ip[:3, 0] * dx[..., None]
        + ip[:3, 1] * dy[..., None]
        + ip[:3, 2]
        + ip[:3, 3]
    )
    tw = ip[3, 0] * dx + ip[3, 1] * dy + ip[3, 2] + ip[3, 3]
    target = target / tw[..., None]
    tn = target / length(target)[..., None]
    r = inverse_view[:3, :3]
    direction = torch.stack([dot(tn, r[0]), dot(tn, r[1]), dot(tn, r[2])], dim=-1)
    origin = torch.broadcast_to(inverse_view[:3, 3], direction.shape)
    return origin, direction


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Self-intersection-safe origin offset (view.glsl:90-109): the Ray
    Tracing Gems ch.6 integer-ulp trick via float32 bitcasts."""
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0

    of_i = (int_scale * n).to(torch.int32)
    p = p.contiguous()
    p_bits = p.view(torch.int32)
    p_i = (p_bits + torch.where(p < 0, -of_i, of_i)).view(torch.float32)
    return torch.where(p.abs() < origin, p + float_scale * n, p_i)


def intersect_sphere(ray_origin, ray_dir, center, radius, t_min=1e-3, t_max=1e4):
    """Nearest hit t in (t_min, t_max), else INF. Returns (t, hit_mask)."""
    oc = ray_origin - center
    a = dot(ray_dir, ray_dir)
    half_b = dot(oc, ray_dir)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sqrt_d = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-half_b - sqrt_d) / a
    t1 = (-half_b + sqrt_d) / a
    t = torch.where((t0 > t_min) & (t0 < t_max), t0, t1)
    hit = (disc > 0.0) & (t > t_min) & (t < t_max)
    return torch.where(hit, t, INF), hit


def intersect_triangle(ray_origin, ray_dir, v0, v1, v2, t_min=1e-3, t_max=1e4):
    """Möller–Trumbore, backfaces hit. Returns (t, u, v, hit); t=INF on miss.
    Barycentrics: P = (1-u-v)·v0 + u·v1 + v·v2."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(ray_dir, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvec = ray_origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(ray_dir, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return torch.where(hit, t, INF), u, v, hit


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL reflect()."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """GLSL refract(); d, n normalized; eta = n1/n2 per ray. Returns the zero
    vector on total internal reflection (like GLSL)."""
    cos_i = -dot(d, n)[..., None]
    eta = eta[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refr = eta * d + (eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0))) * n
    return torch.where(k < 0.0, 0.0, refr)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(length(v), eps)[..., None]

"""Scene intersection records and hit-point shading inputs (the port of
``rust_renderer_tpu/ops/intersect.py``).

Hit encoding mirrors what the reference's hit shaders receive: triangle id,
barycentrics, and a kind: 0 = miss, 1 = triangle, 2 = analytic sphere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops import rays as rayops

HIT_NONE = 0
HIT_TRIANGLE = 1
HIT_SPHERE = 2

_TRI_CHUNK = 128


class Hit(NamedTuple):
    t: torch.Tensor  # (...,) f32, INF on miss
    kind: torch.Tensor  # (...,) i32
    prim: torch.Tensor  # (...,) i32: triangle id or sphere id
    u: torch.Tensor  # (...,) f32 barycentric
    v: torch.Tensor  # (...,) f32 barycentric

    @property
    def is_hit(self) -> torch.Tensor:
        return self.kind != HIT_NONE


def _intersect_spheres(scene, origin, direction, t_min, t_max, best: Hit) -> Hit:
    """Merge the scene's analytic spheres into `best` (nearer hit wins)."""
    for i in range(scene.sphere_center.shape[0]):
        t, hit = rayops.intersect_sphere(
            origin, direction, scene.sphere_center[i], scene.sphere_radius[i],
            t_min, t_max)
        closer = hit & (t < best.t)
        best = Hit(
            t=torch.where(closer, t, best.t),
            kind=torch.where(closer, HIT_SPHERE, best.kind).to(torch.int32),
            prim=torch.where(closer, i, best.prim).to(torch.int32),
            u=best.u,
            v=best.v,
        )
    return best


def closest_hit_bruteforce(scene, origin, direction, t_min=1e-3, t_max=1e4) -> Hit:
    """Exhaustive closest hit over every triangle and sphere, chunked over
    triangles. origin/direction: (..., 3). A reference for tests."""
    shape = origin.shape[:-1]
    dev = origin.device
    best = Hit(
        t=torch.full(shape, rayops.INF, dtype=torch.float32, device=dev),
        kind=torch.zeros(shape, dtype=torch.int32, device=dev),
        prim=torch.zeros(shape, dtype=torch.int32, device=dev),
        u=torch.zeros(shape, dtype=torch.float32, device=dev),
        v=torch.zeros(shape, dtype=torch.float32, device=dev),
    )
    n_tris = scene.indices.shape[0]
    o = origin[..., None, :]
    d = direction[..., None, :]
    per_ray = lambda x: x[..., None] if torch.is_tensor(x) and x.ndim > 0 else x
    t_min_b, t_max_b = per_ray(t_min), per_ray(t_max)
    for start in range(0, n_tris, _TRI_CHUNK):
        ids = scene.indices[start:start + _TRI_CHUNK].to(torch.int64)
        tv = scene.positions[ids]  # (C,3,3)
        t, u, v, _ = rayops.intersect_triangle(o, d, tv[:, 0], tv[:, 1], tv[:, 2],
                                               t_min_b, t_max_b)
        tbest, arg = torch.min(t, dim=-1)
        closer = tbest < best.t
        pick = lambda a: torch.gather(a, -1, arg[..., None])[..., 0]
        best = Hit(
            t=torch.where(closer, tbest, best.t),
            kind=torch.where(closer, HIT_TRIANGLE, best.kind).to(torch.int32),
            prim=torch.where(closer, arg.to(torch.int32) + start, best.prim),
            u=torch.where(closer, pick(u), best.u),
            v=torch.where(closer, pick(v), best.v),
        )
    return _intersect_spheres(scene, origin, direction, t_min, t_max, best)


class Surface(NamedTuple):
    """Interpolated shading inputs at a hit point (reference.rchit:22-43)."""

    position: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3), flipped toward the incident ray
    geo_normal: torch.Tensor  # (..., 3), not flipped
    uv: torch.Tensor  # (..., 2)
    material: torch.Tensor  # (...,) i32
    mesh: torch.Tensor  # (...,) i32 (gpu mesh id; -1 for spheres)


def _shade_table(scene) -> torch.Tensor:
    """(T, 17) per-triangle shading rows: [n0 n1 n2 | uv0 uv1 uv2 | material
    mesh] (ints bitcast to f32), so a hit fetches one row."""
    idx = scene.indices.to(torch.int64)
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    material = scene.mesh_material[scene.tri_mesh.to(torch.int64)]
    return torch.cat(
        [
            scene.normals[i0], scene.normals[i1], scene.normals[i2],
            scene.uvs[i0], scene.uvs[i1], scene.uvs[i2],
            material.to(torch.int32).view(torch.float32)[:, None],
            scene.tri_mesh.to(torch.int32).view(torch.float32)[:, None],
        ],
        dim=1,
    )


def surface_at_hit(scene, hit: Hit, origin, direction) -> Surface:
    """Gather + interpolate vertex attributes at hits (reference.rchit:25-41).
    Safe on miss lanes (garbage there; mask downstream)."""
    shape = hit.t.shape
    dev = hit.t.device
    n_tris = scene.indices.shape[0]
    if n_tris > 0:
        table = _shade_table(scene)
        prim = hit.prim.clamp(0, n_tris - 1).to(torch.int64)
        rows = table[prim.reshape(-1)].reshape(shape + (17,))
        n0, n1, n2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
        w0 = (1.0 - hit.u - hit.v)[..., None]
        w1 = hit.u[..., None]
        w2 = hit.v[..., None]
        tri_normal = rayops.normalize(n0 * w0 + n1 * w1 + n2 * w2)
        uv0, uv1, uv2 = rows[..., 9:11], rows[..., 11:13], rows[..., 13:15]
        tri_uv = uv0 * w0 + uv1 * w1 + uv2 * w2
        tri_material = rows[..., 15].contiguous().view(torch.int32)
        tri_mesh = rows[..., 16].contiguous().view(torch.int32)
    else:
        tri_normal = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
        tri_uv = torch.zeros(shape + (2,), dtype=torch.float32, device=dev)
        tri_mesh = torch.zeros(shape, dtype=torch.int32, device=dev)
        tri_material = torch.zeros(shape, dtype=torch.int32, device=dev)

    position = origin + hit.t[..., None] * direction

    if scene.sphere_center.shape[0] > 0:
        sprim = hit.prim.clamp(0, scene.sphere_center.shape[0] - 1).to(torch.int64)
        sc = scene.sphere_center[sprim]
        sr = scene.sphere_radius[sprim][..., None]
        sphere_normal = (position - sc) / torch.clamp_min(sr, 1e-20)
        sphere_material = scene.sphere_material[sprim]
        is_sphere = hit.kind == HIT_SPHERE
        normal = torch.where(is_sphere[..., None], sphere_normal, tri_normal)
        material = torch.where(is_sphere, sphere_material, tri_material)
        mesh = torch.where(is_sphere, -1, tri_mesh).to(torch.int32)
    else:
        normal, material, mesh = tri_normal, tri_material, tri_mesh

    geo_normal = normal
    # Flip toward the incident ray (reference.rchit:34-37).
    facing = (rayops.dot(normal, direction) > 0.0)[..., None]
    normal = torch.where(facing, -normal, normal)
    return Surface(position=position, normal=normal, geo_normal=geo_normal,
                   uv=tri_uv, material=material, mesh=mesh)

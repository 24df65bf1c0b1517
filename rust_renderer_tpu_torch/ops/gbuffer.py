"""G-buffer from primary rays or a visibility buffer (the port of
``ops/gbuffer.py``'s `from_rays` and `from_visibility`).

Rebuild of utopian/shaders/gbuffer/gbuffer.{vert,frag}: attribute fetch, TBN
construction, normal mapping, and the MRT write of (world position, shading
normal, albedo, (metallic, roughness, occlusion, material id)). Visibility
comes from a closest-hit query per pixel or from the rasterizer. The clear
value is (1,1,1,0), like the reference's color attachments (pass.rs:210-215).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops import rays as rayops
from rust_renderer_tpu_torch.ops.texture import sample_texture_bilinear


class GBuffer(NamedTuple):
    position: torch.Tensor  # (H, W, 4) world position
    normal: torch.Tensor  # (H, W, 4)
    albedo: torch.Tensor  # (H, W, 4)
    pbr: torch.Tensor  # (H, W, 4): metallic, roughness, occlusion, material id
    depth: torch.Tensor  # (H, W) ndc z (1 = far)


def _gbuffer_table(scene) -> torch.Tensor:
    """(T, 38) per-triangle rows: [p0 p1 p2 | n0 n1 n2 | uv0 uv1 uv2 |
    t0 t1 t2 (xyzw) | material mesh] (ints bitcast to f32)."""
    idx = scene.indices.to(torch.int64)
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    material = scene.mesh_material[scene.tri_mesh.to(torch.int64)]
    return torch.cat(
        [
            scene.positions[i0], scene.positions[i1], scene.positions[i2],
            scene.normals[i0], scene.normals[i1], scene.normals[i2],
            scene.uvs[i0], scene.uvs[i1], scene.uvs[i2],
            scene.tangents[i0], scene.tangents[i1], scene.tangents[i2],
            material.to(torch.int32).view(torch.float32)[:, None],
            scene.tri_mesh.to(torch.int32).view(torch.float32)[:, None],
        ],
        dim=1,
    )


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(rayops.length(v), 1e-9)[..., None]


def _shade(scene, tri, u, v, covered):
    """Attribute fetch + normal mapping (gbuffer.frag:26-51). tri: (H,W)
    triangle ids; u, v barycentrics of v1, v2. Returns the four planes."""
    dev = tri.device
    # Made on the device: a host copy cannot be captured into a CUDA graph.
    clear = torch.ones(4, dtype=torch.float32, device=dev)
    clear[3:].zero_()
    if scene.indices.shape[0] == 0:
        c = torch.broadcast_to(clear, tri.shape + (4,))
        return c, c, c, c
    shape = tri.shape
    table = _gbuffer_table(scene)
    rows = table[tri.clamp(0, table.shape[0] - 1).reshape(-1).to(torch.int64)]
    rows = rows.reshape(shape + (38,))
    w0 = (1.0 - u - v)[..., None]
    w1 = u[..., None]
    w2 = v[..., None]

    def interp3(base, width=3):
        return (rows[..., base:base + width] * w0
                + rows[..., base + width:base + 2 * width] * w1
                + rows[..., base + 2 * width:base + 3 * width] * w2)

    position = interp3(0)
    normal_geo = _normalized(interp3(9))
    uv = interp3(18, width=2)
    tangent4 = interp3(24, width=4)

    material = rows[..., 36].contiguous().view(torch.int32).to(torch.int64)
    maps = torch.stack([scene.mat_diffuse_map, scene.mat_normal_map,
                        scene.mat_mr_map, scene.mat_occlusion_map], dim=1)
    map_rows = maps[material]

    diffuse = sample_texture_bilinear(scene.textures, map_rows[..., 0], uv)
    normal_map = sample_texture_bilinear(scene.textures, map_rows[..., 1], uv)
    mr = sample_texture_bilinear(scene.textures, map_rows[..., 2], uv)
    occ = sample_texture_bilinear(scene.textures, map_rows[..., 3], uv)
    metallic = mr[..., 2]
    roughness = mr[..., 1]
    occlusion = occ[..., 0]

    # TBN normal mapping where a tangent exists (gbuffer.frag:40-45).
    tangent = tangent4[..., :3]
    has_tangent = (tangent != 0.0).any(dim=-1)
    t = _normalized(tangent)
    b = rayops.cross(normal_geo, t)
    nm = _normalized(normal_map[..., :3] * 2.0 - 1.0)
    mapped = _normalized(t * nm[..., 0:1] + b * nm[..., 1:2] + normal_geo * nm[..., 2:3])
    normal = torch.where(has_tangent[..., None], mapped, normal_geo)

    mask = covered[..., None]
    ones = torch.ones_like(u)[..., None]

    def out4(rgb):
        return torch.where(mask, torch.cat([rgb, ones], dim=-1), clear)

    g_pbr = torch.where(
        mask,
        torch.stack([metallic, roughness, occlusion, material.to(torch.float32)], -1),
        clear,
    )
    return out4(position), out4(normal), out4(diffuse[..., :3]), g_pbr


def from_visibility(scene, vis) -> GBuffer:
    """Gbuffer of a rasterized visibility buffer (``ops/raster.py``'s
    VisibilityBuffer): the covered pixels' triangles shaded at their
    barycentrics, the depth as rasterized."""
    covered = vis.tri >= 0
    p, n, a, pbr = _shade(scene, vis.tri, vis.bary_u, vis.bary_v, covered)
    return GBuffer(position=p, normal=n, albedo=a, pbr=pbr, depth=vis.depth)


def from_rays(scene, hit, origin, direction, projection_view=None) -> GBuffer:
    """Primary-ray gbuffer from any closest-hit query's `hit`. Depth is NDC z
    when projection_view is given (else linear t). Analytic-sphere hits take
    their material, without normal mapping."""
    covered = hit.is_hit
    tri_covered = covered & (hit.kind == 1)
    p, n, a, pbr = _shade(scene, hit.prim, hit.u, hit.v, tri_covered)
    # The ray gives the exact hit position; prefer it over interpolation.
    position = origin + hit.t[..., None] * direction
    one = torch.ones_like(hit.t)[..., None]
    p = torch.where(covered[..., None], torch.cat([position, one], -1), p)

    if scene.sphere_center.shape[0] > 0:
        is_sphere = (hit.kind == 2)[..., None]
        sprim = hit.prim.clamp(0, scene.sphere_center.shape[0] - 1).to(torch.int64)
        sc = scene.sphere_center[sprim]
        sr = torch.clamp_min(scene.sphere_radius[sprim], 1e-9)[..., None]
        snormal = (position - sc) / sr
        smat = scene.sphere_material[sprim].to(torch.int64)
        uv0 = torch.zeros(hit.t.shape + (2,), dtype=torch.float32, device=hit.t.device)
        sdiff = sample_texture_bilinear(scene.textures, scene.mat_diffuse_map[smat], uv0)
        smr = sample_texture_bilinear(scene.textures, scene.mat_mr_map[smat], uv0)
        n = torch.where(is_sphere, torch.cat([snormal, one], -1), n)
        a = torch.where(is_sphere, torch.cat([sdiff[..., :3], one], -1), a)
        pbr = torch.where(
            is_sphere,
            torch.stack([smr[..., 2], smr[..., 1], torch.ones_like(hit.t),
                         smat.to(torch.float32)], -1),
            pbr,
        )
    if projection_view is not None:
        clip_z = rayops.dot(position, projection_view[2, :3]) + projection_view[2, 3]
        clip_w = rayops.dot(position, projection_view[3, :3]) + projection_view[3, 3]
        depth = torch.where(covered, clip_z / torch.clamp_min(clip_w, 1e-9), 1.0)
    else:
        depth = torch.where(covered, hit.t, 1.0)
    return GBuffer(position=p, normal=n, albedo=a, pbr=pbr, depth=depth)

"""Per-effect pass setup (rebuild of utopian/src/renderers/*.rs; the port of
``rust_renderer_tpu/renderers/passes.py``). Each `setup_*` records one pass
into the Graph; resource names are the reference's (gbuffer_position,
shadow_map, ssao_output, ...). The values the JAX package passes as uniforms
(cascade matrices and splits, SSAO radius and bias, the marching-cubes
colour, the FXAA threshold) are uniforms here too: the bodies read them from
the graph's device buffers (`PassBuilder.uniforms`), and no body copies host
data.

In a row-sharded graph (`Graph.shard_image_rows`) each pass computes this
rank's band (`graph.band`) of the image: per-pixel passes by image
coordinates, SSAO and FXAA with the rows beyond the band's edges gathered
from the other ranks, and the rasterized draws (K5: the gbuffer and forward
raster branches, the marching-cubes draw) over the whole frame on every
rank, keeping their band. The shadow cascades are light space: every rank
renders them whole.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.ops import atmosphere as atmosphere_ops
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.ops import deferred as deferred_ops
from rust_renderer_tpu_torch.ops import fxaa as fxaa_ops
from rust_renderer_tpu_torch.ops import gbuffer as gbuffer_ops
from rust_renderer_tpu_torch.ops import ibl as ibl_ops
from rust_renderer_tpu_torch.ops import marching_cubes as mc_ops
from rust_renderer_tpu_torch.ops import mc_bvh
from rust_renderer_tpu_torch.ops import pbr as pbr_ops
from rust_renderer_tpu_torch.ops import raster as raster_ops
from rust_renderer_tpu_torch.ops import raster_binned
from rust_renderer_tpu_torch.ops import rays as rayops
from rust_renderer_tpu_torch.ops import shadow as shadow_ops
from rust_renderer_tpu_torch.ops import ssao as ssao_ops
from rust_renderer_tpu_torch.ops.colors import linear_to_srgb
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.cubemap import sample_cubemap
from rust_renderer_tpu_torch.ops.raster import VisibilityBuffer
from rust_renderer_tpu_torch.utils.profiler import PROFILER

GBUFFER_PLANES = ("gbuffer_position", "gbuffer_normal", "gbuffer_albedo",
                  "gbuffer_pbr", "gbuffer_depth")


def _camera_rays(view, width: int, height: int, band=None):
    """Pixel-centre rays of the (height, width) image, or of its rows in
    `band`."""
    dev = view.inverse_view.device
    top, rows = (0, height) if band is None else (band.offset, band.rows)
    py = torch.arange(top, top + rows, dtype=torch.float32, device=dev)[:, None] + 0.5
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py, px = py.expand(rows, width), px.expand(rows, width)
    return rayops.generate_camera_rays(view.inverse_view, view.inverse_projection,
                                       px, py, width, height)


def _band_of(vis: VisibilityBuffer, band) -> VisibilityBuffer:
    """A whole-frame visibility buffer's rows in `band` (all of it without)."""
    if band is None:
        return vis
    return VisibilityBuffer(*(t[band.offset:band.offset + band.rows] for t in vis))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _on(flag) -> torch.Tensor:
    return flag == 1


def env_resource_names(cfg) -> list[str]:
    names = []
    for m in range(cfg.cubemap_mips):
        names += [f"env_cubemap_mip{m}", f"specular_map_mip{m}"]
    return names + ["irradiance_map", "brdf_lut"]


def declare_env_resources(graph: Graph, cfg) -> None:
    """The captured environment's persistent resources (ibl.rs:63-66): made
    by `ops/ibl.py::compute_environment` or the environment pass, reused by
    every later frame."""
    for m in range(cfg.cubemap_mips):
        s = max(cfg.cubemap_size >> m, 1)
        graph.create_buffer(f"env_cubemap_mip{m}", (6, s, s, 3), persistent=True)
        graph.create_buffer(f"specular_map_mip{m}", (6, s, s, 3), persistent=True)
    graph.create_buffer("irradiance_map", (6, cfg.irradiance_size, cfg.irradiance_size, 3),
                        persistent=True)
    graph.create_buffer("brdf_lut", (cfg.brdf_lut_size, cfg.brdf_lut_size, 2),
                        persistent=True)


def _ibl_inputs(res, cfg):
    spec = [res[f"specular_map_mip{m}"] for m in range(cfg.cubemap_mips)]
    return res["irradiance_map"], spec, res["brdf_lut"]


def _read_ibl(builder, cfg):
    for m in range(cfg.cubemap_mips):
        builder.read(f"specular_map_mip{m}")
    return builder.read("irradiance_map").read("brdf_lut")


# -- gbuffer (renderers/gbuffer.rs) ------------------------------------------


def _raster_visibility(scene, view, width: int, height: int, method: str):
    """The scene's triangles rasterized into a visibility buffer (K5 on the
    card; on CPU tensors the brute path, or K5's plain version with
    method="binned")."""
    clip = raster_ops.transform_vertices(scene.positions, view.projection @ view.view)
    return raster_ops.rasterize(clip, scene.indices, width, height, method=method)


def setup_gbuffer_pass(graph: Graph, scene_bvh, width: int, height: int,
                       use_raycast: bool = True, dynamic_fn=None, dynamic_reads=(),
                       mc_color=(0.0, 1.0, 0.0, 1.0)) -> None:
    """MRT gbuffer from all scene meshes (gbuffer.rs:32-51). Visibility from
    one closest-hit ray through each pixel centre (K1 on the card), or with
    use_raycast=False from the rasterizer (K5 on the card, the brute path on
    CPU tensors).

    dynamic_fn(res, view) -> ops.mc_bvh.DynamicScene adds per-frame geometry
    (the marching-cubes isosurface) to the primary rays: its tree is walked
    beside the scene's, the nearer hit wins, and dynamic hits fill the planes
    with the MC normals, `mc_color` and the MC material. The pass reads
    `dynamic_reads` (the refit tables)."""
    for name in GBUFFER_PLANES[:4]:
        graph.create_texture(name, width, height, 4, clear=1.0)
    graph.create_texture("gbuffer_depth", width, height, 1, clear=1.0)
    closest = bvh_ops.make_closest_hit(scene_bvh) if use_raycast else None
    band = graph.band

    def render(res, scene, view):
        if not use_raycast:
            vis = _raster_visibility(scene, view, width, height, "auto")
            gb = gbuffer_ops.from_visibility(scene, _band_of(vis, band))
            return dict(zip(GBUFFER_PLANES, gb))
        o, d = _camera_rays(view, width, height, band)
        dyn = None if dynamic_fn is None else dynamic_fn(res, view)
        query = closest if dyn is None else mc_bvh.combine_closest_hit(closest, dyn)
        hit = query(scene, o, d)
        gb = gbuffer_ops.from_rays(scene, hit, o, d,
                                   projection_view=view.projection @ view.view)
        if dyn is not None:
            gb = mc_bvh.patch_gbuffer(dyn, hit, d, gb, mc_color)
        return dict(zip(GBUFFER_PLANES, gb))

    builder = graph.add_pass("gbuffer")
    for name in GBUFFER_PLANES:
        builder.write(name)
    for name in dynamic_reads:
        builder.read(name)
    builder.render(render).build()


# -- shadow cascades (renderers/shadow.rs) -----------------------------------


def _cascade_depth(scene, vp, size: int, method: str):
    """One cascade's depth map: inside the span `shadow/bin` its vertices
    transformed and, on the binned path, its triangles binned; inside
    `shadow/raster` the plan and K4 (or the plain and brute paths on CPU
    tensors). Returns the map and, on the binned path, the binned rows K4
    walks (the tiles' segments and the global list) and the most rows of
    one tile (its segment and the global list), as device scalars; else
    None."""
    dev = vp.device
    with PROFILER.scope("shadow/bin", device=dev):
        clip = raster_ops.transform_vertices(scene.positions, vp)
        bins = (raster_binned.depth_bins(clip, scene.indices, size, size)
                if raster_ops.binned_path(dev, method) else None)
    with PROFILER.scope("shadow/raster", device=dev):
        if bins is None:
            return raster_ops.rasterize_depth(clip, scene.indices, size, size,
                                              method=method), None
        rows = (bins.counts.sum() + bins.g_count, bins.counts.max() + bins.g_count)
        return raster_binned.depth_binned(bins, size, size), rows


def setup_shadow_pass(graph: Graph, camera, sun_dir, enabled: bool, size: int = 1024,
                      cascade_count: int = 4, method: str = "auto"):
    """Cascaded shadow maps (shadow.rs:24-131): cascades fitted on the host,
    then one depth-only raster per cascade (K4 on the card;
    `_cascade_depth`). On the binned path the profiler's counter
    `shadow/rows` takes a frame's binned rows over the cascades and the
    largest tile's. Returns the (matrices, split depths) as numpy."""
    graph.create_buffer("shadow_map", (cascade_count, size, size), clear=1.0)
    matrices, split_depths = shadow_ops.cascade_matrices(
        camera.get_view(), camera.get_projection(), camera.get_near_plane(),
        camera.get_far_plane(), np.asarray(sun_dir, np.float32), cascade_count)

    def render(res, scene, view, u):
        if not enabled:
            return {"shadow_map": torch.ones((cascade_count, size, size),
                                             device=view.view.device)}
        vp = u["cascade_vp"]
        layers, rows = zip(*(_cascade_depth(scene, vp[i], size, method)
                             for i in range(cascade_count)))
        if rows[0] is not None:
            total, peak = (torch.stack(x) for x in zip(*rows))
            PROFILER.count("shadow/rows", total.sum(), peak.max())
        return {"shadow_map": torch.stack(layers)}

    (graph.add_pass("shadow").write("shadow_map")
     .uniforms("cascade_vp", matrices).render(render).build())
    return matrices, split_depths


# -- SSAO (renderers/ssao.rs) -------------------------------------------------


def setup_ssao_pass(graph: Graph, width: int, height: int, radius: float = 0.3,
                    bias: float = 0.025) -> None:
    graph.create_texture("ssao_output", width, height, 1, clear=1.0)
    band = graph.band

    def render(res, scene, view, u):
        return {"ssao_output": ssao_ops.ssao_stencil(
            res["gbuffer_position"], res["gbuffer_normal"], view.view, view.projection,
            u["radius"], u["bias"], band=band, enabled=view.ssao_enabled)}

    (graph.add_pass("ssao").read("gbuffer_position").read("gbuffer_normal")
     .write("ssao_output").uniforms("radius", np.float32(radius))
     .uniforms("bias", np.float32(bias)).render(render).build())


# -- environment / IBL (renderers/ibl.rs) -------------------------------------


def setup_environment_passes(graph: Graph, cfg, sun_dir) -> None:
    """Cubemap capture, irradiance, specular prefilter and BRDF LUT as one
    pass, recorded when the environment needs recomputation (ibl.rs:63-66).
    The application computes it outside the graph instead
    (`Application._ensure_environment`); both give the same resources."""
    declare_env_resources(graph, cfg)

    def render(res, scene, view):
        return ibl_ops.compute_environment(cfg, view.sun_dir, device=view.sun_dir.device)

    builder = graph.add_pass("environment")
    for name in env_resource_names(cfg):
        builder.write(name)
    builder.render(render).build()


# -- raytraced shadows / reflections (rt_shadows.rs, rt_reflections.rs) --------


def setup_rt_shadows_pass(graph: Graph, scene_bvh, cfg, width: int, height: int) -> None:
    """One sun-visibility ray per gbuffer pixel, binary output
    (rt_shadows.rgen): K1 any-hit on the card, after the seed test of
    `cfg.seed_rows` leaf rows, as in the JAX package."""
    graph.create_texture("rt_shadows", width, height, 1, clear=1.0)
    any_hit = bvh_ops.make_any_hit(scene_bvh, seed_rows=cfg.seed_rows)

    def render(res, scene, view):
        pos = res["gbuffer_position"][..., :3]
        origin = rayops.offset_ray(pos, res["gbuffer_normal"][..., :3])
        sun = _unit(view.sun_dir)
        occluded = any_hit(scene, origin, torch.broadcast_to(sun, origin.shape))
        is_sky = (pos == 1.0).all(-1)
        return {"rt_shadows": torch.where(~occluded | is_sky, 1.0, 0.0)}

    (graph.add_pass("rt_shadows").read("gbuffer_position").read("gbuffer_normal")
     .write("rt_shadows").render(render).build())


def setup_rt_reflections_pass(graph: Graph, scene_bvh, cfg, width: int, height: int) -> None:
    """Mirror reflections of metal pixels (rt_reflections.rgen): the eye ray
    reflected once (K1 closest hit on the card); a hit is shaded with IBL, a
    miss sees the atmosphere. Non-metal pixels trace a zero direction, which
    the traversal retires on entry."""
    graph.create_texture("rt_reflections", width, height, 4, clear=0.0)
    closest = bvh_ops.make_closest_hit(scene_bvh)

    def render(res, scene, view):
        pos = res["gbuffer_position"][..., :3]
        normal = res["gbuffer_normal"][..., :3]
        material = res["gbuffer_pbr"][..., 3].to(torch.int64).clamp(
            0, scene.mat_rt_type.shape[0] - 1)
        is_metal = (scene.mat_rt_type[material] == 1)[..., None]
        eye_dir = pos - view.eye_pos
        eye_dir = eye_dir / torch.clamp_min(
            torch.linalg.vector_norm(eye_dir, dim=-1, keepdim=True), 1e-9)
        rdir = torch.where(is_metal, rayops.reflect(eye_dir, normal), 0.0)
        origin = rayops.offset_ray(pos, normal)
        hit = closest(scene, origin, rdir)
        gb = gbuffer_ops.from_rays(scene, hit, origin, rdir)
        pixel = pbr_ops.PixelParams(
            position=gb.position[..., :3], base_color=gb.albedo[..., :3],
            normal=gb.normal[..., :3], metallic=gb.pbr[..., 0],
            roughness=gb.pbr[..., 1], occlusion=gb.pbr[..., 2])
        shaded = pbr_ops.image_based_lighting(pixel, view.eye_pos, *_ibl_inputs(res, cfg))
        sky = atmosphere_ops.sky_radiance(
            origin, torch.where(is_metal, rdir, device_constant((0.0, 1.0, 0.0), rdir.device)),
            _unit(view.sun_dir), view.sky_enabled)
        color = torch.where(hit.is_hit[..., None], shaded, sky)
        color = torch.where(is_metal, color, 0.0)
        return {"rt_reflections": torch.cat([color, torch.ones_like(color[..., :1])], -1)}

    builder = (graph.add_pass("rt_reflections").read("gbuffer_position")
               .read("gbuffer_normal").read("gbuffer_pbr"))
    _read_ibl(builder, cfg).write("rt_reflections").render(render).build()


# -- deferred composite (renderers/deferred.rs + deferred.frag) ----------------


def setup_deferred_pass(graph: Graph, cfg, width: int, height: int,
                        cascade_matrices, cascade_splits) -> None:
    graph.create_texture("deferred_output", width, height, 4, clear=0.0)

    def render(res, scene, view, u):
        irradiance, specular, lut = _ibl_inputs(res, cfg)
        return {"deferred_output": deferred_ops.deferred_composite(
            scene, view, res["gbuffer_position"], res["gbuffer_normal"],
            res["gbuffer_albedo"], res["gbuffer_pbr"], res["rt_reflections"],
            res["rt_shadows"], res["ssao_output"], res["shadow_map"], u["cascade_vp"],
            u["cascade_splits"], irradiance, specular, lut)}

    builder = graph.add_pass("deferred")
    for name in (*GBUFFER_PLANES[:4], "shadow_map", "rt_shadows", "rt_reflections",
                 "ssao_output"):
        builder.read(name)
    (_read_ibl(builder, cfg).write("deferred_output")
     .uniforms("cascade_vp", cascade_matrices).uniforms("cascade_splits", cascade_splits)
     .render(render).build())


# -- atmosphere / sky (renderers/atmosphere.rs) --------------------------------


def setup_atmosphere_pass(graph: Graph, cfg, width: int, height: int,
                          target: str = "deferred_output") -> None:
    """Sky where no geometry was drawn (atmosphere.rs:19-69): the captured
    environment cubemap at LOD 2 when cubemap_enabled, else the live
    scattering integral."""
    mip = min(2, cfg.cubemap_mips - 1)  # LOD 2 (atmosphere.frag)
    env_name = f"env_cubemap_mip{mip}"
    band = graph.band

    def render(res, scene, view):
        o, d = _camera_rays(view, width, height, band)
        live = atmosphere_ops.sky_radiance(o, d, _unit(view.sun_dir), view.sky_enabled)
        cached = torch.where(_on(view.sky_enabled), sample_cubemap(res[env_name], d), 0.0)
        sky = torch.where(_on(view.cubemap_enabled), cached, live)
        is_sky = (res["gbuffer_depth"] >= 1.0)[..., None]
        sky4 = torch.cat([sky, torch.ones_like(sky[..., :1])], -1)
        return {target: torch.where(is_sky, sky4, res[target])}

    (graph.add_pass("atmosphere").read("gbuffer_depth").read(env_name).read(target)
     .write(target).render(render).build())


# -- marching cubes (renderers/marching_cubes.rs) ------------------------------


def setup_marching_cubes_pass(graph: Graph, cfg, width: int, height: int,
                              target: str = "deferred_output", voxel_size: float | None = None,
                              color=(0.0, 1.0, 0.0, 1.0), flat_normals: bool = False) -> None:
    """The isosurface extracted every frame and drawn forward with a depth
    test against the scene (marching_cubes.rs:63-135). The indirect draw is
    every triangle slot rasterized (K5 on the card), degenerate slots
    covering nothing, over the gbuffer depth; lit with the pass color (a
    uniform). voxel_size defaults to 32 / cfg.mc_grid, so that the domain is
    the reference's [0,32]^3 at any mc_grid; flat_normals gives each
    triangle its face normal."""
    graph.create_buffer("marching_cubes_draw_count", (1,), dtype=torch.int32)
    if voxel_size is None:
        voxel_size = 32.0 / cfg.mc_grid
    band = graph.band

    def render(res, scene, view, u):
        dev = view.view.device
        result = mc_ops.marching_cubes(grid=cfg.mc_grid, voxel_size=voxel_size,
                                       time=view.time, flat_normals=flat_normals)
        t = result.positions.shape[0]
        clip = raster_ops.transform_vertices(result.positions.reshape(-1, 3),
                                             view.projection @ view.view)
        idx = torch.arange(t * 3, dtype=torch.int32, device=dev).reshape(-1, 3)
        depth = res["gbuffer_depth"]
        # The draw rasterizes the whole frame over the whole depth plane.
        full_depth = depth if band is None else band.gather(depth)
        init = VisibilityBuffer(
            depth=full_depth,
            tri=torch.full(full_depth.shape, -1, dtype=torch.int32, device=dev),
            bary_u=torch.zeros_like(full_depth), bary_v=torch.zeros_like(full_depth))
        vis = _band_of(raster_ops.rasterize(clip, idx, width, height, init=init,
                                            method=cfg.raster_method), band)
        covered = vis.tri >= 0
        normals = raster_ops.interpolate(vis, idx, result.normals.reshape(-1, 3))
        normals = normals / torch.clamp_min(
            torch.linalg.vector_norm(normals, dim=-1, keepdim=True), 1e-9)
        ndotl = torch.clamp_min(rayops.dot(normals, _unit(view.sun_dir)), 0.0)
        shaded = u["color"][:3] * (0.2 + 0.8 * ndotl[..., None])
        drawn = covered & _on(view.marching_cubes_enabled)
        shaded4 = torch.cat([shaded, torch.ones_like(ndotl)[..., None]], -1)
        return {
            target: torch.where(drawn[..., None], shaded4, res[target]),
            "gbuffer_depth": torch.where(drawn, vis.depth, depth),
            "marching_cubes_draw_count": result.vertex_count[None],
        }

    (graph.add_pass("marching_cubes").read("gbuffer_depth").read(target)
     .write(target).write("gbuffer_depth").write("marching_cubes_draw_count")
     .uniforms("color", np.asarray(color, np.float32)).render(render).build())


# -- present (renderers/present.rs) --------------------------------------------


def setup_present_pass(graph: Graph, width: int, height: int,
                       source: str = "deferred_output", fxaa_threshold: float = 0.45) -> None:
    """Fullscreen composite: FXAA (toggle) over linear -> sRGB (present.frag)."""
    graph.create_texture("present_output", width, height, 3, clear=0.0)
    band = graph.band

    def render(res, scene, view, u):
        color = linear_to_srgb(torch.clamp_min(res[source][..., :3], 0.0))
        return {"present_output": fxaa_ops.fxaa(color, u["threshold"], view.fxaa_enabled,
                                                view.fxaa_debug, band=band)}

    (graph.add_pass("present").read(source).write("present_output")
     .uniforms("threshold", np.float32(fxaa_threshold)).render(render).build())


# -- forward (renderers/forward.rs, minimal mode) ------------------------------


def setup_forward_pass(graph: Graph, cfg, width: int, height: int, cascade_matrices,
                       cascade_splits, scene_bvh=None) -> None:
    """Forward PBR + CSM (forward.vert/.frag). Visibility from the
    rasterizer by cfg.raster_method (K5 on the card), or from one closest
    hit per pixel centre (K1 on the card) when `scene_bvh` is given: the
    same image."""
    graph.create_texture("forward_output", width, height, 4, clear=0.0)
    graph.create_texture("gbuffer_depth", width, height, 1, clear=1.0)
    closest = None if scene_bvh is None else bvh_ops.make_closest_hit(scene_bvh)
    band = graph.band

    def render(res, scene, view, u):
        if closest is None:
            vis = _band_of(_raster_visibility(scene, view, width, height, cfg.raster_method),
                           band)
            gb = gbuffer_ops.from_visibility(scene, vis)
            covered = vis.tri >= 0
        else:
            o, d = _camera_rays(view, width, height, band)
            hit = closest(scene, o, d)
            gb = gbuffer_ops.from_rays(scene, hit, o, d,
                                       projection_view=view.projection @ view.view)
            covered = hit.is_hit
        pixel = pbr_ops.material_pixel(scene, gb.position[..., :3], gb.normal[..., :3],
                                       gb.albedo[..., :3], gb.pbr)
        lo = pbr_ops.shade_all_lights(pixel, scene, view)
        color = 0.03 * pixel.base_color * pixel.occlusion[..., None] + lo
        csm, _ = shadow_ops.calculate_shadow(
            gb.position[..., :3], view.view, res["shadow_map"], u["cascade_vp"],
            u["cascade_splits"])
        color = color * torch.where(_on(view.shadows_enabled), csm, 1.0)[..., None]
        color = torch.where(covered[..., None], color, 0.0)
        return {"forward_output": torch.cat([color, torch.ones_like(color[..., :1])], -1),
                "gbuffer_depth": gb.depth}

    (graph.add_pass("forward").read("shadow_map").write("forward_output")
     .write("gbuffer_depth").uniforms("cascade_vp", cascade_matrices)
     .uniforms("cascade_splits", cascade_splits).render(render).build())

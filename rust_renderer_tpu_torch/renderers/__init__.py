"""Render-graph construction (rebuild of utopian/src/renderers/mod.rs).

- PATH_TRACED: [mc_extract -> mc_refit] -> gbuffer -> reset_reservoirs ->
  initial_ris -> temporal_reuse -> spatial_reuse -> reference_pt -> present
  blit (mod.rs:189-375).
- RASTERIZED: shadow -> gbuffer -> rt_shadows -> rt_reflections -> ssao ->
  deferred -> [marching_cubes] -> atmosphere -> present (mod.rs:61-187).
- HYBRID: an empty graph, like the reference (mod.rs:377-391).
- MINIMAL: shadow -> forward -> present (mod.rs:393-433).

The builders run every frame over the graph's cached resources, and take
the JAX package's arguments in its order. The captured environment
(cubemaps, irradiance, LUT) is a persistent resource: with
`need_environment_update` the graph records the environment pass that
makes it; else it is only declared, and `Application._ensure_environment`
fills it when it is stale.
"""

from __future__ import annotations

import torch
import torch.distributed

from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.ops import marching_cubes as mc_ops
from rust_renderer_tpu_torch.ops import mc_bvh
from rust_renderer_tpu_torch.ops import pathtrace as pathtrace_ops
from rust_renderer_tpu_torch.ops import restir as restir_ops
from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.ops.cubemap import sample_cubemap
from rust_renderer_tpu_torch.renderers.passes import (
    declare_env_resources,
    setup_atmosphere_pass,
    setup_deferred_pass,
    setup_forward_pass,
    setup_gbuffer_pass,
    setup_marching_cubes_pass,
    setup_present_pass,
    setup_environment_passes,
    setup_rt_reflections_pass,
    setup_rt_shadows_pass,
    setup_shadow_pass,
    setup_ssao_pass,
)

__all__ = [
    "build_render_graph",
    "build_path_tracing_render_graph",
    "build_hybrid_render_graph",
    "build_minimal_forward_render_graph",
]


def _environment(graph: Graph, cfg, sun_dir, need_environment_update: bool) -> None:
    """The environment pass where it must be recomputed this frame, else its
    persistent resources declared so that reads resolve (ibl.rs:63-66)."""
    if need_environment_update:
        setup_environment_passes(graph, cfg, sun_dir)
    else:
        declare_env_resources(graph, cfg)


def build_render_graph(graph: Graph, cfg, camera, scene_bvh, sun_dir,
                       need_environment_update: bool = False,
                       shadows_enabled: bool = True,
                       shadow_map_size: int | None = None,
                       marching_cubes_enabled: bool = False,
                       raytracing_supported: bool = True) -> None:
    """The rasterized graph (mod.rs:61-187). Visibility comes from BVH
    primary rays; the shadow cascades (K4) and the marching-cubes draw (K5)
    are rasterized. The cascades are `shadow_map_size` square, else
    cfg.shadow_map_size. raytracing_supported=False leaves the RT passes out
    (device.rs:93-103): shading falls back to CSM and IBL-only reflections."""
    w, h = cfg.width, cfg.height
    matrices, splits = setup_shadow_pass(graph, camera, sun_dir, shadows_enabled,
                                         shadow_map_size or cfg.shadow_map_size,
                                         cfg.shadow_cascade_count, cfg.raster_method)
    setup_gbuffer_pass(graph, scene_bvh, w, h)
    _environment(graph, cfg, sun_dir, need_environment_update)
    if raytracing_supported:
        setup_rt_shadows_pass(graph, scene_bvh, cfg, w, h)
        setup_rt_reflections_pass(graph, scene_bvh, cfg, w, h)
    else:
        # Read by the deferred pass, masked by view.raytracing_supported == 0.
        graph.create_texture("rt_shadows", w, h, 1, clear=1.0)
        graph.create_texture("rt_reflections", w, h, 4, clear=0.0)
    setup_ssao_pass(graph, w, h)
    setup_deferred_pass(graph, cfg, w, h, matrices, splits)
    if marching_cubes_enabled:  # recorded on demand, like mod.rs:164-176
        setup_marching_cubes_pass(graph, cfg, w, h, target="deferred_output")
    setup_atmosphere_pass(graph, cfg, w, h, target="deferred_output")
    setup_present_pass(graph, w, h, source="deferred_output")


def build_hybrid_render_graph(graph: Graph, *args, **kwargs) -> None:
    """Empty, like the reference (mod.rs:377-391)."""


def build_minimal_forward_render_graph(graph: Graph, cfg, camera, scene_bvh, sun_dir,
                                       shadows_enabled: bool = True,
                                       shadow_map_size: int | None = None) -> None:
    """Minimal forward graph (mod.rs:393-433): shadow -> forward -> present;
    no atmosphere pass, the sky stays at the clear color."""
    w, h = cfg.width, cfg.height
    matrices, splits = setup_shadow_pass(graph, camera, sun_dir, shadows_enabled,
                                         shadow_map_size or cfg.shadow_map_size,
                                         cfg.shadow_cascade_count, cfg.raster_method)
    setup_forward_pass(graph, cfg, w, h, matrices, splits, scene_bvh)
    setup_present_pass(graph, w, h, source="forward_output")

_RES_FIELDS = ("Y", "W_sum", "W_X", "M")


def _reservoir_names(name: str) -> list[str]:
    return [f"{name}_{f}" for f in _RES_FIELDS]


def _read_reservoir(res, name: str) -> restir_ops.Reservoir:
    """Reservoir planes are stored as float32 (-1 = empty Y)."""
    return restir_ops.Reservoir(
        Y=res[f"{name}_Y"].to(torch.int32),
        W_sum=res[f"{name}_W_sum"],
        W_X=res[f"{name}_W_X"],
        M=res[f"{name}_M"].to(torch.int32),
    )


def _write_reservoir(name: str, r: restir_ops.Reservoir) -> dict:
    return {
        f"{name}_Y": r.Y.to(torch.float32),
        f"{name}_W_sum": r.W_sum,
        f"{name}_W_X": r.W_X,
        f"{name}_M": r.M.to(torch.float32),
    }


def _declare_reservoir(graph: Graph, name: str, w: int, h: int,
                       persistent: bool = False) -> None:
    """W*H planes per field (the reference's W*H*16B SSBOs, mod.rs:222-244)."""
    for f in _RES_FIELDS:
        graph.create_buffer(f"{name}_{f}", (h, w), clear=-1.0 if f == "Y" else 0.0,
                            persistent=persistent, image=True)


def _rng_for(view, h: int, w: int, row_offset: int = 0) -> torch.Tensor:
    """The per-pixel RNG states of the (h, w) rows at image row
    `row_offset` of a w-wide image."""
    py, px = pathtrace_ops.pixel_grid(h, w, view.time.device, row_offset)
    return rngmod.init_rng(px, py, w, pathtrace_ops.frame_seed(view))


def build_path_tracing_render_graph(graph: Graph, cfg, camera, scene_bvh, sun_dir,
                                    need_environment_update: bool = False,
                                    marching_cubes_enabled: bool = False,
                                    mc_material: int = 0,
                                    mc_color=(0.0, 1.0, 0.0, 1.0),
                                    num_lights: int | None = None) -> None:
    """PT graph with the ReSTIR chain (mod.rs:189-375).

    cfg.sky_mode: "exact" integrates the atmosphere per miss ray;
    "cubemap" samples the captured environment cubemap's mip 0.
    marching_cubes_enabled adds the animated isosurface to the traced scene
    (bench config 5), the analog of the reference's per-frame TLAS rebuild
    (marching_cubes.rs:63-135, raytracing.rs:400-459): two isolated passes
    at the head of the graph extract the surface (`mc_extract`) and refit
    its tree (`mc_refit`, ``ops/mc_bvh.py``) into four table resources;
    the gbuffer and reference_pt passes read them and walk that tree beside
    the scene's. The refit reads view.marching_cubes_enabled on the device,
    so turning it off at run time empties the tree. The surface takes
    material `mc_material` (`Renderer.ensure_mc_material`), and the gbuffer
    `mc_color`.
    num_lights: the scene's light count when known. With ZERO lights the
    direct-lighting chain (gbuffer + reset/initial-RIS/temporal/spatial)
    selects nothing, so the graph is built without it (the same output).
    need_environment_update records the environment pass in a cubemap-sky
    graph (`build_render_graph`).
    In a row-sharded graph (`Graph.shard_image_rows`) every pass computes
    this rank's band as `parallel/flagship.py` does: temporal reuse reads
    the previous frame's spatial planes and spatial reuse the temporal
    planes gathered to full height, and pt_rays is summed over the ranks.
    """
    if cfg.sky_mode not in ("exact", "cubemap"):
        raise ValueError(f"unknown sky_mode {cfg.sky_mode!r}")
    w, h = cfg.width, cfg.height
    band = graph.band
    rows, top = (h, 0) if band is None else (band.rows, band.offset)

    def gathered(r: restir_ops.Reservoir) -> restir_ops.Reservoir:
        return r if band is None else restir_ops.Reservoir(*(band.gather(p) for p in r))
    skip_restir = num_lights == 0
    use_cubemap_sky = cfg.sky_mode == "cubemap"
    if use_cubemap_sky:
        _environment(graph, cfg, sun_dir, need_environment_update)

    dynamic_fn = None
    mc_reads: tuple[str, ...] = ()
    if marching_cubes_enabled:
        grid = cfg.mc_grid
        v5 = grid ** 3 * mc_ops.MAX_TRIS_PER_VOXEL
        graph.create_buffer("mc_positions", (v5, 3, 3))
        graph.create_buffer("mc_normals", (v5, 3, 3))
        graph.create_buffer("mc_valid", (v5,), dtype=torch.int32)
        graph.create_buffer("marching_cubes_draw_count", (1,), dtype=torch.int32)
        shapes = mc_bvh.table_shapes(grid)
        mc_reads = tuple(shapes)
        for name, shape in shapes.items():
            # The tree tables hold bit-cast int32 ids and child refs in float
            # columns (-1 and leaf refs are NaN bit patterns): exempt from
            # the sanitizer, as in the JAX package.
            graph.create_buffer(name, shape, sanitize=name == "mc_tri_normals")

        def mc_extract(res, scene, view):
            # The fixed [0,32]^3 world domain (the reference's feature
            # region) at any tessellation.
            result = mc_ops.marching_cubes(grid=grid, voxel_size=32.0 / grid, time=view.time)
            return {"mc_positions": result.positions, "mc_normals": result.normals,
                    "mc_valid": result.valid.to(torch.int32),
                    "marching_cubes_draw_count": result.vertex_count[None]}

        (graph.add_pass("mc_extract").write("mc_positions").write("mc_normals")
         .write("mc_valid").write("marching_cubes_draw_count").render(mc_extract)
         .isolate().build())

        def mc_refit(res, scene, view):
            # The run-time toggle empties the tree without a change of the
            # graph, like the reference's uniform flag.
            result = mc_ops.MarchingCubesResult(
                positions=res["mc_positions"], normals=res["mc_normals"],
                valid=(res["mc_valid"] > 0) & (view.marching_cubes_enabled == 1),
                vertex_count=None)
            return mc_bvh.build_dynamic_tables(result, grid)

        builder = (graph.add_pass("mc_refit").read("mc_positions").read("mc_normals")
                   .read("mc_valid").render(mc_refit).isolate())
        for name in mc_reads:
            builder.write(name)
        builder.build()

        def dynamic_fn(res, view):
            return mc_bvh.dynamic_scene_from_tables({k: res[k] for k in mc_reads}, grid,
                                                    mc_material)

    graph.create_texture("accumulation_image", w, h, 3, persistent=True)
    graph.create_texture("pt_output", w, h, 3)
    # Active-ray count; persistent so the host can read it from Graph.state.
    graph.create_buffer("pt_rays", (), persistent=True)

    if not skip_restir:
        # 1. gbuffer (hit positions for the ReSTIR passes, mod.rs:246-254).
        setup_gbuffer_pass(graph, scene_bvh, w, h, dynamic_fn=dynamic_fn,
                           dynamic_reads=mc_reads, mc_color=mc_color)

        # The spatial output is persistent: the next frame's temporal pass
        # reads it as the previous frame's reservoirs (mod.rs:294).
        _declare_reservoir(graph, "initial_ris_reservoirs", w, h)
        _declare_reservoir(graph, "temporal_reuse_reservoirs", w, h)
        _declare_reservoir(graph, "spatial_reuse_reservoirs", w, h, persistent=True)

        # 2. reset_reservoirs (restir/reset_reservoirs.comp).
        def reset(res, scene, view):
            empty = restir_ops.Reservoir.empty((rows, w), device=view.time.device)
            out = _write_reservoir("initial_ris_reservoirs", empty)
            out.update(_write_reservoir("temporal_reuse_reservoirs", empty))
            return out

        rb = graph.add_pass("reset_reservoirs")
        for name in (_reservoir_names("initial_ris_reservoirs")
                     + _reservoir_names("temporal_reuse_reservoirs")):
            rb.write(name)
        rb.render(reset).build()

        # p_hat of each pass's selected sample rides along to the next pass.
        graph.create_buffer("initial_ris_p_hat", (h, w), image=True)
        graph.create_buffer("temporal_reuse_p_hat", (h, w), image=True)

        # 3. initial RIS (restir/initial_ris.rgen).
        def initial_ris(res, scene, view):
            state = _rng_for(view, rows, w, top)
            hit_pos = res["gbuffer_position"][..., :3]
            state, r, p_hat = restir_ops.initial_ris_pass(
                scene, state, hit_pos, view.num_lights, view.max_num_lights_used,
                cfg.ris_candidates, return_p_hat=True)
            out = _write_reservoir("initial_ris_reservoirs", r)
            out["initial_ris_p_hat"] = p_hat
            return out

        pb = graph.add_pass("initial_ris").read("gbuffer_position")
        for name in _reservoir_names("initial_ris_reservoirs") + ["initial_ris_p_hat"]:
            pb.write(name)
        pb.render(initial_ris).build()

        # 4. temporal reuse (restir/temporal_reuse.rgen).
        def temporal(res, scene, view):
            state = (_rng_for(view, rows, w, top) * 9781 + 1) & rngmod.MASK32
            state, out, p_hat = restir_ops.temporal_reuse_pass(
                scene, state, res["gbuffer_position"][..., :3],
                _read_reservoir(res, "initial_ris_reservoirs"),
                gathered(_read_reservoir(res, "spatial_reuse_reservoirs")),
                view.prev_frame_projection_view, view.temporal_reuse_enabled,
                full_height=h, p_hat_initial=res["initial_ris_p_hat"], return_p_hat=True)
            writes = _write_reservoir("temporal_reuse_reservoirs", out)
            writes["temporal_reuse_p_hat"] = p_hat
            return writes

        pb = graph.add_pass("temporal_reuse").read("gbuffer_position").read(
            "initial_ris_p_hat")
        for name in (_reservoir_names("initial_ris_reservoirs")
                     + _reservoir_names("spatial_reuse_reservoirs")):
            pb.read(name)
        for name in _reservoir_names("temporal_reuse_reservoirs") + ["temporal_reuse_p_hat"]:
            pb.write(name)
        pb.render(temporal).build()

        # 5. spatial reuse (restir/spatial_reuse.rgen).
        def spatial(res, scene, view):
            state = (_rng_for(view, rows, w, top) * 6271 + 1) & rngmod.MASK32
            temporal = _read_reservoir(res, "temporal_reuse_reservoirs")
            state, out = restir_ops.spatial_reuse_pass(
                scene, state, res["gbuffer_position"][..., :3], temporal,
                view.spatial_reuse_enabled, cfg.spatial_neighbors, cfg.spatial_radius,
                temporal_full=None if band is None else gathered(temporal),
                row_offset=top, p_hat_temporal=res["temporal_reuse_p_hat"])
            return _write_reservoir("spatial_reuse_reservoirs", out)

        pb = graph.add_pass("spatial_reuse").read("gbuffer_position").read(
            "temporal_reuse_p_hat")
        for name in _reservoir_names("temporal_reuse_reservoirs"):
            pb.read(name)
        for name in _reservoir_names("spatial_reuse_reservoirs"):
            pb.write(name)
        pb.render(spatial).build()

    # 6. reference PT with reservoir NEE (mod.rs:345-358, reference.rgen),
    # its hit queries within compaction windows and the any-hit query seeded,
    # as the StaticConfig sets them.
    closest = bvh_ops.make_closest_hit(scene_bvh, compact_window=cfg.compact_window,
                                       compact_order=cfg.compact_order)
    any_hit = bvh_ops.make_any_hit(
        scene_bvh, compact_window=cfg.compact_window_any, compact_order=cfg.compact_order,
        seed_rows=cfg.seed_rows)

    def reference_pt(res, scene, view):
        reservoirs = (None if skip_restir
                      else _read_reservoir(res, "spatial_reuse_reservoirs"))
        sky_fn = None
        if use_cubemap_sky:
            env = res["env_cubemap_mip0"]

            def sky_fn(origin, direction, view):
                return torch.where(view.sky_enabled == 1, sample_cubemap(env, direction), 0.0)

        result = pathtrace_ops.path_trace(
            scene, view, cfg, res["accumulation_image"], reservoirs=reservoirs,
            closest_hit=closest, any_hit=any_hit, row_offset=top, full_size=(h, w),
            sky_fn=sky_fn, dynamic=None if dynamic_fn is None else dynamic_fn(res, view))
        rays = result.rays_traced
        if band is not None:
            rays = rays.clone()
            torch.distributed.all_reduce(rays, group=band.group)
        return {
            "pt_output": result.output,
            "accumulation_image": result.accumulation,
            "pt_rays": rays,
        }

    pb = graph.add_pass("reference_pt").read("accumulation_image")
    if use_cubemap_sky:
        pb.read("env_cubemap_mip0")
    if not skip_restir:
        for name in _reservoir_names("spatial_reuse_reservoirs"):
            pb.read(name)
    for name in mc_reads:
        pb.read(name)
    pb.write("pt_output").write("accumulation_image").write("pt_rays")
    if cfg.split_pt_program:
        # Isolated as in the JAX package (its own XLA program there); after
        # the ReSTIR passes, or reading the carried accumulation, it keeps
        # the graph off the device loop (Graph.device_loop_unsupported_reason).
        pb.isolate()
    pb.render(reference_pt).build()

    # 7. present blit (mod.rs:360-374; the PT output is already sRGB).
    graph.create_texture("present_output", w, h, 3)

    def blit(res, scene, view):
        return {"present_output": res["pt_output"]}

    graph.add_pass("reference_pt_present").read("pt_output").write(
        "present_output").render(blit).build()

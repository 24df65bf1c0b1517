"""Render-graph construction (rebuild of utopian/src/renderers/mod.rs): the
path-traced graph.

PATH_TRACED: gbuffer -> reset_reservoirs -> initial_ris -> temporal_reuse ->
spatial_reuse -> reference_pt -> present blit (mod.rs:189-375). The builder
runs every frame over the graph's cached resources.
"""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.ops import pathtrace as pathtrace_ops
from rust_renderer_tpu_torch.ops import restir as restir_ops
from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.renderers.passes import setup_gbuffer_pass

__all__ = ["build_path_tracing_render_graph"]

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
                            persistent=persistent)


def _rng_for(view, h: int, w: int) -> torch.Tensor:
    py, px = pathtrace_ops.pixel_grid(h, w, view.time.device)
    return rngmod.init_rng(px, py, w, pathtrace_ops.frame_seed(view))


def build_path_tracing_render_graph(graph: Graph, cfg, camera, scene_bvh, sun_dir,
                                    num_lights: int | None = None) -> None:
    """PT graph with the ReSTIR chain (mod.rs:189-375), exact-sky.

    num_lights: the scene's light count when known. With ZERO lights the
    direct-lighting chain (gbuffer + reset/initial-RIS/temporal/spatial)
    selects nothing, so the graph is built without it (the same output).
    """
    if cfg.sky_mode != "exact":
        raise NotImplementedError(
            f"sky_mode={cfg.sky_mode!r}: only the exact atmosphere sky is ported")
    w, h = cfg.width, cfg.height
    skip_restir = num_lights == 0

    graph.create_texture("accumulation_image", w, h, 3, persistent=True)
    graph.create_texture("pt_output", w, h, 3)
    # Active-ray count; persistent so the host can read it from Graph.state.
    graph.create_buffer("pt_rays", (), persistent=True)

    if not skip_restir:
        # 1. gbuffer (hit positions for the ReSTIR passes, mod.rs:246-254).
        setup_gbuffer_pass(graph, scene_bvh, w, h)

        # The spatial output is persistent: the next frame's temporal pass
        # reads it as the previous frame's reservoirs (mod.rs:294).
        _declare_reservoir(graph, "initial_ris_reservoirs", w, h)
        _declare_reservoir(graph, "temporal_reuse_reservoirs", w, h)
        _declare_reservoir(graph, "spatial_reuse_reservoirs", w, h, persistent=True)

        # 2. reset_reservoirs (restir/reset_reservoirs.comp).
        def reset(res, scene, view):
            empty = restir_ops.Reservoir.empty((h, w), view.time.device)
            out = _write_reservoir("initial_ris_reservoirs", empty)
            out.update(_write_reservoir("temporal_reuse_reservoirs", empty))
            return out

        rb = graph.add_pass("reset_reservoirs")
        for name in (_reservoir_names("initial_ris_reservoirs")
                     + _reservoir_names("temporal_reuse_reservoirs")):
            rb.write(name)
        rb.render(reset).build()

        # p_hat of each pass's selected sample rides along to the next pass.
        graph.create_buffer("initial_ris_p_hat", (h, w))
        graph.create_buffer("temporal_reuse_p_hat", (h, w))

        # 3. initial RIS (restir/initial_ris.rgen).
        def initial_ris(res, scene, view):
            state = _rng_for(view, h, w)
            hit_pos = res["gbuffer_position"][..., :3]
            state, r, p_hat = restir_ops.initial_ris_pass(
                scene, state, hit_pos, view.num_lights, view.max_num_lights_used,
                cfg.ris_candidates)
            out = _write_reservoir("initial_ris_reservoirs", r)
            out["initial_ris_p_hat"] = p_hat
            return out

        pb = graph.add_pass("initial_ris").read("gbuffer_position")
        for name in _reservoir_names("initial_ris_reservoirs") + ["initial_ris_p_hat"]:
            pb.write(name)
        pb.render(initial_ris).build()

        # 4. temporal reuse (restir/temporal_reuse.rgen).
        def temporal(res, scene, view):
            state = (_rng_for(view, h, w) * 9781 + 1) & rngmod.MASK32
            state, out, p_hat = restir_ops.temporal_reuse_pass(
                scene, state, res["gbuffer_position"][..., :3],
                _read_reservoir(res, "initial_ris_reservoirs"),
                _read_reservoir(res, "spatial_reuse_reservoirs"),
                view.prev_frame_projection_view, view.temporal_reuse_enabled,
                res["initial_ris_p_hat"])
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
            state = (_rng_for(view, h, w) * 6271 + 1) & rngmod.MASK32
            state, out = restir_ops.spatial_reuse_pass(
                scene, state, res["gbuffer_position"][..., :3],
                _read_reservoir(res, "temporal_reuse_reservoirs"),
                view.spatial_reuse_enabled, cfg.spatial_neighbors,
                cfg.spatial_radius, p_hat_temporal=res["temporal_reuse_p_hat"])
            return _write_reservoir("spatial_reuse_reservoirs", out)

        pb = graph.add_pass("spatial_reuse").read("gbuffer_position").read(
            "temporal_reuse_p_hat")
        for name in _reservoir_names("temporal_reuse_reservoirs"):
            pb.read(name)
        for name in _reservoir_names("spatial_reuse_reservoirs"):
            pb.write(name)
        pb.render(spatial).build()

    # 6. reference PT with reservoir NEE (mod.rs:345-358, reference.rgen).
    closest = bvh_ops.make_closest_hit(scene_bvh)
    any_hit = bvh_ops.make_any_hit(scene_bvh)

    def reference_pt(res, scene, view):
        reservoirs = (None if skip_restir
                      else _read_reservoir(res, "spatial_reuse_reservoirs"))
        result = pathtrace_ops.path_trace(
            scene, view, cfg, res["accumulation_image"], reservoirs=reservoirs,
            closest_hit=closest, any_hit=any_hit)
        return {
            "pt_output": result.output,
            "accumulation_image": result.accumulation,
            "pt_rays": result.rays_traced,
        }

    pb = graph.add_pass("reference_pt").read("accumulation_image")
    if not skip_restir:
        for name in _reservoir_names("spatial_reuse_reservoirs"):
            pb.read(name)
    pb.write("pt_output").write("accumulation_image").write("pt_rays")
    pb.render(reference_pt).build()

    # 7. present blit (mod.rs:360-374; the PT output is already sRGB).
    graph.create_texture("present_output", w, h, 3)

    def blit(res, scene, view):
        return {"present_output": res["pt_output"]}

    graph.add_pass("reference_pt_present").read("pt_output").write(
        "present_output").render(blit).build()

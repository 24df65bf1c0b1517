"""Per-effect pass setup (rebuild of utopian/src/renderers/*.rs): the
primary-ray gbuffer pass of the path-traced graph."""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.ops import gbuffer as gbuffer_ops
from rust_renderer_tpu_torch.ops import rays as rayops

GBUFFER_PLANES = ("gbuffer_position", "gbuffer_normal", "gbuffer_albedo",
                  "gbuffer_pbr", "gbuffer_depth")


def setup_gbuffer_pass(graph: Graph, scene_bvh, width: int, height: int) -> None:
    """MRT gbuffer from all scene meshes (gbuffer.rs:32-51), visibility from
    one closest-hit ray through each pixel center."""
    for name in GBUFFER_PLANES[:4]:
        graph.create_texture(name, width, height, 4, clear=1.0)
    graph.create_texture("gbuffer_depth", width, height, 1, clear=1.0)
    closest = bvh_ops.make_closest_hit(scene_bvh)

    def render(res, scene, view):
        dev = view.inverse_view.device
        py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
        px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
        py, px = py.expand(height, width), px.expand(height, width)
        o, d = rayops.generate_camera_rays(
            view.inverse_view, view.inverse_projection, px, py, width, height)
        hit = closest(scene, o, d)
        gb = gbuffer_ops.from_rays(scene, hit, o, d,
                                   projection_view=view.projection @ view.view)
        return dict(zip(GBUFFER_PLANES, gb))

    builder = graph.add_pass("gbuffer")
    for name in GBUFFER_PLANES:
        builder.write(name)
    builder.render(render).build()

"""The three graph builders of ``renderers/__init__.py`` called by position
with the JAX package's arguments: `build_path_tracing_render_graph`
(need_environment_update, marching_cubes_enabled, mc_material, mc_color,
num_lights), `build_render_graph` (need_environment_update,
shadows_enabled, shadow_map_size, marching_cubes_enabled,
raytracing_supported) and `build_minimal_forward_render_graph`
(shadows_enabled, shadow_map_size). need_environment_update=True records
the environment pass in the graph; shadow_map_size sizes the cascades.
Each frame (32x32, the clock pinned, the JAX BVH built with leaf_size=12)
must agree with the JAX package's: at least 99% of pixels within 1e-3 and a
mean absolute difference of at most 1e-3, for the presented image, the
cascades and the captured environment.
"""

import numpy as np
import pytest
import torch

import rust_renderer_tpu as jax_rt
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.renderers import (
    build_minimal_forward_render_graph as jax_build_minimal,
    build_path_tracing_render_graph as jax_build_pt,
    build_render_graph as jax_build_raster,
)
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig
from rust_renderer_tpu.utils import math3d as jax_math3d

import rust_renderer_tpu_torch as torch_rt
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.renderers import (
    build_minimal_forward_render_graph,
    build_path_tracing_render_graph,
    build_render_graph,
)
from rust_renderer_tpu_torch.scene import ModelLoader
from rust_renderer_tpu_torch.settings import RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import math3d
from test_torch_app import CLOCK, SMALL, W, H, _close, _tiny_scene
from test_torch_host import ensure_jax_native_sah

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def _builder_frame(package, mode):
    """One frame of `mode`'s graph, its builder called with the JAX
    package's positional arguments (need_environment_update=True, so the
    environment pass is recorded in the graph), from the tiny scene."""
    jax = package == "jax"
    rt = jax_rt if jax else torch_rt
    cfg = (JaxStaticConfig if jax else StaticConfig)(
        width=W, height=H, sky_mode="cubemap", **SMALL)
    renderer = rt.Renderer()
    cam = rt.Camera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], fov_degrees=60.0,
                    aspect_ratio=1.0, z_near=0.01, z_far=1000.0, speed=0.2)
    if jax:
        _tiny_scene(JaxModelLoader, jax_math3d)(renderer, cam)
        scene = renderer.pack()
        bvh = jax_bvh.build_scene_bvh(scene, leaf_size=12)
        graph, settings = jax_rt.Graph(), JaxRenderSettings
    else:
        _tiny_scene(ModelLoader, math3d)(renderer, cam)
        scene = renderer.pack(device="cpu")
        bvh = torch_bvh.build_scene_bvh(scene)
        graph, settings = torch_rt.Graph(device="cpu"), RenderSettings
    sun = np.array([0.0, 0.90631, 0.42262], np.float32)
    view = settings.default(sun_dir=sun).with_camera(cam, W, H).replace(
        total_samples=np.uint32(1), time=np.float32(CLOCK),
        num_lights=np.int32(renderer.get_num_lights()))
    build = {"pt": jax_build_pt if jax else build_path_tracing_render_graph,
             "raster": jax_build_raster if jax else build_render_graph,
             "minimal": jax_build_minimal if jax else build_minimal_forward_render_graph}[mode]
    if mode == "pt":  # need_environment_update, marching_cubes_enabled, mc_material,
        # mc_color, num_lights
        build(graph, cfg, cam, bvh, sun, True, False, 0, (0.0, 1.0, 0.0, 1.0), 2)
    elif mode == "raster":  # need_environment_update, shadows_enabled, shadow_map_size,
        # marching_cubes_enabled, raytracing_supported
        build(graph, cfg, cam, bvh, sun, True, True, 32, False, True)
    else:  # shadows_enabled, shadow_map_size
        build(graph, cfg, cam, bvh, sun, True, 32)
    names = [p.name for p in graph.passes]
    res = graph.render(scene, view)
    return names, {k: np.asarray(v) for k, v in res.items()
                   if k in ("present_output", "shadow_map", "env_cubemap_mip0")}


@pytest.mark.parametrize("mode", ["pt", "raster", "minimal"])
def test_builders_take_jax_positional_arguments(mode, jax_sah):
    jax_names, want = _builder_frame("jax", mode)
    names, got = _builder_frame("torch", mode)
    assert ("environment" in names) == (mode != "minimal")
    assert set(got) == set(want)
    if "shadow_map" in got:
        assert got["shadow_map"].shape == (4, 32, 32)  # shadow_map_size, not cfg's 64
    for name in got:
        assert got[name].shape == want[name].shape, name
        _close(got[name], want[name])
    assert got["present_output"].std() > 0.01

"""The rasterizer's visibility branches of the port's passes against the JAX
package's: `setup_gbuffer_pass(use_raycast=False)` and the MINIMAL graph
with `setup_forward_pass(scene_bvh=None)`, both rasterizing the scene (the
brute path on CPU tensors, K5 on the card) and shading the visibility
buffer with `gbuffer.from_visibility`.

Both packages render tests/test_render_loop.py's small scene (two cubes on
a floor, two lights) at 64x64 with the same view and 64^2 shadow cascades.
Tolerance: the gbuffer planes, the forward colour and the depth to 1e-5
(the two rasterizers compute the same edge functions and cover the same
pixels; the interpolated positions differ in the last ulps); the presented
image at the slice tolerance, at least 99% of pixels within 1e-3 and a mean
absolute difference of at most 1e-3, since FXAA's edge decisions can
amplify an ulp on a few pixels.
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.graph import Graph as JaxGraph
from rust_renderer_tpu.ops import raster as jax_raster
from rust_renderer_tpu.ops import raster_binned as jax_raster_binned
from rust_renderer_tpu.renderers import build_minimal_forward_render_graph as jax_minimal
from rust_renderer_tpu.renderers.passes import setup_gbuffer_pass as jax_gbuffer_pass
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig
from rust_renderer_tpu.utils import math3d as jax_math3d

from rust_renderer_tpu_torch import Camera
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.convert import packed_scene_from_numpy, view_from_numpy
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.ops import raster
from rust_renderer_tpu_torch.renderers import build_minimal_forward_render_graph
from rust_renderer_tpu_torch.renderers.passes import setup_gbuffer_pass
from rust_renderer_tpu_torch.settings import StaticConfig

torch.set_num_threads(1)

SIZE = 64
SUN = np.array([0.0, 0.90631, 0.42262], np.float32)
EYE, TARGET = [3.0, 2.0, 5.0], [0.0, 0.5, 0.0]
SMALL = dict(width=SIZE, height=SIZE, shadow_map_size=64)


@pytest.fixture(scope="module")
def inputs():
    r = JaxRenderer()
    r.add_model(JaxModelLoader.load_cube(), jax_math3d.translation([0, 0.5, 0]))
    r.add_model(JaxModelLoader.load_cube(), jax_math3d.scale([20.0, 0.1, 20.0]))
    r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
    r.add_light([-2.0, 2.0, -1.0], [1.0, 0.5, 0.2], 0.7)
    scene = r.pack()
    cam = JaxCamera(EYE, TARGET, aspect_ratio=1.0, z_near=0.01, z_far=1000.0)
    view = JaxRenderSettings.default(sun_dir=SUN, num_lights=2).with_camera(cam, SIZE, SIZE)
    port_scene = packed_scene_from_numpy(
        {k: np.asarray(getattr(scene, k)) for k in scene.__dataclass_fields__}, "cpu")
    return scene, view, port_scene, view_from_numpy(vars(view), "cpu")


def _assert_close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _assert_slice_close(got: torch.Tensor, want) -> None:
    diff = np.abs(got.numpy() - np.asarray(want)).max(-1)
    assert (diff <= 1e-3).mean() >= 0.99 and diff.mean() <= 1e-3


def test_raster_gbuffer_pass_matches_jax(inputs):
    scene, view, port_scene, port_view = inputs
    jg = JaxGraph()
    jax_gbuffer_pass(jg, None, SIZE, SIZE, use_raycast=False)
    want = jg.render(scene, view)
    g = Graph(device="cpu")
    setup_gbuffer_pass(g, None, SIZE, SIZE, use_raycast=False)
    assert g.passes[0].host_sync is None  # the binning reads nothing back to the host
    got = g.render(port_scene, port_view)
    for name in ("gbuffer_position", "gbuffer_normal", "gbuffer_albedo", "gbuffer_pbr",
                 "gbuffer_depth"):
        _assert_close(got[name], want[name])
    covered = got["gbuffer_depth"] < 1.0
    assert 0.2 < float(covered.float().mean()) < 1.0


def test_raster_minimal_forward_matches_jax(inputs):
    scene, view, port_scene, port_view = inputs
    jcam = JaxCamera(EYE, TARGET, aspect_ratio=1.0, z_near=0.01, z_far=1000.0)
    cam = Camera(EYE, TARGET, aspect_ratio=1.0, z_near=0.01, z_far=1000.0)
    jg = JaxGraph()
    jax_minimal(jg, JaxStaticConfig(**SMALL), jcam, None, SUN)
    want = jg.render(scene, view)
    g = Graph(device="cpu")
    build_minimal_forward_render_graph(g, StaticConfig(**SMALL), cam, None, SUN)
    assert [p.host_sync for p in g.passes] == [None, None, None]
    got = g.render(port_scene, port_view)
    for name in ("forward_output", "gbuffer_depth"):
        _assert_close(got[name], want[name])
    _assert_slice_close(got["present_output"], want["present_output"])
    assert float(got["present_output"].std()) > 0.01


def test_raster_visibility_picks_on_the_default_view():
    """Why the raster gbuffer pass on the card (K5) and on the CPU (the
    brute path) pick another triangle on some pixels of the default scene
    at 96x96: the two rasterizers' own choice, in both packages.

    The port's brute path is the JAX package's pixel for pixel; the JAX
    package's two rasterizers (brute, and its binned Pallas kernel in
    interpret mode) disagree on some covered pixels, as the port's brute and
    binned paths do; and wherever the port's two disagree, both cover the
    pixel and their depths are within 2e-3 of each other (near-equal depth
    in the far field, where the depth is above 0.99, and pixel centres on
    shared edges)."""
    size = 96
    japp = JaxApplication(size, size, JaxMode.PATH_TRACED, JaxStaticConfig())
    japp.create_scene()
    japp._refresh_view()
    app = Application(size, size, cfg=StaticConfig(), device="cpu")
    app.create_scene()
    app._refresh_view()
    jclip = jax_raster.transform_vertices(japp.scene.positions,
                                          japp.view.projection @ japp.view.view)
    jbrute = jax_raster.rasterize(jclip, japp.scene.indices, size, size, method="brute")
    jbinned = jax_raster_binned.rasterize_binned(jclip, japp.scene.indices, size, size,
                                                 interpret=True)
    view = app.view.to("cpu")
    clip = raster.transform_vertices(app.scene.positions, view.projection @ view.view)
    brute = raster.rasterize(clip, app.scene.indices, size, size, method="brute")
    binned = raster.rasterize(clip, app.scene.indices, size, size, method="binned")

    np.testing.assert_array_equal(brute.tri.numpy(), np.asarray(jbrute.tri))
    covered = np.asarray(jbrute.tri) >= 0
    assert covered.mean() > 0.5
    jax_picked = np.asarray(jbinned.tri) != np.asarray(jbrute.tri)
    assert 0 < jax_picked.sum() < 0.05 * covered.sum()
    picked = binned.tri != brute.tri
    assert 0 < int(picked.sum()) < 0.1 * covered.sum()
    assert bool(((binned.tri >= 0) & (brute.tri >= 0))[picked].all())
    gap = (binned.depth - brute.depth).abs()[picked]
    assert float(gap.max()) <= 2e-3
    assert float(brute.depth[picked].min()) > 0.99

"""The port's whole PATH_TRACED frame against the JAX package's.

Both Applications render the default scene at 64x64 for 2 frames, with
view.time pinned (it seeds every random stream) and the JAX app's BVH built
with leaf_size=12, the port's layout. Same seeds, same tables: the active-ray
counts must be equal, at least 99% of pixels within 1e-3 and the mean
absolute difference at most 1e-3. Paths that graze an edge can leave on
another bounce after a last-ulp difference, which is why pixels are not all
held to 1e-3.
"""

import numpy as np
import torch

from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.settings import RenderGraphMode
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.ops import traversal
from rust_renderer_tpu_torch.settings import StaticConfig

torch.set_num_threads(1)

SIZE, FRAMES, BOUNCES, TIME = 64, 2, 3, 0.25


def _frames(app, to_numpy):
    out = []
    for _ in range(FRAMES):
        res = app.render_frame()
        out.append((to_numpy(res["present_output"]),
                    float(to_numpy(app.graph.state["pt_rays"]))))
    return out


def _port_frames(device):
    app = Application(SIZE, SIZE, cfg=StaticConfig(num_bounces=BOUNCES), device=device)
    app.fps_timer.elapsed_seconds = lambda: TIME
    app.create_scene()
    return app, _frames(app, lambda x: x.cpu().numpy())


def _assert_close_frames(got, want):
    for (img, rays), (ref, ref_rays) in zip(got, want):
        assert img.shape == (SIZE, SIZE, 3)
        assert np.isfinite(img).all()
        assert rays == ref_rays
        diff = np.abs(img - ref).max(axis=-1)
        assert (diff <= 1e-3).mean() >= 0.99
        assert np.abs(img - ref).mean() <= 1e-3


def test_pt_frame_matches_jax_application():
    jax_app = JaxApplication(SIZE, SIZE, RenderGraphMode.PATH_TRACED,
                             JaxStaticConfig(num_bounces=BOUNCES))
    jax_app.fps_timer.elapsed_seconds = lambda: TIME
    jax_app.create_scene()
    jax_app.scene_bvh = jax_bvh.build_bvh(np.asarray(jax_app.scene.positions),
                                          np.asarray(jax_app.scene.indices),
                                          leaf_size=12)
    want = _frames(jax_app, np.asarray)

    launches = dict(traversal.K1_LAUNCHES)
    app, got = _port_frames("cpu")
    _assert_close_frames(got, want)
    # CPU tensors take the plain walk: K1 never launches.
    assert dict(traversal.K1_LAUNCHES) == launches
    assert app.total_samples == FRAMES
    # The frames accumulate: the second differs from the first.
    assert np.abs(got[1][0] - got[0][0]).mean() > 1e-4


def test_path_trace_matches_jax_on_shared_inputs():
    """ops/pathtrace.py alone: one frame with uniform light NEE, on the JAX
    package's own scene, BVH tables and view carried across by convert.py."""
    from rust_renderer_tpu import Camera as JaxCamera
    from rust_renderer_tpu import Renderer as JaxRenderer
    from rust_renderer_tpu.models import create_scene as jax_create_scene
    from rust_renderer_tpu.ops import pathtrace as jax_pathtrace
    from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings

    from rust_renderer_tpu_torch.convert import (
        bvh_from_numpy, packed_scene_from_numpy, view_from_numpy)
    from rust_renderer_tpu_torch.ops import bvh as torch_bvh
    from rust_renderer_tpu_torch.ops import pathtrace

    size = 32
    cam = JaxCamera([0, 0, 0], [0, 0, -1], aspect_ratio=1.0)
    renderer = JaxRenderer()
    jax_create_scene(renderer, cam)
    jax_scene = renderer.pack()
    tree = jax_bvh.build_bvh(np.asarray(jax_scene.positions),
                             np.asarray(jax_scene.indices), leaf_size=12)
    view = JaxRenderSettings.default(num_lights=10).with_camera(cam, size, size).replace(
        total_samples=np.uint32(1), time=np.float32(TIME))
    cfg = JaxStaticConfig(width=size, height=size, num_bounces=BOUNCES)
    accumulation = np.zeros((size, size, 3), np.float32)
    want = jax_pathtrace.path_trace(
        jax_scene, view, cfg, accumulation,
        closest_hit=jax_bvh.make_closest_hit(tree), any_hit=jax_bvh.make_any_hit(tree))

    scene = packed_scene_from_numpy(
        {k: np.asarray(getattr(jax_scene, k)) for k in jax_scene.__dataclass_fields__},
        "cpu")
    port_tree = bvh_from_numpy(
        {k: np.asarray(getattr(tree, k)) for k in
         ("node_packed", "leaf_packed", "wnode_packed", "max_depth", "wide_depth")},
        "cpu")
    got = pathtrace.path_trace(
        scene, view_from_numpy(vars(view), "cpu"),
        StaticConfig(width=size, height=size, num_bounces=BOUNCES),
        torch.tensor(accumulation), closest_hit=torch_bvh.make_closest_hit(port_tree),
        any_hit=torch_bvh.make_any_hit(port_tree))
    assert float(got.rays_traced) == float(want.rays_traced)
    diff = np.abs(got.output.numpy() - np.asarray(want.output))
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3
    np.testing.assert_allclose(got.accumulation.numpy().mean(),
                               np.asarray(want.accumulation).mean(), rtol=1e-3)


def _sphere_scene(package):
    """The RTIOW scene (diffuse ground and centre, glass, metal), built by
    `package`'s own `models.create_rtiow_scene`, with its camera."""
    renderer = package.Renderer()
    camera = package.Camera([0, 1, 4], [0, 0.5, -1], fov_degrees=60.0, aspect_ratio=1.0)
    package.models.create_rtiow_scene(renderer, camera)
    return renderer, camera


def test_furnace_test_matches_jax():
    """StaticConfig(furnace_test=True): every miss sees a white sky, even
    with sky_enabled=0, in both packages (tests/test_debug_tools.py's case:
    32x32, two bounces, no sun or lights). The port's frame against the JAX
    package's, furnace on and off, under this file's tolerance; with it on,
    the top row (the sky) is 1.0 to 1e-5 in both, and off it is black."""
    import rust_renderer_tpu as jax_rt
    import rust_renderer_tpu.models  # noqa: F401  (package.models above)
    from rust_renderer_tpu.ops import pathtrace as jax_pathtrace
    from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings

    import rust_renderer_tpu_torch as torch_rt
    import rust_renderer_tpu_torch.models  # noqa: F401  (package.models above)
    from rust_renderer_tpu_torch.convert import view_from_numpy
    from rust_renderer_tpu_torch.ops import bvh as torch_bvh
    from rust_renderer_tpu_torch.ops import pathtrace

    size = 32
    jax_renderer, jax_camera = _sphere_scene(jax_rt)
    jax_scene = jax_renderer.pack()
    jax_tree = jax_bvh.build_bvh(np.asarray(jax_scene.positions),
                                 np.asarray(jax_scene.indices), leaf_size=12)
    renderer, _ = _sphere_scene(torch_rt)
    scene = renderer.pack(device="cpu")
    tree = torch_bvh.build_bvh(scene.positions.numpy(), scene.indices.numpy(), device="cpu")
    np.testing.assert_array_equal(scene.sphere_center.numpy(),
                                  np.asarray(jax_scene.sphere_center))
    view = JaxRenderSettings.default(num_lights=0).with_camera(jax_camera, size, size).replace(
        total_samples=np.uint32(1), time=np.float32(TIME), sky_enabled=np.int32(0),
        sun_shadow_enabled=np.int32(0), lights_enabled=np.int32(0))
    accumulation = np.zeros((size, size, 3), np.float32)
    for furnace in (True, False):
        want = jax_pathtrace.path_trace(
            jax_scene, view,
            JaxStaticConfig(width=size, height=size, num_bounces=2, furnace_test=furnace),
            accumulation, closest_hit=jax_bvh.make_closest_hit(jax_tree),
            any_hit=jax_bvh.make_any_hit(jax_tree))
        got = pathtrace.path_trace(
            scene, view_from_numpy(vars(view), "cpu"),
            StaticConfig(width=size, height=size, num_bounces=2, furnace_test=furnace),
            torch.tensor(accumulation), closest_hit=torch_bvh.make_closest_hit(tree),
            any_hit=torch_bvh.make_any_hit(tree))
        img, ref = got.output.numpy(), np.asarray(want.output)
        assert float(got.rays_traced) == float(want.rays_traced)
        diff = np.abs(img - ref)
        assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
        assert diff.mean() <= 1e-3
        sky = 1.0 if furnace else 0.0
        np.testing.assert_allclose(ref[0], sky, atol=1e-5)
        np.testing.assert_allclose(img[0], sky, atol=1e-5)

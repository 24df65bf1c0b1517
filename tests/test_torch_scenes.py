"""The port's scene builders (`models/scenes.py`) against the JAX package's.

Every builder must pack bit-identical scenes (positions, indices, materials,
spheres, lights, textures) and set the same camera; the BVH tables of the
cube and 128-light scenes must be bit-identical too (the `jax_sah` fixture,
tests/test_torch_host.py). Frames: one 32x32 PATH_TRACED frame of the RTIOW,
Cornell stand-in and 128-light scenes, and one 64x64 RASTERIZED frame of the
cube scene, against the JAX package's Application with its BVH built with
leaf_size=12 (the port's layout) and the clock pinned. Tolerance: the
slice's, at least 99% of pixels within 1e-3 and a mean absolute difference
of at most 1e-3; the active-ray counts equal. The JAX frames are rendered
once per mode, in module fixtures. The glTF builders take an asset where
RUST_RENDERER_TPU_ASSETS holds it (`_find_asset`) and pack what the JAX
package packs then; without, what it builds then.
"""

import dataclasses

import numpy as np
import pytest
import torch

import rust_renderer_tpu as jax_rt
import rust_renderer_tpu.models as jax_models
from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.models import scenes as jax_scenes
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig

import rust_renderer_tpu_torch as torch_rt
import rust_renderer_tpu_torch.models as torch_models
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig
from test_torch_host import _assert_tables_equal, ensure_jax_native_sah

torch.set_num_threads(1)

BUILDERS = ("create_rtiow_scene", "create_cornell_standin_scene", "create_cube_scene",
            "create_restir_many_lights_scene", "create_cornell_box_scene",
            "create_metal_rough_spheres")
PT_SCENES = ("create_rtiow_scene", "create_cornell_standin_scene",
             "create_restir_many_lights_scene")
PT_SIZE, RASTER_SIZE, TIME = 32, 64, 0.25
SMALL = dict(shadow_map_size=64, cubemap_size=16, cubemap_mips=4, irradiance_size=8,
             brdf_lut_size=16, mc_grid=8, num_bounces=2)
ASSETS = (
    ("create_cornell_box_scene", "prototype/data/models/CornellBox-Original.gltf"),
    ("create_cornell_box_scene", "prototype/data/models/FlightHelmet/glTF/FlightHelmet.gltf"),
    ("create_metal_rough_spheres", "prototype/data/models/MetalRoughSpheresNoTextures/glTF/"
     "MetalRoughSpheresNoTextures.gltf"),
)


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def _jax_builder(name):
    # create_restir_many_lights_scene is not in the JAX package's models/__init__.py.
    return getattr(jax_scenes, name)


def _build(package, builder):
    renderer = package.Renderer()
    camera = package.Camera([0, 0, 0], [0, 0, -1], fov_degrees=60.0, aspect_ratio=1.0)
    builder(renderer, camera)
    renderer.ensure_mc_material()
    return renderer, camera


@pytest.mark.parametrize("name", BUILDERS)
def test_scene_packs_like_jax(name, monkeypatch):
    monkeypatch.delenv("RUST_RENDERER_TPU_ASSETS", raising=False)
    jr, jcam = _build(jax_rt, _jax_builder(name))
    tr, tcam = _build(torch_rt, getattr(torch_models, name))
    jax_scene, port = jr.pack(), tr.pack_numpy()
    for f in dataclasses.fields(jax_scene):
        want = np.asarray(getattr(jax_scene, f.name))
        assert port[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(port[f.name], want, err_msg=f.name)
    for get in ("get_view", "get_projection", "get_position"):
        np.testing.assert_array_equal(getattr(tcam, get)(), getattr(jcam, get)(), err_msg=get)
    # Without their assets the glTF builders give the light cube alone and nothing.
    if name == "create_cornell_box_scene":
        assert port["indices"].shape[0] == 12
    if name == "create_metal_rough_spheres":
        assert port["indices"].shape[0] == 0


def test_models_export_the_jax_builders():
    assert set(jax_models.__all__) <= set(torch_models.__all__)


@pytest.mark.parametrize("name", ["create_cube_scene", "create_restir_many_lights_scene"])
def test_bvh_tables_match_jax(name, jax_sah):
    jr, _ = _build(jax_rt, _jax_builder(name))
    tr, _ = _build(torch_rt, getattr(torch_models, name))
    jax_scene, port = jr.pack(), tr.pack_numpy()
    _assert_tables_equal(
        jax_bvh.build_bvh(np.asarray(jax_scene.positions), np.asarray(jax_scene.indices),
                          leaf_size=12),
        torch_bvh.build_bvh_numpy(port["positions"], port["indices"]))


def _jax_frame(name, mode, size):
    app = JaxApplication(size, size, mode, JaxStaticConfig(**SMALL))
    app.fps_timer.elapsed_seconds = lambda: TIME
    app.create_scene(_jax_builder(name))
    app.scene_bvh = jax_bvh.build_bvh(np.asarray(app.scene.positions),
                                      np.asarray(app.scene.indices), leaf_size=12)
    res = app.render_frame()
    rays = float(np.asarray(res["pt_rays"])) if "pt_rays" in res else None
    return np.asarray(res["present_output"]), rays


def _port_frame(name, mode, size):
    app = Application(size, size, mode, StaticConfig(**SMALL), device="cpu")
    app.fps_timer.elapsed_seconds = lambda: TIME
    app.create_scene(getattr(torch_models, name))
    res = app.render_frame()
    rays = float(res["pt_rays"]) if "pt_rays" in res else None
    return res["present_output"].numpy(), rays


@pytest.fixture(scope="module")
def jax_pt_frames(jax_sah):
    return {name: _jax_frame(name, JaxMode.PATH_TRACED, PT_SIZE) for name in PT_SCENES}


@pytest.fixture(scope="module")
def jax_raster_frame(jax_sah):
    return _jax_frame("create_cube_scene", JaxMode.RASTERIZED, RASTER_SIZE)


def _assert_close(got, want):
    (img, rays), (ref, ref_rays) = got, want
    assert np.isfinite(img).all() and img.std() > 0.01
    assert rays == ref_rays
    diff = np.abs(img - ref)
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3


@pytest.mark.parametrize("name", PT_SCENES)
def test_pt_frame_matches_jax(name, jax_pt_frames):
    _assert_close(_port_frame(name, RenderGraphMode.PATH_TRACED, PT_SIZE),
                  jax_pt_frames[name])


def test_cube_scene_rasterized_frame_matches_jax(jax_raster_frame):
    _assert_close(_port_frame("create_cube_scene", RenderGraphMode.RASTERIZED, RASTER_SIZE),
                  jax_raster_frame)


@pytest.mark.parametrize("name,asset", ASSETS)
def test_asset_builders_refuse_a_present_asset(name, asset, tmp_path, monkeypatch):
    """With an asset present (here an empty glTF document) the builder loads
    it, as the JAX package's does, and no longer refuses: one more
    instance, and the same packed scene as the JAX package's."""
    path = tmp_path / asset
    path.parent.mkdir(parents=True)
    path.write_text("{}")
    monkeypatch.setenv("RUST_RENDERER_TPU_ASSETS", str(tmp_path))
    # The JAX package reads the variable when it is imported.
    monkeypatch.setattr(jax_scenes, "_ASSET_ROOTS", [str(tmp_path)])
    tr, _ = _build(torch_rt, getattr(torch_models, name))
    jr, _ = _build(jax_rt, _jax_builder(name))
    assert len(tr.instances) == len(jr.instances) == (
        2 if name == "create_cornell_box_scene" else 1)
    jax_scene, port = jr.pack(), tr.pack_numpy()
    for f in dataclasses.fields(jax_scene):
        np.testing.assert_array_equal(port[f.name], np.asarray(getattr(jax_scene, f.name)),
                                      err_msg=f.name)

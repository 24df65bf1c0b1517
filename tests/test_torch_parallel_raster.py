"""Row bands of the RASTERIZED and MINIMAL graphs (`Graph.shard_image_rows`)
over 8 torch.distributed ranks against the port's one-rank frames and the
JAX package's sharded frames on its 8-device CPU mesh.

The scene, camera and StaticConfig are tests/test_parallel_raster.py's
(32x64, so 8-row bands; 64² cascades, a 16² cubemap), SSAO and FXAA on, so
the band-edge halos are read: SSAO reaches 32 rows and FXAA 12, beyond an
8-row band on both sides. The ranks (gloo over a file store under the
test's temporary directory, one CPU thread each) are spawned once for the
module and run every case; the rank function lives here, and this module
imports jax only inside its tests, so a rank never imports it.

Tolerances: gathered, the sharded present_output is the one-rank frame's
within 3e-5 (the JAX package's bound for its own sharded frame); against
the JAX package's sharded frame, the slice tolerance (99% of pixels within
1e-3, mean |diff| <= 1e-3, tests/test_torch_raster_slice.py). The ranks also
run `python -m rust_renderer_tpu_torch.parallel`'s main(), whose image must
be the app's main() image bit for bit.
"""

import sys

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.parallel import make_tile_group, spawn_ranks, tiles

torch.set_num_threads(1)

W, H, RANKS = 32, 64, 8
CFG = dict(width=W, height=H, shadow_map_size=64, cubemap_size=16, cubemap_mips=2,
           irradiance_size=8, brdf_lut_size=16, num_bounces=1)
SUN = np.array([0.0, 0.90631, 0.42262], np.float32)
IMAGE = ("present_output", "ssao_output", "gbuffer_position", "gbuffer_depth")
# A square image as large as the BRDF LUT: the LUT has the image's leading
# dims and must stay whole all the same.
SQUARE = 64
SQUARE_CFG = dict(shadow_map_size=64, cubemap_size=16, cubemap_mips=2, irradiance_size=8,
                  brdf_lut_size=SQUARE, num_bounces=1)


def _setup(package, **pack_args):
    """test_parallel_raster.py's scene (two cubes and a light), camera and
    view, built by `package` (the JAX package or the port)."""
    r = package.Renderer()
    cam = package.Camera([3, 2, 5], [0, 0.5, 0], aspect_ratio=W / H, z_near=0.1,
                         z_far=100.0)
    r.add_model(package.scene.ModelLoader.load_cube(),
                package.utils.math3d.translation([0, 0.5, 0]))
    r.add_model(package.scene.ModelLoader.load_cube(),
                package.utils.math3d.scale([20.0, 0.1, 20.0]))
    r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
    scene = r.pack(**pack_args)
    view = package.RenderSettings.default(num_lights=r.get_num_lights()).with_camera(
        cam, W, H).replace(total_samples=np.uint32(1))
    return cam, scene, view


def _builders():
    """The graphs: RASTERIZED and MINIMAL as the JAX test builds them; the
    RASTERIZED graph with the marching-cubes draw; the forward and gbuffer
    passes' raster branches (K5's on the card)."""
    from rust_renderer_tpu_torch.renderers import (
        build_minimal_forward_render_graph, build_render_graph)
    from rust_renderer_tpu_torch.renderers.passes import (
        setup_forward_pass, setup_gbuffer_pass, setup_present_pass, setup_shadow_pass,
        setup_ssao_pass)

    def forward_raster(g, cfg, cam, b, sun):
        m, s = setup_shadow_pass(g, cam, sun, True, cfg.shadow_map_size)
        setup_forward_pass(g, cfg, W, H, m, s, scene_bvh=None)
        setup_present_pass(g, W, H, source="forward_output")

    def gbuffer_raster(g, cfg, cam, b, sun):
        setup_gbuffer_pass(g, b, W, H, use_raycast=False)
        setup_ssao_pass(g, W, H)
        setup_present_pass(g, W, H, source="gbuffer_normal")

    return {
        "RASTERIZED": lambda g, cfg, cam, b, sun: build_render_graph(
            g, cfg, cam, b, sun, need_environment_update=True),
        "MINIMAL": build_minimal_forward_render_graph,
        "RASTERIZED_MC": lambda g, cfg, cam, b, sun: build_render_graph(
            g, cfg, cam, b, sun, need_environment_update=True, marching_cubes_enabled=True),
        "FORWARD_RASTER": forward_raster,
        "GBUFFER_RASTER": gbuffer_raster,
    }


def _port_frames(group=None) -> dict:
    """Each graph's frame on the port, row-sharded over `group` where given:
    the whole present_output, the band's image-space shapes, its
    shadow_map."""
    import rust_renderer_tpu_torch as port
    import rust_renderer_tpu_torch.scene  # noqa: F401
    import rust_renderer_tpu_torch.utils.math3d  # noqa: F401
    from rust_renderer_tpu_torch.ops.bvh import build_scene_bvh

    cam, scene, view = _setup(port, device="cpu")
    bvh = build_scene_bvh(scene)
    out = {}
    for name, builder in _builders().items():
        g = port.Graph(device="cpu")
        if group is not None:
            g.shard_image_rows(group, H, W)
        cfg = port.StaticConfig(**CFG, mc_grid=8)
        frame_view = view.replace(marching_cubes_enabled=np.int32(name == "RASTERIZED_MC"))
        g.new_frame()
        g.clear()
        builder(g, cfg, cam, bvh, SUN)
        res = g.render(scene, frame_view)
        whole = (lambda t: t) if group is None else (lambda t: tiles.gather_rows(t, group))
        out[name] = {
            "present": whole(res["present_output"]).numpy(),
            "ssao": whole(res["ssao_output"]).numpy() if "ssao_output" in res else None,
            "shapes": {k: tuple(res[k].shape) for k in IMAGE if k in res},
            "shadow_map": res["shadow_map"].numpy() if "shadow_map" in res else None,
            "reason": g.device_loop_unsupported_reason(),
            "capture": g.capture_unsupported_reason(),
        }
    return out


def _square_frames(group=None) -> dict:
    """The RASTERIZED app on the cube scene at SQUARE x SQUARE: a first
    frame whole, then, where `group` is given, its graph row-sharded over
    the group (the state it holds included) for the second frame. Returns
    the second frame's whole present_output, its band's shape and the BRDF
    LUT the graph holds."""
    import rust_renderer_tpu_torch as port
    from rust_renderer_tpu_torch.app.main import MODES, SCENES, Application

    app = Application(SQUARE, SQUARE, MODES["raster"], port.StaticConfig(**SQUARE_CFG),
                      device="cpu")
    app.create_scene(SCENES["cubes"])
    app.render_frame()
    if group is not None:
        app.graph.shard_image_rows(group, SQUARE, SQUARE)
    present = app.render_frame()["present_output"]
    whole = present if group is None else tiles.gather_rows(present, group)
    return {"present": whole.numpy(), "band": tuple(present.shape),
            "brdf_lut": app.graph.state["brdf_lut"].numpy()}


# `python -m rust_renderer_tpu_torch.parallel`'s and the app's command line.
MAIN_ARGS = ["--width", str(W), "--height", str(H), "--frames", "1", "--mode", "minimal",
             "--scene", "cubes", "--small", "--device", "cpu"]


def _rank(rank, n, out_dir):
    from rust_renderer_tpu_torch.parallel.__main__ import main

    group, _ = make_tile_group(device="cpu")
    frames = _port_frames(group)
    main(MAIN_ARGS + ["--out", f"{out_dir}/banded.png"])
    return {"frames": frames, "square": _square_frames(group),
            "imported_jax": "jax" in sys.modules or "rust_renderer_tpu" in sys.modules}


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("images")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, out_dir):
    return spawn_ranks(_rank, RANKS, str(tmp_path_factory.mktemp("ranks")),
                       args=(str(out_dir),), threads=1)


@pytest.fixture(scope="module")
def one_rank():
    return _port_frames()


@pytest.fixture(scope="module")
def one_rank_square():
    return _square_frames()


@pytest.mark.parametrize("name", list(_builders()))
def test_rowband_frame_matches_one_rank(sharded, one_rank, name):
    """Gathered from 8 ranks, present_output (and the SSAO term, where the
    graph has one) is the one-rank frame's within 3e-5; every image-space
    resource on each rank is its (8, 32, ...) band."""
    want = one_rank[name]["present"]
    assert np.isfinite(want).all() and want.std() > 1e-3
    for rank in sharded:
        got = rank["frames"][name]
        np.testing.assert_allclose(got["present"], want, atol=3e-5)
        if one_rank[name]["ssao"] is not None:
            assert one_rank[name]["ssao"].min() < 0.99
            np.testing.assert_allclose(got["ssao"], one_rank[name]["ssao"], atol=3e-5)
        for res, shape in got["shapes"].items():
            assert shape[:2] == (H // RANKS, W), res
        assert one_rank[name]["shapes"]["present_output"] == (H, W, 3)


def test_shadow_map_is_whole_and_equal_on_every_rank(sharded, one_rank):
    for name in ("RASTERIZED", "MINIMAL"):
        want = one_rank[name]["shadow_map"]
        assert want.shape == (4, 64, 64)
        for rank in sharded:
            np.testing.assert_array_equal(rank["frames"][name]["shadow_map"], want)


def test_sharded_graph_refuses_the_device_loop(sharded, one_rank):
    """The device loop takes a row-sharded graph (its collectives run in
    every frame); over gloo it refuses only the capture, naming the
    backend."""
    assert one_rank["MINIMAL"]["reason"] is None
    for rank in sharded:
        assert rank["frames"]["MINIMAL"]["reason"] is None
        assert rank["frames"]["MINIMAL"]["capture"].startswith(
            "gloo collectives cannot be captured")
        assert not rank["imported_jax"]


def test_sharding_after_a_frame_keeps_light_space_whole(sharded, one_rank_square):
    """At 64x64 the BRDF LUT, (64, 64, 2), has the image's leading dims.
    Row-sharding the RASTERIZED app's graph after its first frame bands the
    image and leaves the LUT it holds whole, so the second frame, gathered
    from 8 ranks, is the one-rank frame's within 3e-5."""
    want = one_rank_square
    assert want["brdf_lut"].shape == (SQUARE, SQUARE, 2)
    assert np.isfinite(want["present"]).all() and want["present"].std() > 1e-3
    for rank in sharded:
        got = rank["square"]
        assert got["band"] == (SQUARE // RANKS, SQUARE, 3)
        np.testing.assert_array_equal(got["brdf_lut"], want["brdf_lut"])
        np.testing.assert_allclose(got["present"], want["present"], atol=3e-5)


def test_shard_image_rows_takes_rows_only():
    """The graph shards over image rows only: another axis raises before any
    collective."""
    import rust_renderer_tpu_torch as port

    with pytest.raises(ValueError, match="rows only"):
        port.Graph(device="cpu").shard_image_rows(None, H, W, axis="cols")


@pytest.mark.parametrize("name", ["RASTERIZED", "MINIMAL"])
def test_rowband_frame_matches_jax_sharded(sharded, name):
    """The gathered 8-rank frame against the JAX package's frame row-sharded
    over its 8-device mesh (its BVH at leaf size 12, the port's layout)."""
    import jax
    import jax.numpy as jnp

    import rust_renderer_tpu as jrt
    import rust_renderer_tpu.scene  # noqa: F401
    import rust_renderer_tpu.utils.math3d  # noqa: F401
    from rust_renderer_tpu.ops import bvh as jbvh
    from rust_renderer_tpu.renderers import (
        build_minimal_forward_render_graph, build_render_graph)
    from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig

    cam, scene, view = _setup(jrt)
    view = view.replace(total_samples=jnp.uint32(1))
    bvh = jbvh.build_bvh(np.asarray(scene.positions), np.asarray(scene.indices), leaf_size=12)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:RANKS]), ("rows",))
    g = jrt.Graph()
    g.shard_image_rows(mesh, H, W)
    g.new_frame()
    g.clear()
    cfg = JaxStaticConfig(**CFG)
    if name == "RASTERIZED":
        build_render_graph(g, cfg, cam, bvh, SUN, need_environment_update=True)
    else:
        build_minimal_forward_render_graph(g, cfg, cam, bvh, SUN)
    want = np.asarray(g.render(scene, view)["present_output"])
    got = sharded[0]["frames"][name]["present"]
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3


def test_parallel_main_writes_the_app_image(sharded, out_dir):
    """`python -m rust_renderer_tpu_torch.parallel` on the 8 ranks writes the
    image that the app's main() writes with the same arguments in one
    process."""
    from rust_renderer_tpu_torch.app.main import main as app_main
    from rust_renderer_tpu_torch.utils.image_io import read_image

    written = [p for p in out_dir.iterdir() if p.name.startswith("banded")]
    assert len(written) == 1
    app_main(MAIN_ARGS + ["--out", str(out_dir / "one.png")])
    one = [p for p in out_dir.iterdir() if p.name.startswith("one")]
    want = read_image(str(one[0]))
    assert want.shape[:2] == (H, W) and want.std() > 0
    np.testing.assert_array_equal(read_image(str(written[0])), want)

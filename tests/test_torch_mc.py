"""The traced marching-cubes isosurface (bench config 5) of the port against
the JAX package: ``ops/mc_bvh.py`` and the PATH_TRACED graph with
marching_cubes_enabled.

Inputs at the JAX suite's grid (tests/test_mc_pt.py: GRID 8, the reference
SDF scaled into the grid, its ray sets), made from seeds with numpy.
Tolerances, and why:
- the refit tables: bit-equal to the JAX package's from one MC result (min,
  max and subtraction round alike), the leaf rows slot by slot after the
  12-slot re-layout, the two dead slots zero with id -1;
- the walks of the dynamic tree (the plain walk here, the JAX package's XLA
  walk there, both over the binary skip tree of equal tables): hit flags
  equal, t to 1e-5 relative, prim equal but for ties of t; against brute
  force the JAX suite's 1e-4 and 99% of prims;
- the combined hit queries and the surface / gbuffer patches: 1e-5 (the
  same elementwise float32 operations; the normalization's norm may round
  another way);
- a 64x64 PT frame with MC on: the slice tolerance, at least 99% of pixels
  within 1e-3 and a mean absolute difference of at most 1e-3 (the two
  extractions agree to ~1e-5, test_torch_raster_ops.py);
- the device loop against the port's own host loop: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.models import create_cube_scene as jax_create_cube_scene
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.ops import gbuffer as jax_gbuffer
from rust_renderer_tpu.ops import intersect as jax_intersect
from rust_renderer_tpu.ops import mc_bvh as jax_mc_bvh
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig
from rust_renderer_tpu.utils import math3d as jax_math3d

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.convert import dynamic_tables_from_numpy, packed_scene_from_numpy
from rust_renderer_tpu_torch.models import create_cube_scene
from rust_renderer_tpu_torch.ops import gbuffer, intersect, marching_cubes, mc_bvh, traversal
from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig
from test_mc_pt import GRID, _brute_closest
from test_mc_pt import _mc_result as jax_mc_result
from test_torch_host import ensure_jax_native_sah

torch.set_num_threads(1)

T_RTOL = 1e-5
SIZE, TIME = 64, 1.7
SMALL = dict(shadow_map_size=64, cubemap_size=16, cubemap_mips=2, irradiance_size=8,
             brdf_lut_size=16, num_bounces=2, mc_grid=GRID)
# The MC region in view (tests/test_mc_pt.py:173).
EYE, TARGET = [58.0, 38.0, 58.0], [10.0, 18.0, 10.0]


@pytest.fixture(scope="module")
def jax_res():
    res = jax_mc_result(time=1.7)
    assert int(np.sum(np.asarray(res.valid))) > 50, "SDF emitted no surface"
    return res


def _port_result(jres) -> marching_cubes.MarchingCubesResult:
    return marching_cubes.MarchingCubesResult(
        positions=torch.tensor(np.asarray(jres.positions)),
        normals=torch.tensor(np.asarray(jres.normals)),
        valid=torch.tensor(np.asarray(jres.valid)),
        vertex_count=torch.tensor(int(jres.vertex_count)))


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint32)


def _rays(seed: int, n: int):
    """tests/test_mc_pt.py's rays about the grid's centre."""
    rng = np.random.default_rng(seed)
    center = np.full(3, GRID / 2.0, np.float32)
    o = (center + rng.normal(0, GRID, (n, 3))).astype(np.float32)
    d = (center + rng.normal(0, GRID / 3, (n, 3)) - o).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _assert_hits_agree(t, prim, want_t, want_prim):
    """Hit flags equal; t to T_RTOL; prim equal where t is not a tie."""
    hit = want_prim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], want_t[hit], rtol=T_RTOL, atol=0)
    off = hit & (prim != want_prim)
    assert not off.any() or np.allclose(t[off], want_t[off], rtol=T_RTOL, atol=0)


def test_static_topology_matches_jax():
    want = jax_mc_bvh._static_topology(GRID)
    got = mc_bvh._static_topology(GRID)
    for key in ("morton_cells", "wide_refs", "wide_meta", "pre2heap", "bin_cols", "miss_pre",
                "leaf_pre"):
        np.testing.assert_array_equal(_bits(got[key].astype(np.uint32)
                                            if key == "pre2heap" else got[key]),
                                      _bits(want[key].astype(np.uint32)
                                            if key == "pre2heap" else want[key]), key)
    for key in ("rows", "wide_level_sizes", "wide_depth", "bin_depth"):
        assert got[key] == want[key], key


def test_refit_tables_bit_equal_to_jax(jax_res):
    want = jax_mc_bvh.build_dynamic_tables(jax_res, GRID)
    got = mc_bvh.build_dynamic_tables(_port_result(jax_res), GRID)
    assert {k: tuple(v.shape) for k, v in got.items()} == mc_bvh.table_shapes(GRID)
    for name in ("mc_wnode", "mc_node", "mc_tri_normals"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), name)

    # The leaf rows, slot by slot: the JAX rows' 10 slots, then two dead.
    rows = got["mc_leaf"].numpy()
    jrows = np.asarray(want["mc_leaf"])
    r = rows.shape[0]
    geo, jgeo = rows[:, :108].reshape(r, 12, 9), jrows[:, :90].reshape(r, 10, 9)
    ids, jids = rows[:, 108:].view(np.int32), jrows[:, 90:].view(np.int32)
    np.testing.assert_array_equal(_bits(geo[:, :10]), _bits(jgeo))
    np.testing.assert_array_equal(ids[:, :10], jids)
    assert (_bits(geo[:, 10:]) == 0).all() and (ids[:, 10:] == -1).all()
    assert (jids >= 0).sum() == int(np.sum(np.asarray(jax_res.valid)))

    # The carried tables are the refit's, and the scene's metadata the JAX one's.
    carried = dynamic_tables_from_numpy({k: np.asarray(v) for k, v in want.items()}, "cpu")
    for name, t in got.items():
        np.testing.assert_array_equal(_bits(carried[name]), _bits(t), name)
    dyn = mc_bvh.dynamic_scene_from_tables(got, GRID, 7)
    jdyn = jax_mc_bvh.build_dynamic_scene(jax_res, GRID, 7)
    np.testing.assert_array_equal(dyn.bvh.wnode_meta.numpy(), np.asarray(jdyn.bvh.wnode_meta))
    assert (dyn.bvh.wide_depth, dyn.bvh.max_depth) == (jdyn.bvh.wide_depth, jdyn.bvh.max_depth)
    assert int(dyn.material) == 7 and dyn.bvh.wnode_q32 is None and dyn.bvh.seed_rows is None
    assert traversal.select_kernel(dyn.bvh, **mc_bvh._WALK) == "k1"


def test_refit_leaves_no_inverted_box(jax_res):
    """Empty cells' boxes reach the tables as a point at +3e37, never as
    an inverted box (which tests as covering everything)."""
    got = mc_bvh.build_dynamic_tables(_port_result(jax_res), GRID)
    boxes = got["mc_wnode"][:, :96].reshape(-1, 6, 16).transpose(1, 2).reshape(-1, 6)
    nodes = got["mc_node"][:, :6]
    for b in (boxes, nodes):
        inverted = (b[:, :3] > b[:, 3:]).any(dim=1)
        assert not inverted.any()
        point = (b[:, :3] == 3.0e37).all(dim=1) & (b[:, 3:] == 3.0e37).all(dim=1)
        assert point.any() and (~point).any()


@pytest.mark.parametrize("any_hit,seed,n", [(False, 11, 512), (False, 13, 1024), (True, 3, 256)])
def test_dynamic_walk_matches_jax_and_brute_force(jax_res, any_hit, seed, n):
    o, d = _rays(seed, n)
    dyn = mc_bvh.build_dynamic_scene(_port_result(jax_res), GRID, 0)
    t, prim, _, _ = (x.numpy() for x in mc_bvh.dyn_traverse(
        dyn, torch.tensor(o), torch.tensor(d), 1e-3, 1e4, any_hit=any_hit))
    jdyn = jax_mc_bvh.build_dynamic_scene(jax_res, GRID, 0)
    jt, jprim, _, _ = (np.asarray(x) for x in jax_mc_bvh._dyn_traverse(
        jdyn, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e4, any_hit=any_hit))
    tb, primb = _brute_closest(np.asarray(jax_res.positions), np.asarray(jax_res.valid), o, d)
    hit = np.isfinite(tb)
    assert hit.sum() > 30, "the rays barely hit the surface"
    np.testing.assert_array_equal(prim >= 0, hit)
    if any_hit:
        np.testing.assert_array_equal(prim >= 0, jprim >= 0)
        return
    _assert_hits_agree(t, prim, jt, jprim)
    np.testing.assert_allclose(t[hit], tb[hit], rtol=1e-4, atol=1e-4)
    assert (prim[hit] == primb[hit]).mean() > 0.99


def _scene_near_surface():
    """A cube in the middle of the grid and a floor under it, so some rays
    hit the scene first and some the isosurface; JAX scene and the port's."""
    r = JaxRenderer()
    r.add_model(JaxModelLoader.load_cube(), jax_math3d.translation([4.0, 4.0, 4.0])
                @ jax_math3d.scale([1.5, 1.5, 1.5]))
    r.add_model(JaxModelLoader.load_cube(), jax_math3d.translation([4.0, -0.5, 4.0])
                @ jax_math3d.scale([20.0, 0.1, 20.0]))
    r.add_light([4.0, 12.0, 4.0], [1.0, 1.0, 1.0], 1.0)
    scene = r.pack()
    return scene, packed_scene_from_numpy(
        {k: np.asarray(getattr(scene, k)) for k in scene.__dataclass_fields__}, "cpu")


def _port_tuple(cls, jax_value):
    return cls(*(torch.tensor(np.asarray(x)) for x in jax_value))


def test_combined_queries_and_patches_match_jax(jax_res):
    jscene, scene = _scene_near_surface()
    o, d = _rays(11, 512)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.tensor(o), torch.tensor(d)
    mc_color = (0.2, 0.7, 0.1, 1.0)
    jdyn = jax_mc_bvh.build_dynamic_scene(jax_res, GRID, 5)
    dyn = mc_bvh.build_dynamic_scene(_port_result(jax_res), GRID, 5)

    jhit = jax_mc_bvh.combine_closest_hit(jax_intersect.closest_hit_bruteforce, jdyn)(
        jscene, jo, jd)
    hit = mc_bvh.combine_closest_hit(intersect.closest_hit_bruteforce, dyn)(scene, to, td)
    kind, jkind = hit.kind.numpy(), np.asarray(jhit.kind)
    np.testing.assert_array_equal(kind, jkind)
    assert (kind == intersect.HIT_DYNAMIC).sum() > 30 and (kind == intersect.HIT_TRIANGLE).sum() > 30
    live = kind != 0
    _assert_hits_agree(hit.t.numpy(), np.where(live, hit.prim.numpy(), -1), np.asarray(jhit.t),
                       np.where(live, np.asarray(jhit.prim), -1))
    same = live & (hit.prim.numpy() == np.asarray(jhit.prim))
    for a, b in ((hit.u, jhit.u), (hit.v, jhit.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-5, atol=1e-5)

    jocc = jax_mc_bvh.combine_any_hit(jax_intersect.any_hit_bruteforce, jdyn)(jscene, jo, jd)
    occ = mc_bvh.combine_any_hit(intersect.any_hit_bruteforce, dyn)(scene, to, td)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))

    # The patches, on the JAX hits and surfaces.
    phit = _port_tuple(intersect.Hit, jhit)
    jsurf = jax_intersect.surface_at_hit(jscene, jhit, jo, jd)
    want = jax_mc_bvh.surface_patch(jdyn, jhit, jd, jsurf)
    got = mc_bvh.surface_patch(dyn, phit, td, _port_tuple(intersect.Surface, jsurf))
    for name in intersect.Surface._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    jgb = jax_gbuffer.from_rays(jscene, jhit, jo, jd)
    want = jax_mc_bvh.patch_gbuffer(jdyn, jhit, jd, jgb, mc_color)
    got = mc_bvh.patch_gbuffer(dyn, phit, td, _port_tuple(gbuffer.GBuffer, jgb), mc_color)
    for name in gbuffer.GBuffer._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _cube_scene_with_light(builder):
    """The cube scene plus one point light (with no light the graph drops
    its gbuffer)."""

    def build(r, cam):
        builder(r, cam)
        r.add_light([16.0, 34.0, 16.0], [1.0, 1.0, 1.0], 1.0)

    return build


def _mc_app(app):
    app.fps_timer.elapsed_seconds = lambda: TIME
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    app.create_scene(_cube_scene_with_light(
        jax_create_cube_scene if isinstance(app, JaxApplication) else create_cube_scene))
    app.camera.set_position_target(EYE, TARGET)
    return app


def _port_app() -> Application:
    return _mc_app(Application(SIZE, SIZE, RenderGraphMode.PATH_TRACED, StaticConfig(**SMALL),
                               device="cpu"))


def _mc_pixels(app) -> int:
    return int((app.graph.render(app.scene, app.view)["gbuffer_pbr"][..., 3]
                == app.renderer.ensure_mc_material()).sum())


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def test_mc_pt_frame_matches_jax(jax_sah):
    japp = _mc_app(JaxApplication(SIZE, SIZE, JaxMode.PATH_TRACED, JaxStaticConfig(**SMALL)))
    japp.scene_bvh = jax_bvh.build_bvh(np.asarray(japp.scene.positions),
                                       np.asarray(japp.scene.indices), leaf_size=12)
    want = np.asarray(japp.run(1))
    app = _port_app()
    got = app.run(1)
    assert [p.name for p in app.graph.passes][:3] == ["mc_extract", "mc_refit", "gbuffer"]
    diff = np.abs(got - want)
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3
    mc = app.renderer.ensure_mc_material()
    jpbr = np.asarray(japp.graph.render(japp.scene, japp.view)["gbuffer_pbr"])[..., 3]
    pbr = app.graph.render(app.scene, app.view)["gbuffer_pbr"][..., 3].numpy()
    assert (pbr == mc).sum() > 20
    assert ((pbr == mc) != (jpbr == mc)).mean() <= 0.01


def test_mc_surface_animates_and_toggles_off():
    app = _port_app()
    app.run(1)
    assert _mc_pixels(app) > 20, "the MC surface is not visible in the PT gbuffer"
    draw0 = int(app.graph.render(app.scene, app.view)["marching_cubes_draw_count"][0])
    draw1 = int(app.graph.render(app.scene, app.view.replace(time=np.float32(4.0)))
                ["marching_cubes_draw_count"][0])
    assert draw0 != draw1, "the isosurface did not animate with time"
    # The run-time flag empties the tree of the same graph; then the app
    # builds the graph without the MC passes.
    app.view = app.view.replace(marching_cubes_enabled=np.int32(0))
    assert _mc_pixels(app) == 0
    app.render_frame()
    assert "mc_refit" not in [p.name for p in app.graph.passes]
    assert _mc_pixels(app) == 0


def test_mc_device_loop_matches_host_loop_bit_for_bit():
    host = _port_app()
    want = host.run(3)
    loop = _port_app()
    img = loop.run_on_device(3, tstep=0.0)
    assert loop.graph.capture_unsupported_reason() is None
    assert loop.graph.device_loop_unsupported_reason() is None
    assert loop.graph.last_loop_form == "eager: no CUDA graphs on cpu"
    assert set(loop.graph.state) == set(host.graph.state)
    for name, t in host.graph.state.items():
        assert torch.equal(loop.graph.state[name], t), name
    np.testing.assert_array_equal(img.numpy(), want)

"""The JAX package's frame-graph API on the port (``graph.py``): pass
uniforms, `prepare`, the builder aliases and the call forms of the repaired
signatures, held to the JAX package on the same inputs.

- tests/test_graph.py's uniforms and `prepare` cases run on both packages
  with the same values and must give the same numbers.
- A uniform is a device buffer that the graph keeps per (pass, name, shape,
  dtype): a rebuild with new values hands the body the same tensor (the
  port's "no recompile"), so the captured loop's key, which holds device
  tensors by identity, is unchanged.
- The builders pass what the JAX builders pass as uniforms (names and
  values equal per pass); the RASTERIZED and MINIMAL frames that read them
  are held to the JAX Application in tests/test_torch_raster_slice.py at the
  slice tolerance (64^2: 99% of pixels within 1e-3, mean |diff| <= 1e-3).
- The functions called in the JAX positional form: the marching-cubes pass
  at 48^2 and the light sums at 24^2 to 1e-5 relative, as
  tests/test_torch_raster_ops.py holds pbr; the environment at 1e-4 (capture
  and LUT) and 2e-3 (the specular prefilter's GGX jitter), as that file
  holds ibl.
- The other public names: rng bit-equal on the same uint32 state;
  planet_intersection to 1e-6 relative or 0.5 m, one float32 ulp at the
  planet's radius: its quadratic's coefficients are of the radius's square,
  and their cancellation resolves roots to that ulp whatever the order of
  the float32 sums.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_renderer_tpu as jrt
from rust_renderer_tpu import native as jax_native
from rust_renderer_tpu import renderer as jax_renderer
from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.ops import atmosphere as jax_atmosphere
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.ops import ibl as jax_ibl
from rust_renderer_tpu.ops import pbr as jax_pbr
from rust_renderer_tpu.ops import rng as jax_rng
from rust_renderer_tpu.renderers.passes import (
    setup_marching_cubes_pass as jax_setup_marching_cubes_pass)
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig

import rust_renderer_tpu_torch as trt
from rust_renderer_tpu_torch import native, renderer
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.convert import packed_scene_from_numpy, view_from_numpy
from rust_renderer_tpu_torch.graph import Graph, PassBuilder
from rust_renderer_tpu_torch.ops import atmosphere, bvh, ibl, pbr, rng
from rust_renderer_tpu_torch.renderers.passes import setup_marching_cubes_pass
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from test_torch_host import ensure_jax_native_sah
from test_torch_raster_ops import _assert_lut_close

torch.set_num_threads(1)

SUN = np.array([0.0, 0.90631, 0.42262], np.float32)
SMALL = dict(shadow_map_size=64, cubemap_size=16, cubemap_mips=4, irradiance_size=8,
             brdf_lut_size=16, mc_grid=8, num_bounces=2)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _full(package, shape, value):
    if package == "jax":
        return jnp.full(shape, value)
    return value.expand(shape).clone()


# -- tests/test_graph.py's cases on both packages -------------------------------


@pytest.mark.parametrize("package", ["jax", "port"])
def test_uniforms_are_traced_not_baked(package):
    """tests/test_graph.py:71-86: one pass rebuilt with a new uniform value
    renders the new value. The JAX graph compiles once; the port hands the
    body the same device buffer both times."""
    g = jrt.Graph() if package == "jax" else Graph(device="cpu")
    g.create_texture("a", 2, 2, 1)

    def scaled(res, scene, view, u):
        return {"a": _full(package, (2, 2), u["scale"])}

    outs, buffers = [], []
    for s in [1.0, 3.0]:
        g.new_frame()
        g.clear()
        g.add_pass("p").write("a").uniforms("scale", np.float32(s)).render(scaled).build()
        outs.append(float(_np(g.render(None, {})["a"])[0, 0]))
        buffers.append(g.passes[0].uniforms["scale"])
    assert outs == [1.0, 3.0]
    if package == "jax":
        assert len(g._compiled) == 1
    else:
        assert buffers[0] is buffers[1]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_resource_resize_reallocates(package):
    """tests/test_graph.py:128-137: `prepare` allocates a persistent resource
    missing from the state, at its new shape after a resize."""
    g = jrt.Graph() if package == "jax" else Graph(device="cpu")
    g.create_texture("a", 4, 4, 1, persistent=True)
    g.prepare()
    assert tuple(g.state["a"].shape) == (4, 4)
    g.create_texture("a", 8, 8, 1, persistent=True)
    g.prepare()
    assert tuple(g.state["a"].shape) == (8, 8)
    del g.state["a"]
    g.prepare()
    assert tuple(g.state["a"].shape) == (8, 8) and float(_np(g.state["a"]).max()) == 0.0


# -- the builder's JAX form --------------------------------------------------------


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_pass_built_the_jax_way(package):
    """add_pass().read_buffer().image_write().uniforms().dispatch(fn4)
    .build(), with write_buffer, load_write, trace_rays and
    presentation_pass: the same image on both packages."""
    g = jrt.Graph() if package == "jax" else Graph(device="cpu")
    g.create_buffer("src", (2, 3), clear=2.0)
    g.create_texture("img", 3, 2, 1)
    g.create_buffer("buf", (2, 3))
    g.create_buffer("acc", (2, 3))

    def shade(res, scene, view, u):
        return {"img": res["src"] * u["k"] + u["offset"][1]}

    def more(res, scene, view, u):
        return {"buf": res["img"] * u["k"], "acc": res["img"] - 1.0}

    builder = g.add_pass("shade")
    assert builder.presentation_pass("swapchain", extra=1) is builder
    (builder.read_buffer("src").image_write("img")
     .uniforms("k", np.float32(3.0)).uniforms("offset", np.asarray([0.5, 0.25], np.float32))
     .dispatch(shade).build())
    (g.add_pass("more").read("img").write_buffer("buf").load_write("acc")
     .uniforms("k", 0.5).trace_rays(more).build())
    out = g.render(None, {})
    np.testing.assert_array_equal(_np(out["img"]), np.full((2, 3), 6.25, np.float32))
    np.testing.assert_array_equal(_np(out["buf"]), np.full((2, 3), 3.125, np.float32))
    np.testing.assert_array_equal(_np(out["acc"]), np.full((2, 3), 5.25, np.float32))


def test_aliases_are_the_jax_builders():
    for name in ("image_write", "write_buffer", "load_write"):
        assert getattr(PassBuilder, name) is PassBuilder.write
    for name in ("dispatch", "trace_rays"):
        assert getattr(PassBuilder, name) is PassBuilder.render
    assert trt.graph.TextureId is trt.graph.BufferId is str
    g = Graph(device="cpu")
    assert g.create_texture("t", 2, 2) == "t" and g.create_buffer("b", (3,)) == "b"


def test_three_and_four_argument_bodies():
    """A body of 3 parameters gets (resources, scene, view); of 4 (or
    *args), the uniforms too. The form is read once, when the pass is
    built."""
    g = Graph(device="cpu")
    g.create_buffer("x", (2,))
    calls = []

    def three(res, scene, view):
        calls.append(3)
        return {"x": torch.ones(2)}

    def four(res, scene, view, u):
        calls.append(4)
        return {"x": res["x"] + u["k"]}

    def star(*args):
        calls.append(len(args))
        return {"x": args[0]["x"] * 2.0}

    def scaled(res, scene, view, u, factor):
        return {"x": res["x"] * factor}

    g.add_pass("three").write("x").render(three).build()
    g.add_pass("four").read("x").write("x").uniforms("k", 1.5).render(four).build()
    g.add_pass("star").read("x").write("x").render(star).build()
    g.add_pass("partial").read("x").write("x").render(
        functools.partial(scaled, factor=0.25)).build()
    assert [p.takes_uniforms for p in g.passes] == [False, True, True, True]
    out = g.render(None, {})
    assert calls == [3, 4, 4]
    np.testing.assert_array_equal(out["x"].numpy(), [1.25, 1.25])
    assert isinstance(g.passes[1].uniforms, types.MappingProxyType)
    with pytest.raises(TypeError):
        g.passes[1].uniforms["k"] = torch.zeros(())


def test_hot_reload_fallback_calls_the_last_good_body_in_its_form():
    """The last good body takes the uniforms where the failing one does
    not: the fallback calls it the way it was built."""
    g = Graph(device="cpu")
    g.create_buffer("x", (2,))

    def good(res, scene, view, u):
        return {"x": u["k"].expand(2).clone()}

    def broken(res, scene, view):
        raise RuntimeError("bad kernel")

    g.add_pass("p").write("x").uniforms("k", 4.0).render(good).build()
    g.render(None, {})
    g.recompile()
    g.clear()
    g.add_pass("p").write("x").uniforms("k", 5.0).render(broken).build()
    np.testing.assert_array_equal(g.render(None, {})["x"].numpy(), [5.0, 5.0])


def test_uniform_buffers_keep_their_identity_across_rebuilds():
    """Two rebuilds with new values: the same tensors (storage and all),
    holding the new values after one upload; the captured loop's key is
    unchanged: it holds CUDA tensors by identity. Another shape or dtype is
    another buffer."""
    g = Graph(device="cpu")
    g.create_buffer("x", (4, 4))
    uploads = []

    def body(res, scene, view, u):
        return {"x": u["m"] * u["s"]}

    def build(m, s):
        g.new_frame()
        g.clear()
        g.add_pass("p").write("x").uniforms("m", m).uniforms("s", s).render(body).build()
        return dict(g.passes[0].uniforms)

    first = build(np.eye(4, dtype=np.float32), np.float32(2.0))
    arena = g._uniforms.arenas[0]
    upload = arena.upload
    arena.upload = lambda: (uploads.append(1), upload())
    ptrs = {n: t.data_ptr() for n, t in first.items()}
    g.render(None, {})
    for m, s in ((np.full((4, 4), 3.0, np.float32), 0.5), (np.ones((4, 4)), 7.0)):
        bufs = build(m, s)  # float64 values become float32, as in the JAX package
        assert all(bufs[n] is first[n] for n in bufs)
        assert {n: t.data_ptr() for n, t in bufs.items()} == ptrs
        out = g.render(None, {})
        np.testing.assert_array_equal(out["x"].numpy(), np.asarray(m, np.float32) * s)
    assert len(uploads) == 3  # one copy per build, for both values
    other = build(np.eye(3, dtype=np.float32), 7)
    assert other["m"] is not first["m"] and other["s"] is not first["s"]
    assert other["s"].dtype == torch.int32
    assert len(g._uniforms.arenas) == 1


def test_uniforms_reach_render_loop_and_are_not_sanitized():
    """render_loop reads the last build's values; the sanitizer counts the
    passes' outputs, not a uniform holding NaN."""
    g = Graph(device="cpu", sanitize=True)
    g.create_texture("present_output", 2, 2, 3)

    def body(res, scene, view, u):
        return {"present_output": torch.zeros(2, 2, 3) + u["c"][0] * 0.0 + u["c"][1]}

    for c in ((float("nan"), 1.0), (float("nan"), 2.0)):
        g.clear()
        g.add_pass("p").write("present_output").uniforms(
            "c", np.asarray(c, np.float32)).render(body).build()
    assert torch.isnan(g.passes[0].uniforms["c"]).sum() == 0  # staged, not uploaded yet
    out = g.render_loop(None, RenderSettings.default(), 2)
    assert torch.isnan(out).all()  # nan * 0.0 + 2.0
    assert g.last_sanitizer_report == {"p/present_output": 24}
    g.clear()
    g.add_pass("p").write("present_output").uniforms(
        "c", np.asarray((0.0, 2.0), np.float32)).render(body).build()
    np.testing.assert_array_equal(g.render_loop(None, RenderSettings.default(), 1).numpy(),
                                  np.full((2, 2, 3), 2.0, np.float32))
    assert g.last_sanitizer_report == {}


# -- the builders pass JAX's uniforms ----------------------------------------------


def _graphs(mode_name: str, jax_sah):
    """The JAX and the port Application's graphs of one RASTERIZED (with
    marching cubes) or MINIMAL frame at 32^2, built, not rendered."""
    apps = []
    for App, Mode, Cfg, kw in ((JaxApplication, JaxMode, JaxStaticConfig, {}),
                               (Application, RenderGraphMode, StaticConfig,
                                {"device": "cpu"})):
        app = App(32, 32, getattr(Mode, mode_name), Cfg(**SMALL), **kw)
        app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
        app.create_scene()
        app._refresh_view()
        app._build_graph()
        apps.append(app)
    return apps


@pytest.mark.parametrize("mode", ["RASTERIZED", "MINIMAL"])
def test_builders_pass_the_jax_uniforms(mode, jax_sah):
    """Per pass, the uniforms' names and values of the port's builders
    equal the JAX builders' (shadow cascade_vp; SSAO radius, bias; deferred
    and forward cascade_vp, cascade_splits; marching-cubes color; FXAA
    threshold), and every body that reads them takes them."""
    jax_app, app = _graphs(mode, jax_sah)
    app.graph.prepare()
    want = {p.name: p.uniforms for p in jax_app.graph.passes if p.uniforms}
    got = {p.name: p.uniforms for p in app.graph.passes if p.uniforms}
    assert sorted(got) == sorted(want)
    assert {"shadow", "present"} <= set(got)
    for name, uniforms in want.items():
        assert sorted(got[name]) == sorted(uniforms), name
        for k, v in uniforms.items():
            np.testing.assert_array_equal(got[name][k].numpy(), np.asarray(v), err_msg=k)
    assert all(p.takes_uniforms for p in app.graph.passes if p.uniforms)


def test_new_uniform_values_render_as_a_graph_built_with_them(monkeypatch):
    """The FXAA threshold and SSAO radius changed between builds: the frame
    equals the same frame of a graph built with those values from the
    start."""
    import rust_renderer_tpu_torch.renderers as builders
    from rust_renderer_tpu_torch.renderers import passes

    def frame(app, radius, threshold):
        monkeypatch.setattr(builders, "setup_ssao_pass",
                            functools.partial(passes.setup_ssao_pass, radius=radius))
        monkeypatch.setattr(builders, "setup_present_pass",
                            functools.partial(passes.setup_present_pass,
                                              fxaa_threshold=threshold))
        return app.render_frame()["present_output"]

    def make():
        app = Application(32, 32, RenderGraphMode.RASTERIZED, StaticConfig(**SMALL),
                          device="cpu")
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        return app

    app, fresh = make(), make()
    first = frame(app, 0.3, 0.45)
    changed = frame(app, 1.5, 0.05)
    frame(fresh, 1.5, 0.05)
    assert torch.equal(changed, frame(fresh, 1.5, 0.05))
    assert not torch.equal(first, changed)


# -- the JAX positional call forms -----------------------------------------------


def test_graph_takes_sanitize_by_position():
    g = Graph(True, ("quiet",), device="cpu")
    assert g.sanitize and g.suppress == ("quiet",) and g.device.type == "cpu"
    with pytest.raises(TypeError):
        Graph(False, (), "cpu")


def test_compute_environment_takes_lut_samples_by_position():
    cfg = StaticConfig(**SMALL)
    got = ibl.compute_environment(cfg, SUN, 64, device="cpu")
    want = jax_ibl.compute_environment(JaxStaticConfig(**SMALL), SUN, 64)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name == "brdf_lut":  # tests/test_torch_raster_ops.py's LUT bound
            _assert_lut_close(got[name], value, 64)
            continue
        tol = (dict(rtol=0, atol=2e-3) if name.startswith("specular")
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), **tol, err_msg=name)
    assert not np.allclose(got["brdf_lut"].numpy(), ibl.compute_environment(
        cfg, SUN, device="cpu")["brdf_lut"].numpy(), rtol=0, atol=1e-7)


def test_build_bvh_takes_the_jax_options_by_position():
    pos, idx = _soup()
    tree = bvh.build_bvh(pos, idx, 12, True, 1.0, 0, "keep", device="cpu")
    same = bvh.build_bvh(pos, idx, device="cpu")
    for a, b in zip(tree[:3], same[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert tree.num_nodes == tree.node_packed.shape[0] > 1
    jtree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    assert tree.num_nodes == jtree.num_nodes
    for args, name in (((4,), "leaf_size"), ((12, False), "use_native"),
                       ((12, True, 2.0), "presplit_ratio"), ((12, True, 1.0, 1), "reinsert")):
        with pytest.raises(ValueError, match=name):
            bvh.build_bvh(pos, idx, *args, device="cpu")
    with pytest.raises(ValueError, match="packet"):
        bvh.make_closest_hit(tree, False)
    with pytest.raises(ValueError, match="skip_expand"):
        bvh.make_any_hit(tree, skip_expand=False)


def _soup():
    """The cube and the triangle's pools, as numpy."""
    r = trt.Renderer()
    r.add_model(trt.scene.ModelLoader.load_cube(), np.eye(4, dtype=np.float32))
    r.add_model(trt.scene.ModelLoader.load_triangle(), np.eye(4, dtype=np.float32))
    scene = r.pack(device="cpu")
    return scene.positions.numpy(), scene.indices.numpy()


def test_marching_cubes_pass_in_the_jax_positional_form():
    """setup_marching_cubes_pass(g, cfg, w, h, target, voxel_size, color,
    flat_normals) by position on both packages: the drawn colour, depth
    and draw count over the same cleared planes agree."""
    size = 48
    cfg = dict(mc_grid=8, width=size, height=size)
    view = RenderSettings.default().with_camera(
        trt.Camera([8.0, 14.0, -14.0], [8.0, 6.0, 8.0], aspect_ratio=1.0), size, size)
    view = view.replace(marching_cubes_enabled=np.int32(1), time=np.float32(0.5))
    fields = {k: np.asarray(v) for k, v in vars(view).items()}
    args = ("deferred_output", 2.0, (1.0, 0.0, 0.0, 1.0), True)  # the domain [0, 16]^3
    jg = jrt.Graph()
    jg.create_texture("deferred_output", size, size, 4, clear=0.25)
    jg.create_texture("gbuffer_depth", size, size, 1, clear=1.0)
    jax_setup_marching_cubes_pass(jg, JaxStaticConfig(**cfg), size, size, *args)
    jview = jrt.RenderSettings(**{k: jnp.asarray(v) for k, v in fields.items()})
    want = jg.render(None, jview)
    g = Graph(device="cpu")
    g.create_texture("deferred_output", size, size, 4, clear=0.25)
    g.create_texture("gbuffer_depth", size, size, 1, clear=1.0)
    setup_marching_cubes_pass(g, StaticConfig(**cfg), size, size, *args)
    got = g.render(None, view_from_numpy(fields, "cpu"))
    assert g.passes[0].uniforms["color"].tolist() == [1.0, 0.0, 0.0, 1.0]
    assert int(got["marching_cubes_draw_count"][0]) == int(
        np.asarray(want["marching_cubes_draw_count"])[0]) > 0
    img, ref = got["deferred_output"].numpy(), np.asarray(want["deferred_output"])
    drawn = (img != 0.25).any(-1)
    assert drawn.mean() > 0.02 and np.all(img[drawn][:, 1:3] == 0.0)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)


def _lights():
    r = jrt.Renderer()
    r.add_model(jrt.scene.ModelLoader.load_cube(), np.eye(4, dtype=np.float32))
    r.add_light([2.0, 3.0, 2.0], [1.0, 0.8, 0.6], 1.0)
    r.add_light([-2.0, 1.0, 0.5], [0.3, 0.5, 1.0], 2.0)
    r.add_light([0.0, 5.0, -1.0], [1.0, 1.0, 1.0], 1.0)
    scene = r.pack()
    port = packed_scene_from_numpy({k: np.asarray(getattr(scene, k))
                                    for k in scene.__dataclass_fields__}, "cpu")
    view = jrt.RenderSettings.default(num_lights=3)
    return scene, port, view, view_from_numpy({k: np.asarray(v) for k, v in
                                               vars(view).items()}, "cpu")


def _pixels(shape=(24, 24)):
    rng_ = np.random.default_rng(7)
    unit = rng_.normal(size=shape + (3,))
    fields = dict(
        position=rng_.uniform(-2, 2, shape + (3,)), base_color=rng_.uniform(0, 1, shape + (3,)),
        normal=unit / np.linalg.norm(unit, axis=-1, keepdims=True),
        metallic=rng_.uniform(0, 1, shape), roughness=rng_.uniform(0.05, 1, shape),
        occlusion=rng_.uniform(0.5, 1, shape))
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    return (jax_pbr.PixelParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            pbr.PixelParams(**{k: torch.tensor(v) for k, v in fields.items()}))


@pytest.mark.parametrize("max_lights", [None, 0, 2, 8])
def test_shade_all_lights_max_lights_matches_jax(max_lights):
    scene, port, view, tview = _lights()
    jpix, pix = _pixels()
    want = jax_pbr.shade_all_lights(jpix, scene, view, max_lights=max_lights)
    got = pbr.shade_all_lights(pix, port, tview, max_lights=max_lights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if max_lights == 2:
        full = pbr.shade_all_lights(pix, port, tview)
        assert not torch.allclose(got, full)


@pytest.mark.parametrize("factor", [1.0, 0.25, "tensor"])
def test_surface_shading_light_color_factor_matches_jax(factor):
    scene, port, view, tview = _lights()
    jpix, pix = _pixels()
    jf = jnp.full((24, 24, 1), 0.5) if factor == "tensor" else factor
    tf = torch.full((24, 24, 1), 0.5) if factor == "tensor" else factor
    args = lambda s, i: (s.light_color[i], s.light_pos[i], s.light_dir[i], s.light_type[i],
                         s.light_att[i], s.light_spot[i])
    want = jax_pbr.surface_shading(jpix, *args(scene, 1), view.eye_pos, light_color_factor=jf)
    got = pbr.surface_shading(pix, *args(port, 1), tview.eye_pos, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# -- the smaller public names ------------------------------------------------------


def _state(n, frame):
    jstate = jax_rng.init_rng(jnp.arange(n), jnp.zeros(n, jnp.int32), n, jnp.uint32(frame))
    return jstate, torch.tensor(np.asarray(jstate).astype(np.int64))


@pytest.mark.parametrize("name", ["random_vec3", "random_in_unit_sphere",
                                  "random_in_unit_disk"])
def test_rng_samplers_bit_equal_to_jax(name):
    """The same uint32 state gives the same points and the same advanced
    state (tests/test_rng.py:60,72 draw these with jax.jit)."""
    jstate, state = _state(2048, 5)
    jnew, jp = jax.jit(getattr(jax_rng, name))(jstate)
    new, p = getattr(rng, name)(state)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew).astype(np.int64))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    if name != "random_vec3":
        assert (p.square().sum(-1) < 1.0).all()


def test_rejection_sampler_cap_gives_the_origin():
    """A lane still outside after REJECTION_ROUNDS rounds gets the origin,
    and its state advanced REJECTION_ROUNDS draws, as the JAX fallback."""
    _, state = _state(4, 1)
    outside = lambda s: (rng.step_rng(rng.step_rng(s)), torch.full(s.shape + (2,), 1.0))
    new, p = rng._rejection(state, outside, 2)
    assert torch.equal(p, torch.zeros(4, 2))
    want = state
    for _ in range(2 * rng.REJECTION_ROUNDS):
        want = rng.step_rng(want)
    assert torch.equal(new, want)


def test_planet_intersection_matches_jax():
    r = np.random.default_rng(3)
    o = np.concatenate([r.uniform(-50, 50, (500, 3)), r.uniform(-7e6, 7e6, (100, 3))])
    d = r.normal(size=(600, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    want = jax_atmosphere.planet_intersection(jnp.asarray(o), jnp.asarray(d))
    got = atmosphere.planet_intersection(torch.tensor(o), torch.tensor(d))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=float(np.spacing(np.float32(atmosphere.PLANET_RADIUS))))
        np.testing.assert_array_equal(a.numpy() == -1.0, np.asarray(b) == -1.0)
    assert (got[0].numpy() == -1.0).any() and (got[0].numpy() != -1.0).any()


def test_have_native_and_constants_match_jax(jax_sah):
    assert native.have_native() is True
    assert jax_native.have_native() is True
    for name in ("MAX_NUM_GPU_MATERIALS", "MAX_NUM_GPU_MESHES", "MAX_NUM_GPU_LIGHTS"):
        assert getattr(renderer, name) == getattr(jax_renderer, name)


def test_have_native_is_false_where_the_builder_does_not_build(monkeypatch):
    def fail():
        raise RuntimeError("no g++")

    monkeypatch.setattr(native, "_bvh_lib", fail)
    assert native.have_native() is False


def test_primitive_from_vertices_and_the_triangle_match_jax():
    verts = [trt.scene.Vertex.new(1.0, 2.0, 3.0), trt.scene.Vertex.new(0.0, 1.0, 0.0),
             trt.scene.Vertex.new(-1.0, 0.0, 2.0)]
    jverts = [jrt.scene.Vertex.new(1.0, 2.0, 3.0), jrt.scene.Vertex.new(0.0, 1.0, 0.0),
              jrt.scene.Vertex.new(-1.0, 0.0, 2.0)]
    got = trt.scene.Primitive.from_vertices([0, 1, 2], verts)
    want = jrt.scene.Primitive.from_vertices([0, 1, 2], jverts)
    tri, jtri = (trt.scene.ModelLoader.load_triangle().meshes[0].primitive,
                 jrt.scene.ModelLoader.load_triangle().meshes[0].primitive)
    for a, b in ((got, want), (tri, jtri)):
        for field in ("positions", "normals", "uvs", "colors", "tangents", "indices"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            assert getattr(a, field).dtype == getattr(b, field).dtype


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()

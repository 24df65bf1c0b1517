"""The port's device frame loop (`Graph.render_loop`,
`Application.run_on_device`) against its host loop and the JAX package's.

The scenes and configuration are tests/test_render_loop.py's (`_tiny_scene`,
`CFG`, 32x32) with the clock pinned, since view.time seeds every random
stream. On CPU tensors the loop runs its body eagerly, so against the port's
own host loop it must agree bit for bit; against the JAX loop (a `lax.scan`
over the JAX app's BVH built with leaf_size=12, the port's layout) the
slice tolerance holds: at least 99% of pixels within 1e-3 and a mean
absolute difference of at most 1e-3. The CUDA-graph capture itself runs
only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu.app.main import Application as JaxApplication
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig
from rust_renderer_tpu.utils import math3d as jax_math3d

from rust_renderer_tpu_torch.app.main import Application, _loop_view_update
from rust_renderer_tpu_torch.graph import Graph, _value_key
from rust_renderer_tpu_torch.scene import ModelLoader
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import math3d
from test_torch_host import ensure_jax_native_sah

torch.set_num_threads(1)

W = H = 32
SMALL = dict(width=W, height=H, shadow_map_size=64, cubemap_size=16, cubemap_mips=2,
             irradiance_size=8, brdf_lut_size=16, num_bounces=2)
CFG = StaticConfig(**SMALL)


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def _tiny_scene(loader, math):
    """tests/test_render_loop.py::_tiny_scene for either package."""

    def build(r, cam):
        r.add_model(loader.load_cube(), math.translation([0, 0.5, 0]))
        r.add_model(loader.load_cube(), math.scale([20.0, 0.1, 20.0]))
        r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
        r.add_light([-2.0, 2.0, -1.0], [1.0, 0.5, 0.2], 0.7)
        cam.set_position_target([3, 2, 5], [0, 0.5, 0])

    return build


def _make_app(mode=RenderGraphMode.PATH_TRACED, cfg=CFG) -> Application:
    app = Application(W, H, mode, cfg, device="cpu")
    app.create_scene(_tiny_scene(ModelLoader, math3d))
    app.fps_timer.elapsed_seconds = lambda: 0.0
    return app


def _assert_state_equal(got: Graph, want: Graph) -> None:
    assert set(got.state) == set(want.state)
    for name, t in want.state.items():
        assert torch.equal(got.state[name], t), name


def test_pt_loop_matches_host_loop_bit_for_bit():
    """3 host frames against one 3-frame loop: accumulation, the reservoir
    carry (temporal reuse reads frame k-1's spatial output), pt_rays, the
    presented image and the counters."""
    host = _make_app()
    want = host.run(3)
    loop = _make_app()
    img = loop.run_on_device(3, tstep=0.0)
    assert loop.graph.last_loop_form == "eager: no CUDA graphs on cpu"
    assert any(k.startswith("spatial_reuse_reservoirs") for k in loop.graph.state)
    _assert_state_equal(loop.graph, host.graph)
    np.testing.assert_array_equal(img.numpy(), want)
    assert host.total_samples == loop.total_samples == 3


def test_pt_loop_matches_jax_loop(jax_sah):
    jax_app = JaxApplication(W, H, JaxMode.PATH_TRACED, JaxStaticConfig(**SMALL))
    jax_app.create_scene(_tiny_scene(JaxModelLoader, jax_math3d))
    jax_app.fps_timer.elapsed_seconds = lambda: 0.0
    jax_app.scene_bvh = jax_bvh.build_bvh(np.asarray(jax_app.scene.positions),
                                          np.asarray(jax_app.scene.indices), leaf_size=12)
    want = np.asarray(jax_app.run_on_device(3))
    app = _make_app()
    got = app.run_on_device(3).numpy()
    assert app.total_samples == jax_app.total_samples == 3
    for img, ref in ((got, want), (app.graph.state["accumulation_image"].numpy(),
                                   np.asarray(jax_app.graph.state["accumulation_image"]))):
        diff = np.abs(img - ref)
        assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
        assert diff.mean() <= 1e-3
    assert float(app.graph.state["pt_rays"]) == float(np.asarray(jax_app.graph.state["pt_rays"]))


def test_loop_then_host_frame_continues_protocol():
    """run_on_device(2) then run(1) equals run(3): the host counters and the
    previous frame's matrices are mirrored after the loop."""
    a = _make_app()
    a.run_on_device(2, tstep=0.0)
    a.run(1)
    b = _make_app()
    b.run(3)
    assert a.total_samples == b.total_samples == 3
    _assert_state_equal(a.graph, b.graph)
    np.testing.assert_array_equal(a.view.prev_frame_projection_view,
                                  b.view.prev_frame_projection_view)


def test_raster_loop_matches_host_frame():
    """RASTERIZED frames carry no state: the loop's last frame equals a host
    frame. On CPU tensors the loop runs eagerly; on the card the same graph
    is captured (tests/test_torch_cuda.py), its binning reading nothing back
    to the host."""
    host = _make_app(RenderGraphMode.RASTERIZED)
    want = host.run(2)
    loop = _make_app(RenderGraphMode.RASTERIZED)
    loop.run(1)  # the environment is captured on a host frame
    img = loop.run_on_device(2, tstep=0.0)
    assert loop.graph.last_loop_form == "eager: no CUDA graphs on cpu"
    np.testing.assert_array_equal(img.numpy(), want)
    assert img.std() > 0.01


def test_loop_view_update_advances_the_view():
    """Frame k: total_samples + k * spf, time + k * tstep, and the previous
    frame's matrices set to P·V from k = 1 on."""
    view = RenderSettings.default().replace(total_samples=np.uint32(5),
                                            time=np.float32(0.5)).to("cpu")
    pv = torch.full((4, 4), 2.0)
    aux = {"spf": torch.tensor(2), "tstep": torch.tensor(0.25), "pv": pv}
    for k in range(3):
        got = _loop_view_update(view, torch.tensor(k, dtype=torch.int32), aux)
        assert int(got.total_samples) == 5 + 2 * k
        assert float(got.time) == 0.5 + 0.25 * k
        assert torch.equal(got.prev_frame_projection_view,
                           view.prev_frame_projection_view if k == 0 else pv)


def _img_pass(res, scene, view):
    return {"present_output": torch.zeros((8, 8, 3))}


def test_device_loop_rejects_an_all_isolated_graph():
    g = Graph(device="cpu")
    g.create_texture("present_output", 8, 8, 3)
    g.add_pass("only").write("present_output").render(_img_pass).isolate().build()
    assert "isolated" in g.device_loop_unsupported_reason()
    with pytest.raises(ValueError, match="isolated"):
        g.render_loop(None, RenderSettings.default(), 2)


def test_device_loop_rejects_an_isolated_pass_after_the_body():
    g = Graph(device="cpu")
    g.create_texture("present_output", 8, 8, 3)
    g.add_pass("m").write("present_output").render(_img_pass).build()
    g.add_pass("late").write("present_output").render(_img_pass).isolate().build()
    assert "isolated" in g.device_loop_unsupported_reason()


def test_device_loop_rejects_persistent_prefix_chain():
    g = Graph(device="cpu")
    g.create_buffer("acc", (4,), persistent=True)
    g.create_texture("present_output", 8, 8, 3)

    def pre(res, scene, view):
        return {"acc": res["acc"] + 1.0}

    g.add_pass("pre").read("acc").write("acc").render(pre).isolate().build()
    g.add_pass("m").write("present_output").render(_img_pass).build()
    reason = g.device_loop_unsupported_reason()
    assert reason is not None and "persistent" in reason
    with pytest.raises(ValueError):
        g.render_loop(None, RenderSettings.default(), 2)


def _prefix_graph() -> Graph:
    """An isolated prefix writing a per-frame table (persistent, so it ends
    the loop at its last frame's value) that the body reads into a carried
    accumulation."""
    g = Graph(device="cpu")
    g.create_buffer("table", (4,), persistent=True)
    g.create_buffer("acc", (4,), persistent=True)
    g.create_texture("present_output", 2, 2, 3)

    def pre(res, scene, view):
        return {"table": view.total_samples.to(torch.float32) * torch.arange(4.0)
                + view.time}

    def body(res, scene, view):
        acc = res["acc"] * 0.5 + res["table"]
        return {"acc": acc, "present_output": acc[:3].expand(2, 2, 3) + 0.0}

    g.add_pass("pre").write("table").render(pre).isolate().build()
    g.add_pass("body").read("table").read("acc").write("acc").write("present_output") \
        .render(body).build()
    return g


def test_isolated_prefix_stacks_what_the_body_reads():
    base = RenderSettings.default().replace(total_samples=np.uint32(1), time=np.float32(0.5))
    aux = {"spf": np.uint32(1), "tstep": np.float32(0.25),
           "pv": np.asarray(base.prev_frame_projection_view)}
    host = _prefix_graph()
    for k in range(3):
        res = host.render(None, base.replace(total_samples=np.uint32(1 + k),
                                             time=np.float32(0.5 + 0.25 * k)))
    loop = _prefix_graph()
    img = loop.render_loop(None, base, 3, view_update=_loop_view_update, aux=aux)
    assert loop.last_loop_form == "eager: no CUDA graphs on cpu"
    assert torch.equal(img, res["present_output"])
    _assert_state_equal(loop, host)
    assert float(loop.state["table"][1]) == 3.0 + 1.0  # frame 3's table
    assert loop.current_frame == 3


@pytest.mark.parametrize("mode,sky_mode,reason", [
    ("PATH_TRACED", "exact", None), ("PATH_TRACED", "cubemap", None),
    ("RASTERIZED", "exact", None), ("MINIMAL", "exact", None)])
def test_capture_unsupported_reason_names_the_binning_pass(mode, sky_mode, reason):
    """No pass names a host sync any more: the raster passes' binning
    (K4's and K5's) reads nothing back to the host, so every mode's graph,
    RASTERIZED with the marching-cubes draw included, can be captured on
    the card; on CPU tensors the loop says it ran eagerly for want of CUDA
    graphs."""
    app = _make_app(getattr(RenderGraphMode, mode), CFG.replace(sky_mode=sky_mode))
    app.view = app.view.replace(marching_cubes_enabled=np.int32(mode == "RASTERIZED"))
    app._refresh_view()
    app._build_graph()
    assert "marching_cubes" in [p.name for p in app.graph.passes] or mode != "RASTERIZED"
    assert app.graph.device_loop_unsupported_reason() is None
    assert app.graph.capture_unsupported_reason() is reason
    if mode != "PATH_TRACED":
        app.run(1)  # the environment is captured on a host frame
        app.run_on_device(1, tstep=0.0)
        assert app.graph.last_loop_form == "eager: no CUDA graphs on cpu"


def test_loop_key_follows_what_the_body_computes_with():
    """The captured loop's key (`_value_key` of the passes): equal for the
    same graph built twice, different for another StaticConfig or another
    BVH, whose tables a captured graph would read."""

    def key(app):
        app._build_graph()
        return _value_key([(p.name, p.fn, p.reads, p.writes) for p in app.graph.passes])

    app = _make_app()
    first = key(app)
    assert key(app) == first
    app.cfg = app.cfg.replace(compact_window=16)
    assert key(app) != first
    app.cfg = CFG
    app._repack()
    assert key(app) != first

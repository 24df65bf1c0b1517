"""The port's application layer against the JAX package's: `Input`, the
settings panel (`app/ui.py`), the HUD, image output, the watcher, the
profiler, `main()` by its command line, `run(present_every=)`, the hotkeys
and the gizmo (`set_instance_transform`, `app/viewer.py`). The graph
builders are tests/test_torch_builders.py's.

Frames are small (32x32 or 64x64) with the clock pinned, since view.time
seeds every random stream, and the JAX package's BVH is built with
leaf_size=12, the port's layout. Tolerance: the slice's, at least 99% of
pixels within 1e-3 and a mean absolute difference of at most 1e-3. Saved
images are compared as their 8-bit pixels over 255. The host-side pieces
(input, UI text, HUD pixels, terminal raster, gizmo moves) must equal the
JAX package's exactly.
"""

import functools
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from rust_renderer_tpu.app import main as jax_main
from rust_renderer_tpu.app import viewer as jax_viewer
from rust_renderer_tpu.app.ui import Ui as JaxUi
from rust_renderer_tpu.input import Input as JaxInput
from rust_renderer_tpu.models import create_cornell_box_scene as jax_cornell
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderGraphMode as JaxMode
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings
from rust_renderer_tpu.settings import StaticConfig as JaxStaticConfig
from rust_renderer_tpu.utils import fps_timer as jax_fps_timer
from rust_renderer_tpu.utils import hud as jax_hud
from rust_renderer_tpu.utils import image_io as jax_image_io
from rust_renderer_tpu.utils import math3d as jax_math3d
from rust_renderer_tpu.utils.profiler import Profiler as JaxProfiler
from rust_renderer_tpu.utils.watcher import DirectoryWatcher as JaxWatcher

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.app import main as port_main
from rust_renderer_tpu_torch.app import viewer
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.app.ui import Ui
from rust_renderer_tpu_torch.input import Input
from rust_renderer_tpu_torch.models import create_cornell_box_scene
from rust_renderer_tpu_torch.ops import bvh as bvh_ops, traversal
from rust_renderer_tpu_torch.scene import ModelLoader
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import fps_timer, hud, image_io, math3d
from rust_renderer_tpu_torch.utils.profiler import PROFILER, Profiler
from rust_renderer_tpu_torch.utils.watcher import DirectoryWatcher
from test_torch_host import ensure_jax_native_sah

torch.set_num_threads(1)

W = H = 32
SMALL = dict(shadow_map_size=64, cubemap_size=16, cubemap_mips=2, irradiance_size=8,
             brdf_lut_size=16, num_bounces=2)
CLOCK = 0.25


def _close(got, want) -> None:
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99, diff.max()
    assert diff.mean() <= 1e-3


@pytest.fixture
def jax_leaf12(monkeypatch):
    """The JAX package's apps build their BVH with leaf_size=12, the port's
    layout, with its native SAH builder loaded."""
    ensure_jax_native_sah()
    monkeypatch.setattr(jax_bvh, "build_scene_bvh",
                        functools.partial(jax_bvh.build_scene_bvh, leaf_size=12))


@pytest.fixture
def pinned_clock(monkeypatch):
    """Every FpsTimer of either package reads CLOCK seconds."""
    for module in (jax_fps_timer, fps_timer):
        monkeypatch.setattr(module.FpsTimer, "elapsed_seconds", lambda self: CLOCK)


def _tiny_scene(loader, math):
    """tests/test_render_loop.py::_tiny_scene for either package."""

    def build(r, cam):
        r.add_model(loader.load_cube(), math.translation([0, 0.5, 0]))
        r.add_model(loader.load_cube(), math.scale([20.0, 0.1, 20.0]))
        r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
        r.add_light([-2.0, 2.0, -1.0], [1.0, 0.5, 0.2], 0.7)
        cam.set_position_target([3, 2, 5], [0, 0.5, 0])

    return build


def _apps(mode=RenderGraphMode.PATH_TRACED, build=True):
    """(the JAX app, the port's app) of the tiny scene at W x H."""
    jax_app = jax_main.Application(W, H, getattr(JaxMode, mode.name), JaxStaticConfig(**SMALL))
    app = Application(W, H, mode, StaticConfig(**SMALL), device="cpu")
    if build:
        jax_app.create_scene(_tiny_scene(JaxModelLoader, jax_math3d))
        app.create_scene(_tiny_scene(ModelLoader, math3d))
    return jax_app, app


# -- input, UI, HUD --------------------------------------------------------------


def test_input_edges_match_jax():
    events = [("down", "w"), ("down", "W"), ("frame", None), ("down", "a"), ("up", "w"),
              ("mouse", (3.0, 4.0)), ("mouse", (5.0, 1.0)), ("frame", None), ("down", "w"),
              ("up", "A")]
    states = []
    for inp in (JaxInput(), Input()):
        seen = []
        for kind, arg in events:
            if kind == "down":
                inp.set_key_down(arg)
            elif kind == "up":
                inp.set_key_up(arg)
            elif kind == "mouse":
                inp.move_mouse(*arg)
            else:
                inp.begin_frame()
            seen.append(([inp.key_down(k) for k in "wasd"], [inp.key_pressed(k) for k in "wasd"],
                         inp.mouse_pos, inp.mouse_delta, inp.right_mouse_down))
        states.append(seen)
    assert states[0] == states[1]
    assert states[1][0][1] == [True, False, False, False]
    assert states[1][2][1] == [False] * 4  # edges cleared by begin_frame


def test_ui_matches_jax():
    cfg, jcfg = StaticConfig(**SMALL), JaxStaticConfig(**SMALL)
    view, jview = RenderSettings.default(), JaxRenderSettings.default()
    ui, jui = Ui(), JaxUi()
    changes = []
    for step in range(4):
        if step == 2:
            view, jview = Ui.toggle_flag(view, "sky_enabled"), JaxUi.toggle_flag(
                jview, "sky_enabled")
        if step == 3:
            view = view.replace(shadows_enabled=np.int32(0))  # not a tracked field
            jview = jview.replace(shadows_enabled=jax.numpy.int32(0))
        changes.append((ui.settings_changed(view, cfg), jui.settings_changed(jview, jcfg)))
    assert changes == [(False, False), (False, False), (True, True), (False, False)]
    assert int(view.sky_enabled) == int(jview.sky_enabled) == 0
    assert isinstance(view.sky_enabled, np.int32)
    for mode in ("PATH_TRACED", "MINIMAL"):
        assert ui.hud_lines(view, cfg, getattr(RenderGraphMode, mode), 12.5, 7) == \
            jui.hud_lines(jview, jcfg, getattr(JaxMode, mode), 12.5, 7)
    img = np.random.default_rng(0).random((40, 60, 3)).astype(np.float32)
    assert ui.compose(img, view, cfg, RenderGraphMode.MINIMAL, 1.0, 1) is img
    ui.state.overlay = jui.state.overlay = True
    np.testing.assert_array_equal(
        ui.compose(img, view, cfg, RenderGraphMode.MINIMAL, 1.0, 1),
        jui.compose(img, jview, jcfg, JaxMode.MINIMAL, 1.0, 1))


@pytest.mark.parametrize("shape", [(64, 64, 3), (720, 1280, 3)])
def test_compose_hud_matches_jax(shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    lines = ["MODE: PATH_TRACED", "FPS: 59.94", "SAMPLES: 128", "X=[1-4] (A/B) 50%_", "é?"]
    got = hud.compose_hud(img, lines)
    np.testing.assert_array_equal(got, jax_hud.compose_hud(img, lines))
    assert not np.array_equal(got, img)
    for text in ("ABC 123", "", "hud:/+-="):
        np.testing.assert_array_equal(hud.text_mask(text, 2), jax_hud.text_mask(text, 2))


# -- image output ------------------------------------------------------------------


@pytest.mark.parametrize("pil", [True, False])
def test_save_png_with_and_without_pil(pil, tmp_path, monkeypatch):
    img = np.random.default_rng(2).uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    want = jax_image_io.to_uint8(img)
    np.testing.assert_array_equal(image_io.to_uint8(img), want)
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    path = image_io.save_png(str(tmp_path / "f.png"), img)
    assert path == str(tmp_path / ("f.png" if pil else "f.png.ppm"))
    np.testing.assert_array_equal(image_io.read_image(path), want)
    jax_image_io.save_png(str(tmp_path / "j.png"), img)
    with open(path, "rb") as f, open(str(tmp_path / "j.png") + ("" if pil else ".ppm"),
                                         "rb") as g:
        assert f.read() == g.read()


def test_read_image_keeps_whitespace_pixels(tmp_path, monkeypatch):
    """A PPM whose first pixels are whitespace bytes (10, 32) reads back."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = [10 / 255, 32 / 255, 9 / 255]
    path = image_io.save_png(str(tmp_path / "w.ppm"), img)
    np.testing.assert_array_equal(image_io.read_image(path), image_io.to_uint8(img))


# -- watcher, profiler -------------------------------------------------------------


def _touch(path, when):
    os.utime(path, (when, when))


def test_watcher_maps_modules_and_cuda_sources(tmp_path):
    pkg = tmp_path / "rust_renderer_tpu_torch"
    jpkg = tmp_path / "rust_renderer_tpu"
    for p in (pkg / "ops" / "foo.py", pkg / "renderers" / "__init__.py",
              pkg / "csrc" / "traverse_wide.cu", pkg / "csrc" / "traverse_common.cuh",
              pkg / "csrc" / "raster_binned.cu", pkg / "csrc" / "unknown.cu",
              pkg / "notes.txt", jpkg / "ops" / "foo.py"):
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x")
    w = DirectoryWatcher(str(pkg), debounce_seconds=5.0)
    assert w.check_if_modification() is None
    now = time.time() + 10
    _touch(pkg / "notes.txt", now)
    assert w.check_if_modification() is None  # not a watched suffix
    _touch(pkg / "csrc" / "traverse_wide.cu", now)
    path = w.check_if_modification()
    assert path == str(pkg / "csrc" / "traverse_wide.cu")
    _touch(pkg / "csrc" / "traverse_wide.cu", now + 1)
    assert w.check_if_modification() is None  # within the debounce
    # A CUDA source names no module: the app hands it to native.invalidate.
    assert DirectoryWatcher.module_name_for(path) is None
    names = {f: DirectoryWatcher.module_name_for(str(pkg / f)) for f in (
        "ops/foo.py", "renderers/__init__.py", "csrc/traverse_common.cuh",
        "csrc/raster_binned.cu", "csrc/unknown.cu", "notes.txt")}
    assert names == {"ops/foo.py": "rust_renderer_tpu_torch.ops.foo",
                     "renderers/__init__.py": "rust_renderer_tpu_torch.renderers",
                     "csrc/traverse_common.cuh": None, "csrc/raster_binned.cu": None,
                     "csrc/unknown.cu": None, "notes.txt": None}
    # Python modules map as in the JAX package, under the port's name.
    assert JaxWatcher.module_name_for(str(jpkg / "ops" / "foo.py")) == "rust_renderer_tpu.ops.foo"
    assert DirectoryWatcher.module_name_for(str(tmp_path / "elsewhere.py")) is None


def test_watcher_covers_every_cuda_source(tmp_path, monkeypatch):
    """Every file of csrc/ is a source or header of a declared library, and
    `native.invalidate` of it drops exactly the libraries built from it (a
    header shared by the traversal and seed libraries drops all of them).
    With g++ libraries in a registry of their own: after an edit, the
    libraries built from the edited file load its new code, the others keep
    their handle."""
    csrc = os.path.join(os.path.dirname(native.__file__), os.pardir, "csrc")
    for f in os.listdir(csrc):
        path = os.path.join(csrc, f)
        for lib in native.LIBRARIES.values():
            monkeypatch.setattr(lib, "_lib", object())
        built_from = {lib.name for lib in native.LIBRARIES.values()
                      if f in map(os.path.basename, (*lib.sources, *lib.deps))}
        assert built_from, f"{f} is built into no declared library"
        assert set(native.invalidate(path)) == built_from
        assert {lib.name for lib in native.LIBRARIES.values() if lib._lib is None} == built_from
        if f == "traverse_common.cuh":
            assert built_from == {traversal.WIDE.name, traversal.Q32.name, traversal.DRAIN.name,
                                  traversal.BINARY.name, traversal.LQ.name, traversal.MULTI.name,
                                  bvh_ops.SEED.name}

    monkeypatch.setattr(native, "LIBRARIES", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    cmd = ["g++", "-x", "c", "-O1", "-shared", "-fPIC"]
    files = {"shared.h": "#define BASE {v}\n",
             "a.c": '#include "shared.h"\nint version(void) {{ return BASE + {v}; }}\n',
             "b.c": '#include "shared.h"\nint version(void) {{ return 2 * BASE + {v}; }}\n',
             "c.c": "int version(void) {{ return {v}; }}\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text.format(v=10))
    libs = {name: native.declare(f"hot_{name[0]}", [str(tmp_path / name)], {"version": []},
                                 deps=(str(tmp_path / "shared.h"),) if name != "c.c" else (),
                                 command=cmd)
            for name in ("a.c", "b.c", "c.c")}
    built_from = {"shared.h": {"a.c", "b.c"}, "a.c": {"a.c"}, "b.c": {"b.c"}, "c.c": {"c.c"}}
    for v, (edited, want) in enumerate(built_from.items(), start=20):
        handles = {name: lib.library() for name, lib in libs.items()}
        versions = {name: h.version() for name, h in handles.items()}
        (tmp_path / edited).write_text(files[edited].format(v=v))
        assert set(native.invalidate(str(tmp_path / edited))) == {libs[n].name for n in want}
        for name, lib in libs.items():
            if name in want:
                assert lib.library() is not handles[name]
                assert lib.library().version() != versions[name], (edited, name)
            else:
                assert lib.library() is handles[name]


def test_profiler_scopes_and_report_match_jax(tmp_path):
    prof = Profiler()
    with prof.scope("outer"):
        with prof.scope("inner"):
            pass
        with prof.scope("inner"):
            pass
    assert {k: v[0] for k, v in prof.totals().items()} == {"outer": 1, "inner": 2}
    prof.toggle()
    with prof.scope("off"):
        pass
    prof.toggle()
    assert set(prof.totals()) == {"outer", "inner"}
    # The same totals print the same report as the JAX profiler's.
    jprof = JaxProfiler()
    for p in (prof, jprof):
        p._totals.clear()
        p._counts.clear()
        p._totals.update({"frame": 0.5, "render": 0.25, "build_graph": 0.001})
        p._counts.update({"frame": 4, "render": 4, "build_graph": 4})
    assert prof.report() == jprof.report()
    assert prof.report().splitlines()[1].startswith("frame")
    prof.new_frame()  # reads the device spans that have run: none on the CPU
    assert prof.device_totals() == {}
    prof.reset()
    assert prof.report() == jprof.report().splitlines()[0]
    with prof.trace(str(tmp_path / "trace")):
        with prof.scope("traced"):
            torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").read_text().count("traced") >= 1


# -- the application -----------------------------------------------------------------


@pytest.mark.parametrize("mode,scene", [("pt", "default"), ("raster", "cubes"),
                                        ("minimal", "cubes")])
def test_main_writes_the_frame_jax_main_writes(mode, scene, tmp_path, monkeypatch, jax_leaf12,
                                               pinned_clock, capsys):
    """`main()` by its command line with --device cpu --small --frames 2 at
    64x64 against the JAX package's `main()` with the same flags: the saved
    images within the slice's tolerance; the report and fps lines printed.
    The rasterized modes draw the cube scene: the JAX package rasterizes
    its shadow cascades on the CPU by brute force, over every triangle."""
    outs = {}
    for name, module, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.png")
        monkeypatch.setattr(sys, "argv", ["main", "--width", "64", "--height", "64",
                                          "--frames", "2", "--small", "--mode", mode,
                                          "--scene", scene, "--out", out, *extra])
        assert module.main() == 0
        outs[name] = image_io.read_image(out)
    printed = capsys.readouterr().out
    assert printed.count("scope") == 2 and printed.count("fps=") == 2
    assert "render" in printed and f"saved={tmp_path / 'port.png'}" in printed
    assert outs["port"].shape == outs["jax"].shape == (64, 64, 3)
    _close(outs["port"] / 255.0, outs["jax"] / 255.0)
    assert outs["port"].std() > 5


def test_main_defaults_to_the_gpu(tmp_path, monkeypatch):
    """Without --device the app asks for the GPU; with no GPU it raises
    rather than render on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setattr(sys, "argv", ["main", "--width", "8", "--height", "8", "--frames",
                                      "1", "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no GPU"):
        port_main.main()
    assert not (tmp_path / "x.png").exists()


def test_run_present_every_returns_the_same_frame(pinned_clock):
    """present_every=3 presents frames 3 and 5 of 5 (the copy to the host at
    the third frame and after the last) and returns what present_every=1
    returns; on_frame sees each presented frame."""
    results = {}
    for every in (1, 3):
        _, app = _apps()
        presented, calls = [], []
        present = app.present
        app.present = lambda img: calls.append(1) or present(img)
        results[every] = app.run(5, on_frame=lambda i, img: presented.append(i),
                                 present_every=every)
        assert presented == ([0, 1, 2, 3, 4] if every == 1 else [2])
        assert len(calls) == (5 if every == 1 else 2)
    np.testing.assert_array_equal(results[3], results[1])
    assert results[1].shape == (H, W, 3)


def test_hotkeys_switch_mode_and_reset_accumulation(pinned_clock):
    """1/2/3/4 switch the mode and reset the accumulation, q toggles the
    profiler, as in the JAX package; the next frame renders the new mode."""
    jax_app, app = _apps()
    app.run(2)
    jax_app.total_samples = app.total_samples
    enabled = PROFILER.enabled
    try:
        for key in ("3", "3", "q", "4", "1", "q"):
            for a in (jax_app, app):
                a.input.begin_frame()
                a.input.set_key_down(key)
                a._handle_hotkeys()
                a.input.set_key_up(key)
            assert app.render_graph_mode.name == jax_app.render_graph_mode.name
            assert app.total_samples == jax_app.total_samples
        assert PROFILER.enabled == enabled
    finally:
        PROFILER.enabled = enabled
    app.total_samples = 5
    app.input.begin_frame()
    app.input.set_key_down("4")
    res = app.render_frame()
    assert app.render_graph_mode == RenderGraphMode.MINIMAL and app.total_samples == 1
    assert "forward_output" in res and res["present_output"].shape == (H, W, 3)


def test_camera_move_and_setting_change_reset(pinned_clock):
    _, app = _apps()
    app.run(3)
    assert app.total_samples == 3
    app.input.set_key_down("w")
    app.render_frame()
    assert app.total_samples == 1  # the camera moved
    app.input.set_key_up("w")
    app.run(1)
    assert app.total_samples == 2
    app.view = Ui.toggle_flag(app.view, "lights_enabled")
    app.run(1)
    assert app.total_samples == 1


def test_set_instance_transform_then_a_frame_matches_jax(jax_leaf12):
    """A frame, the first cube moved (repack, BVH rebuild, accumulation
    reset), a frame: the port's against the JAX package's."""
    jax_app, app = _apps()
    for a in (jax_app, app):
        a.fps_timer.elapsed_seconds = lambda: CLOCK
        a.run(1)
    move = math3d.translation([0.7, 0.4, -0.3]) @ math3d.scale(0.8)
    old_scene, old_bvh = app.scene, app.scene_bvh
    jax_app.set_instance_transform(0, move)
    # The JAX graph keys its compiled frame by each pass's name, so its
    # frame program keeps the first frame's closures, the old BVH among
    # them: recompile() makes it trace the passes that read the new one.
    jax_app.graph.recompile()
    app.set_instance_transform(0, move)
    assert app.total_samples == jax_app.total_samples == 0
    assert app.scene is not old_scene and app.scene_bvh is not old_bvh
    np.testing.assert_array_equal(app.scene.positions.numpy(),
                                  np.asarray(jax_app.scene.positions))
    got, want = app.run(1), np.asarray(jax_app.run(1))
    _close(got, want)
    assert app.total_samples == jax_app.total_samples == 1


# -- the viewer ------------------------------------------------------------------------


def test_frame_to_ansi_matches_jax():
    img = np.random.default_rng(3).uniform(-0.1, 1.1, (64, 48, 3)).astype(np.float32)
    for cols, rows in ((20, 10), (48, 32), (7, 3)):
        assert viewer.frame_to_ansi(img, cols, rows) == jax_viewer.frame_to_ansi(img, cols, rows)
    assert viewer.TOGGLE_KEYS == jax_viewer.TOGGLE_KEYS
    assert viewer.GIZMO_KEYS == jax_viewer.GIZMO_KEYS


def test_handle_gizmo_matches_jax():
    """TAB selects an instance, shifted IJKL/UO move it (repack, BVH
    rebuild, accumulation reset), as the JAX viewer does; the HUD text
    agrees."""
    jax_app = jax_main.Application(W, H, JaxMode.MINIMAL, JaxStaticConfig(**SMALL))
    app = Application(W, H, RenderGraphMode.MINIMAL, StaticConfig(**SMALL), device="cpu")
    jax_app.create_scene(jax_cornell)
    app.create_scene(create_cornell_box_scene)
    states = ({}, {})
    for keys in (["shift+l"], ["tab"], ["shift+l"], ["shift+u", "shift+i"], ["tab"],
                 ["shift+o"]):
        for a, state in zip((jax_app, app), states):
            a.total_samples = 7
            a.input.begin_frame()
            for k in keys:
                a.input.set_key_down(k)
            (jax_viewer if a is jax_app else viewer)._handle_gizmo(a, state)
            for k in keys:
                a.input.set_key_up(k)
        assert states[0] == states[1]
        assert app.total_samples == jax_app.total_samples
        assert app.ui.state.gizmo_instance == jax_app.ui.state.gizmo_instance
        for got, want in zip(app.renderer.instances, jax_app.renderer.instances):
            np.testing.assert_array_equal(got.transform, want.transform)
        np.testing.assert_array_equal(app.scene.positions.numpy(),
                                      np.asarray(jax_app.scene.positions))
    assert states[1]["gizmo"] == 0 and app.total_samples == 0
    assert viewer._hud(app) == jax_viewer._hud(jax_app)

"""The port's graph debug surface against the JAX package's: the sanitizer
(`Graph(sanitize=True)`, the validation-layer analog) in `render` and in
`render_loop`, and hot reload (`recompile_shader`, the keep-last-good
fallback, a reloaded pass capturing anew, a rebuilt native library).

The sanitizer must report what the JAX graph reports on the same graphs:
the same "pass/resource" keys and non-finite counts (tests/test_debug_tools.py
and tests/test_render_loop.py's graphs), the loop's counts summed over its
frames, `suppress` muting the log and not the report. A clean PT frame and
config 5's loop (the marching-cubes refit tables, which hold bit-cast int32
ids, exempt) report nothing. The CUDA-graph capture of the counts runs only
on the card (tests/test_torch_cuda.py).
"""

import logging
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_renderer_tpu as jax_rt
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.graph import Graph, _value_key
from rust_renderer_tpu_torch.ops import mc_bvh
from rust_renderer_tpu_torch.scene import ModelLoader
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import math3d

torch.set_num_threads(1)

W = H = 32
CFG = StaticConfig(width=W, height=H, shadow_map_size=64, cubemap_size=16, cubemap_mips=2,
                   irradiance_size=8, brdf_lut_size=16, num_bounces=2)


def _tiny_scene(r, cam):
    """tests/test_render_loop.py::_tiny_scene."""
    r.add_model(ModelLoader.load_cube(), math3d.translation([0, 0.5, 0]))
    r.add_model(ModelLoader.load_cube(), math3d.scale([20.0, 0.1, 20.0]))
    r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
    r.add_light([-2.0, 2.0, -1.0], [1.0, 0.5, 0.2], 0.7)
    cam.set_position_target([3, 2, 5], [0, 0.5, 0])


def _poisoned(package):
    """The graphs of tests/test_debug_tools.py::
    test_sanitizer_reports_nonfinite_pass_output in either package, plus an
    undeclared float output and an int output: (poisoned graph, clean graph)."""
    if package == "jax":
        g, clean = jax_rt.Graph(sanitize=True), jax_rt.Graph(sanitize=True)
        nan = lambda shape: jnp.full(shape, jnp.nan)
        zeros, ints = jnp.zeros, lambda shape: jnp.full(shape, -1, jnp.int32)
        wrap = lambda fn: lambda res, s, v, u: fn()
    else:
        g, clean = Graph(device="cpu", sanitize=True), Graph(device="cpu", sanitize=True)
        nan = lambda shape: torch.full(shape, float("nan"))
        zeros, ints = torch.zeros, lambda shape: torch.full(shape, -1, dtype=torch.int32)
        wrap = lambda fn: lambda res, s, v: fn()

    def poison():
        inf = zeros((4,)) + 1.0 / zeros((4,))[0]
        return {"bad": nan((8, 8)), "undeclared": inf, "ids": ints((3,))}

    g.create_texture("bad", 8, 8, 1)
    (g.add_pass("poison").write("bad").write("undeclared").write("ids")
     .render(wrap(poison)).build())
    clean.create_texture("ok", 8, 8, 1)
    clean.add_pass("clean").write("ok").render(wrap(lambda: {"ok": zeros((8, 8))})).build()
    return g, clean


def test_render_report_matches_jax():
    reports = {}
    for package in ("jax", "torch"):
        g, clean = _poisoned(package)
        view = JaxRenderSettings.default() if package == "jax" else RenderSettings.default()
        g.render(None, view)
        clean.render(None, view)
        reports[package] = (g.last_sanitizer_report, clean.last_sanitizer_report)
    assert reports["torch"] == reports["jax"]
    assert reports["torch"] == ({"poison/bad": 64, "poison/undeclared": 4}, {})


def test_exempt_resource_and_suppress(caplog):
    """sanitize=False on a descriptor exempts its resource; `suppress` mutes
    a pass's log lines and keeps its counts in the report."""
    reports, logged = {}, {}
    for package in ("jax", "torch"):
        g = (jax_rt.Graph(sanitize=True, suppress=("quiet",)) if package == "jax"
             else Graph(device="cpu", sanitize=True, suppress=("quiet",)))
        nan = (lambda: jnp.full((2, 2), jnp.nan)) if package == "jax" else (
            lambda: torch.full((2, 2), float("nan")))
        wrap = ((lambda fn: lambda res, s, v, u: fn()) if package == "jax"
                else (lambda fn: lambda res, s, v: fn()))
        g.create_buffer("exempt", (2, 2), sanitize=False)
        g.create_buffer("muted", (2, 2))
        g.create_buffer("loud", (2, 2))
        g.add_pass("quiet").write("exempt").write("muted").render(
            wrap(lambda: {"exempt": nan(), "muted": nan()})).build()
        g.add_pass("noisy").write("loud").render(wrap(lambda: {"loud": nan()})).build()
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            g.render(None, JaxRenderSettings.default() if package == "jax"
                     else RenderSettings.default())
        reports[package] = g.last_sanitizer_report
        logged[package] = sorted(r.getMessage() for r in caplog.records
                                 if "sanitizer" in r.getMessage())
    assert reports["torch"] == reports["jax"] == {"quiet/muted": 4, "noisy/loud": 4}
    assert logged["torch"] == logged["jax"] == [
        "sanitizer: noisy/loud produced 4 non-finite values"]


def _loop_graph(package, prefix: bool):
    """tests/test_render_loop.py::test_loop_sanitize_counts_nonfinite's graph;
    with `prefix`, an isolated prefix pass that writes one NaN a frame too."""
    if package == "jax":
        g = jax_rt.Graph(sanitize=True)

        def bad(res, scene, view, u):
            img = jnp.zeros((8, 8, 3), jnp.float32).at[0, 0, 0].set(jnp.nan)
            return {"present_output": img, "aux": jnp.zeros((8, 8), jnp.float32)}

        def pre(res, scene, view, u):
            return {"table": jnp.zeros((4,), jnp.float32).at[1].set(jnp.inf)}
    else:
        g = Graph(device="cpu", sanitize=True)

        def bad(res, scene, view):
            img = torch.zeros((8, 8, 3))
            img[0, 0, 0] = float("nan")
            return {"present_output": img, "aux": torch.zeros((8, 8))}

        def pre(res, scene, view):
            t = torch.zeros(4)
            t[1] = float("inf")
            return {"table": t}

    g.create_texture("present_output", 8, 8, 3)
    g.create_texture("aux", 8, 8, 1)
    g.new_frame()
    g.clear()
    if prefix:
        g.create_buffer("table", (4,))
        g.add_pass("pre").write("table").render(pre).isolate().build()
    builder = g.add_pass("bad").write("present_output").write("aux")
    if prefix:
        builder.read("table")
    builder.render(bad).build()
    return g


@pytest.mark.parametrize("prefix", [False, True])
def test_loop_counts_summed_like_jax(prefix):
    reports = {}
    for package in ("jax", "torch"):
        g = _loop_graph(package, prefix)
        view = JaxRenderSettings.default() if package == "jax" else RenderSettings.default()
        g.render_loop(None, view, 3)
        reports[package] = g.last_sanitizer_report
    want = {"bad/present_output": 3, **({"pre/table": 3} if prefix else {})}
    assert reports["torch"] == reports["jax"] == want


def test_loop_counts_restart_each_call():
    g = _loop_graph("torch", prefix=False)
    g.render_loop(None, RenderSettings.default(), 3)
    g.render_loop(None, RenderSettings.default(), 2)
    assert g.last_sanitizer_report == {"bad/present_output": 2}


def _app(**kw) -> Application:
    app = Application(W, H, RenderGraphMode.PATH_TRACED, kw.pop("cfg", CFG), device="cpu",
                      **kw)
    app.create_scene(_tiny_scene)
    app.fps_timer.elapsed_seconds = lambda: 0.0
    return app


def test_clean_pt_frames_report_nothing():
    """A clean scene through `run` and `run_on_device` with sanitize on
    (tests/test_render_loop.py::test_loop_sanitize_app_clean), and the
    frames equal to the sanitizer's off."""
    app, plain = _app(sanitize=True), _app()
    np.testing.assert_array_equal(app.run(2), plain.run(2))
    assert app.graph.last_sanitizer_report == {}
    img = app.run_on_device(2, tstep=0.0)
    assert app.graph.last_loop_form.startswith("eager")
    assert app.graph.last_sanitizer_report == {}
    torch.testing.assert_close(img, plain.run_on_device(2, tstep=0.0), rtol=0, atol=0)


def test_config5_loop_clean_with_exempt_tables():
    """Config 5's loop with sanitize on reports nothing
    (tests/test_render_loop.py::test_mc_loop_sanitize_clean): the refit
    tables mc_wnode, mc_node and mc_leaf are exempt, mc_tri_normals is not;
    their bit-cast ids would report non-finite values otherwise."""
    app = _app(sanitize=True, cfg=CFG.replace(mc_grid=8))
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    img = app.run_on_device(2, tstep=0.0)
    assert torch.isfinite(img).all()
    assert app.graph.last_sanitizer_report == {}
    exempt = {n for n, d in app.graph.descs.items() if not d.sanitize}
    assert exempt == {"mc_wnode", "mc_node", "mc_leaf"}
    assert set(mc_bvh.table_shapes(8)) == exempt | {"mc_tri_normals"}
    tables = app.graph.render(app.scene, app.view)
    assert sum(int((~torch.isfinite(tables[n])).sum()) for n in exempt) > 0


# -- hot reload ---------------------------------------------------------------


def _write_module(tmp_path, body: str):
    (tmp_path / "hot_pass_mod.py").write_text(body)


@pytest.fixture
def hot_module(tmp_path, monkeypatch):
    """A module on sys.path holding a pass body, reloadable by name (no
    bytecode cache, so each reload reads the source as it stands)."""
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    _write_module(tmp_path, "import torch\n\ndef body(res, scene, view):\n"
                            "    return {'out': torch.ones(2)}\n")
    sys.modules.pop("hot_pass_mod", None)
    import hot_pass_mod

    yield tmp_path, hot_pass_mod
    sys.modules.pop("hot_pass_mod", None)


def _record(g, mod):
    g.new_frame()
    g.clear()
    g.create_buffer("out", (2,))
    g.add_pass("hot").write("out").render(mod.body).build()


def test_recompile_shader_reloads_and_keeps_last_good(hot_module, caplog):
    """A reload takes effect on the next frame; a pass broken by a reload
    falls back to its function of the last good frame and logs it; a pass
    that fails with no reload since its last good frame raises."""
    tmp_path, mod = hot_module
    g = Graph(device="cpu")
    _record(g, mod)
    assert g.render(None, RenderSettings.default())["out"].tolist() == [1.0, 1.0]
    _write_module(tmp_path, "import torch\n\ndef body(res, scene, view):\n"
                            "    return {'out': torch.full((2,), 2.0)}\n")
    assert g.recompile_shader("hot_pass_mod")
    _record(g, mod)
    assert g.render(None, RenderSettings.default())["out"].tolist() == [2.0, 2.0]
    _write_module(tmp_path, "def body(res, scene, view):\n    raise RuntimeError('bad')\n")
    assert g.recompile_shader("hot_pass_mod")
    _record(g, mod)
    with caplog.at_level(logging.ERROR):
        out = g.render(None, RenderSettings.default())["out"]
    assert out.tolist() == [2.0, 2.0]
    assert any("failed after a hot reload" in r.getMessage() for r in caplog.records)
    g2 = Graph(device="cpu")
    _record(g2, mod)
    with pytest.raises(RuntimeError, match="bad"):
        g2.render(None, RenderSettings.default())
    assert not g.recompile_shader("no_such_module_loaded")


def test_failed_reload_keeps_the_old_module(hot_module):
    tmp_path, mod = hot_module
    g = Graph(device="cpu")
    _write_module(tmp_path, "def body(:\n")
    assert not g.recompile_shader("hot_pass_mod")
    assert g._generation == 0
    _record(g, mod)
    assert g.render(None, RenderSettings.default())["out"].tolist() == [1.0, 1.0]


def test_reloaded_pass_changes_the_capture_key(hot_module):
    """The captured loop's key holds each pass's function by its code, so a
    reloaded pass captures anew; `recompile` also drops the captured loop."""
    tmp_path, mod = hot_module
    before = _value_key(mod.body)
    _write_module(tmp_path, "import torch\n\ndef body(res, scene, view):\n"
                            "    return {'out': torch.full((2,), 3.0)}\n")
    g = Graph(device="cpu")
    g._loop = object()
    assert g.recompile_shader("hot_pass_mod")
    assert g._loop is None and g._generation == 1
    assert _value_key(mod.body) != before


def _in_subprocess(code: str) -> None:
    """Run `code` in a fresh interpreter (a reload of the port's modules
    would leave this process's tests with two versions of their classes);
    it must print ok."""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_recompile_all_shaders_reloads_the_ops():
    _in_subprocess(
        "from rust_renderer_tpu_torch.graph import Graph; "
        "from rust_renderer_tpu_torch.ops import colors; "
        "from rust_renderer_tpu_torch.renderers import passes; "
        "old, old_pass = colors.linear_to_srgb, passes.setup_ssao_pass; g = Graph(device='cpu'); "
        "g.recompile_all_shaders(); "
        "assert colors.linear_to_srgb is not old and passes.setup_ssao_pass is not old_pass; "
        "assert g._generation == 1; print('ok')")


def test_declared_deps_are_the_included_headers():
    """Each declared library's `deps` (hashed into its file's name, and the
    headers whose edit drops its binding) are exactly the headers its
    sources include by `#include "..."`."""
    from rust_renderer_tpu_torch.ops import atmosphere, bvh, deferred, raster_binned, traversal

    assert {traversal.WIDE, bvh.SEED, atmosphere.SKY, deferred.SHADE,
            raster_binned.RASTER} <= set(native.LIBRARIES.values())
    for lib in native.LIBRARIES.values():
        included = set()
        for src in lib.sources:
            with open(src, encoding="utf-8") as f:
                included |= {os.path.realpath(os.path.join(os.path.dirname(src), h))
                             for h in re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read(),
                                                 re.M)}
        assert {os.path.realpath(d) for d in lib.deps} == included, lib.name


def test_native_library_reloads_a_changed_source(tmp_path, monkeypatch):
    """A changed source builds a library of another name, so loading it
    again runs the new code (the dynamic loader would return the old handle
    for the old path); an unchanged one loads the same handle. Built with
    g++ here; tests/test_torch_cuda.py does the same with nvcc on the card."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "version.c"
    cmd = ["g++", "-x", "c", "-O1", "-shared", "-fPIC"]
    libs = []
    for version in (1, 2):
        src.write_text(f"int version(void) {{ return {version}; }}\n")
        libs.append(native.load_library("hot_version", [str(src)], cmd))
        assert libs[-1].version() == version
    assert native.load_library("hot_version", [str(src)], cmd) is libs[1]
    assert (tmp_path / "build" / "libhot_version.so.log").exists()
    assert len(list((tmp_path / "build").glob("libhot_version-*.so"))) == 2


def test_traversal_reload_rebinds_its_library(monkeypatch):
    """An edited CUDA source that the app's watcher reports goes through
    `Application._check_hot_reload` to `native.invalidate`: the libraries
    built from it (K1's and K3 wide's for traverse_wide.cu; the traversal
    and seed libraries for traverse_common.cuh) lose their binding, so their
    next launch builds and loads the sources as they stand; the others keep
    theirs; the graph drops its captured loop."""
    from rust_renderer_tpu_torch.ops import bvh, traversal

    app = Application(8, 8, RenderGraphMode.PATH_TRACED, device="cpu")
    traversing = {traversal.WIDE, traversal.Q32, traversal.DRAIN, traversal.BINARY,
                  traversal.LQ, traversal.MULTI}
    for f, want in (("traverse_wide.cu", {traversal.WIDE}),
                    ("traverse_common.cuh", traversing | {bvh.SEED})):
        for lib in native.LIBRARIES.values():
            monkeypatch.setattr(lib, "_lib", object())
        app.graph._loop = object()
        generation = app.graph._generation
        path = os.path.join(app.watcher.root, "csrc", f)
        monkeypatch.setattr(app.watcher, "check_if_modification", lambda: path)
        app._check_hot_reload()
        assert {lib for lib in native.LIBRARIES.values() if lib._lib is None} == want
        assert app.graph._loop is None and app.graph._generation == generation + 1

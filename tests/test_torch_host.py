"""The PyTorch port's host side against the JAX package: scene packing, the
BVH tables, the frame graph's resource rules, and the port's independence
from jax.

BVH tables must be bit-identical (same native SAH build, same collapse), and
so must every packed scene field.

The JAX package's loader (rust_renderer_tpu/native/__init__.py) compiles
libbvh_builder.so in place and latches any load failure for the life of the
process, after which its build_bvh silently takes the numpy Morton builder.
Test workers that start together on a fresh checkout all compile that file
at once, and one that loads it while another is still writing it fails with
"file too short". The `jax_sah` fixture clears such a latched failure and
loads again once the builds have settled, so that the tables are always
compared against the JAX package's SAH build.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu import native as jax_native
from rust_renderer_tpu.models import create_scene as jax_create_scene
from rust_renderer_tpu.ops import bvh as jax_bvh

from rust_renderer_tpu_torch import Camera, Graph, Renderer
from rust_renderer_tpu_torch.convert import packed_scene_from_numpy
from rust_renderer_tpu_torch.models import create_scene
from rust_renderer_tpu_torch.ops import bvh as torch_bvh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(n=150, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(-1, 3)
    return pos, np.arange(n * 3, dtype=np.int32).reshape(-1, 3)


@pytest.fixture(scope="module")
def default_scenes():
    jr = JaxRenderer()
    jax_create_scene(jr, JaxCamera([0, 0, 0], [0, 0, -1]))
    jr.ensure_mc_material()
    tr = Renderer()
    create_scene(tr, Camera([0, 0, 0], [0, 0, -1]))
    tr.ensure_mc_material()
    return jr.pack(), tr.pack_numpy()


def test_default_scene_pack_matches_jax(default_scenes):
    jax_scene, port = default_scenes
    for f in dataclasses.fields(jax_scene):
        want = np.asarray(getattr(jax_scene, f.name))
        got = port[f.name]
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    # The tensors of Renderer.pack carry the same values.
    scene = packed_scene_from_numpy(port, "cpu")
    np.testing.assert_array_equal(scene.textures.numpy(), port["textures"])
    assert scene.num_triangles == jax_scene.num_triangles


def test_spheres_and_materials_pack_like_jax():
    from rust_renderer_tpu.scene import Material as JaxMaterial
    from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
    from rust_renderer_tpu_torch.scene import Material, ModelLoader

    jr, tr = JaxRenderer(), Renderer()
    for r, loader, material in ((jr, JaxModelLoader, JaxMaterial),
                                (tr, ModelLoader, Material)):
        r.add_model(loader.load_cube(), np.diag([2.0, 1.0, 3.0, 1.0]).astype(np.float32))
        r.add_sphere([0.0, 1.0, -2.0], 0.5, material=material(material_type=2,
                                                              material_property=1.5))
        r.add_sphere([1.0, 0.0, -3.0], 0.25, material_index=0)
        r.add_light([0.0, 3.0, 0.0], [1.0, 0.5, 0.25])
        r.ensure_mc_material()
    jax_scene, port = jr.pack(), tr.pack_numpy()
    for f in dataclasses.fields(jax_scene):
        np.testing.assert_array_equal(port[f.name], np.asarray(getattr(jax_scene, f.name)),
                                      err_msg=f.name)


def ensure_jax_native_sah(loader=jax_native, attempts: int = 60, wait: float = 1.0):
    """Load the JAX package's native SAH builder, clearing a latched load
    failure and retrying while concurrent builds of the library finish;
    fail, naming the cause, if it never loads."""
    for _ in range(attempts):
        if loader.have_native():
            return
        loader._lib_failed = False
        time.sleep(wait)
    pytest.fail("the JAX package fell back to its numpy BVH builder: its native "
                "libbvh_builder.so did not load, so its tables are not the SAH "
                "tables the port builds")


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


@pytest.mark.parametrize("recoverable", [True, False])
def test_jax_sah_fixture_recovers_a_latched_failure_or_names_it(recoverable, monkeypatch):
    ensure_jax_native_sah()
    # The state a worker is left in after loading a half-written library.
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", True)
    if recoverable:
        ensure_jax_native_sah(attempts=2, wait=0.0)
        assert jax_native.have_native() and not jax_native._lib_failed
    else:
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        with pytest.raises(pytest.fail.Exception, match="fell back to its numpy"):
            ensure_jax_native_sah(attempts=2, wait=0.0)


def _assert_tables_equal(jax_tree, port: dict):
    for name in ("node_packed", "leaf_packed", "wnode_packed"):
        want = np.asarray(getattr(jax_tree, name))
        got = port[name]
        assert got.shape == want.shape, name
        # Compare bit patterns: the tables carry int32 ids in float columns.
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
    assert port["max_depth"] == jax_tree.max_depth
    assert port["wide_depth"] == jax_tree.wide_depth


@pytest.mark.parametrize("seed", [0, 3])
def test_bvh_tables_match_jax_on_soup(seed, jax_sah):
    pos, idx = _soup(seed=seed)
    _assert_tables_equal(jax_bvh.build_bvh(pos, idx, leaf_size=12),
                         torch_bvh.build_bvh_numpy(pos, idx))


def test_bvh_tables_match_jax_on_default_scene(default_scenes, jax_sah):
    jax_scene, port = default_scenes
    jax_tree = jax_bvh.build_bvh(np.asarray(jax_scene.positions),
                                 np.asarray(jax_scene.indices), leaf_size=12)
    tables = torch_bvh.build_bvh_numpy(port["positions"], port["indices"])
    _assert_tables_equal(jax_tree, tables)
    # The gizmo sphere parked at FLT_MAX is left out of the tree.
    ids = tables["leaf_packed"][:, 108:].view(np.int32)
    far = np.abs(port["positions"][port["indices"]]).max(axis=(1, 2)) >= 1e30
    assert far.sum() > 0
    assert not np.isin(np.nonzero(far)[0], ids).any()


def test_empty_bvh_has_one_empty_leaf():
    tables = torch_bvh.build_bvh_numpy(np.zeros((0, 3), np.float32),
                                       np.zeros((0, 3), np.int32))
    jax_tree = jax_bvh.build_bvh(np.zeros((0, 3), np.float32),
                                 np.zeros((0, 3), np.int32), leaf_size=12)
    _assert_tables_equal(jax_tree, tables)


def _graph_with_pass(fn, reads=("a",), writes=("b",)):
    g = Graph(device="cpu")
    g.create_buffer("a", (2,), clear=3.0)
    g.create_buffer("b", (2,))
    g.create_buffer("c", (2,), persistent=True)
    pb = g.add_pass("p")
    for r in reads:
        pb.read(r)
    for w in writes:
        pb.write(w)
    pb.render(fn).build()
    return g


def test_graph_reads_clear_values_and_keeps_persistent_state():
    g = _graph_with_pass(lambda res, s, v: {"b": res["a"] + 1, "c": res["a"]},
                         writes=("b", "c"))
    out = g.render(None, None)
    np.testing.assert_array_equal(out["b"].numpy(), [4.0, 4.0])
    np.testing.assert_array_equal(g.state["c"].numpy(), [3.0, 3.0])


@pytest.mark.parametrize("name", ["c", "nowhere"])
def test_graph_undeclared_read_raises_naming_it(name):
    g = _graph_with_pass(lambda res, s, v: {"b": res[name]})
    with pytest.raises(ValueError, match=f"'{name}'"):
        g.render(None, None)


def test_graph_undeclared_write_raises_naming_it():
    g = _graph_with_pass(lambda res, s, v: {"c": res["a"]})
    with pytest.raises(ValueError, match="'c'"):
        g.render(None, None)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.modules['jax'] = None; "
            "import rust_renderer_tpu_torch.app.main; "
            "import rust_renderer_tpu_torch.convert, rust_renderer_tpu_torch.parallel; "
            "from rust_renderer_tpu_torch.ops import (raster, raster_binned, shadow, brdf, "
            "cubemap, ibl, pbr, ssao, fxaa, noise, marching_cubes, mc_bvh, intersect, "
            "gbuffer, colors, restir, constants); "
            "import rust_renderer_tpu_torch.renderers.passes; "
            "import rust_renderer_tpu_torch.app.viewer, rust_renderer_tpu_torch.app.ui, "
            "rust_renderer_tpu_torch.input, rust_renderer_tpu_torch.scene.gltf_loader; "
            "from rust_renderer_tpu_torch.utils import hud, image_io, profiler, watcher; "
            "assert 'rust_renderer_tpu' not in sys.modules, 'JAX package imported'; "
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert jax is not None  # this process keeps its own jax

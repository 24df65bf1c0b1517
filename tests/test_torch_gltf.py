"""The port's glTF loader (`scene/gltf_loader.py`) against the JAX package's.

The test writes its own glTF documents: two meshes under a matrix node (with
a child) and TRS nodes; one buffer in a .bin file and one in a data: URI;
an interleaved (strided) accessor pair, a sparse accessor over a buffer
view and one over zeros, a normalized uint8 colour accessor; materials with
texture references; a PNG texture in a data: URI and one in a buffer view.
`load_gltf` must give what the JAX package's gives, field for field and bit
for bit, with PIL and without it (1x1 white images). The scene builders take
the sphere asset from RUST_RENDERER_TPU_ASSETS (`_find_asset`) and must pack
the tables the JAX package packs.
"""

import base64
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
from PIL import Image

import rust_renderer_tpu as jax_rt
from rust_renderer_tpu.models import scenes as jax_scenes
from rust_renderer_tpu.scene import load_gltf as jax_load_gltf

import rust_renderer_tpu_torch as torch_rt
from rust_renderer_tpu_torch import models as torch_models
from rust_renderer_tpu_torch.scene import ModelLoader, load_gltf

FLOAT, UBYTE, USHORT = 5126, 5121, 5123


def _png(rgb, size=(3, 2)) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", size, rgb).save(buf, "PNG")
    return buf.getvalue()


def _uri(data: bytes, mime="application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _write_rich_gltf(folder) -> str:
    """The document the module docstring describes; returns its path."""
    rng = np.random.default_rng(7)
    # Buffer 0 (scene.bin): mesh A's interleaved positions + normals
    # (stride 24), its uint16 indices, then a PNG texture.
    pos_a = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    nrm_a = rng.normal(size=(4, 3)).astype(np.float32)
    interleaved = np.concatenate([pos_a, nrm_a], 1).tobytes()
    idx_a = np.array([0, 1, 2, 2, 3, 0], np.uint16).tobytes()
    png_bv = _png((10, 200, 30))
    bin0 = interleaved + idx_a + b"\0\0" + png_bv
    (folder / "scene.bin").write_bytes(bin0)
    # Buffer 1 (data: URI): mesh B's positions, sparse indices and values,
    # normalized colours, mesh A's uvs.
    pos_b = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    sparse_idx = np.array([0, 2], np.uint16)
    sparse_val = rng.uniform(5, 6, (2, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (3, 4)).astype(np.uint8)
    uvs = rng.uniform(0, 1, (4, 2)).astype(np.float32)
    tan_idx = np.array([1], np.uint16)
    tan_val = np.array([[0.0, 1.0, 0.0, -1.0]], np.float32)
    parts = [pos_b.tobytes(), sparse_idx.tobytes(), sparse_val.tobytes(), colors.tobytes(),
             uvs.tobytes(), tan_idx.tobytes() + b"\0\0", tan_val.tobytes()]
    offsets = np.cumsum([0] + [len(p) for p in parts])
    bin1 = b"".join(parts)

    def bv(buffer, offset, length, stride=None):
        view = {"buffer": buffer, "byteOffset": int(offset), "byteLength": int(length)}
        if stride:
            view["byteStride"] = stride
        return view

    views = [bv(0, 0, len(interleaved), 24), bv(0, len(interleaved), 12),
             bv(0, len(interleaved) + 14, len(png_bv))]
    views += [bv(1, offsets[i], offsets[i + 1] - offsets[i]) for i in range(len(parts))]
    accessors = [
        {"bufferView": 0, "componentType": FLOAT, "count": 4, "type": "VEC3"},
        {"bufferView": 0, "byteOffset": 12, "componentType": FLOAT, "count": 4,
         "type": "VEC3"},
        {"bufferView": 1, "componentType": USHORT, "count": 6, "type": "SCALAR"},
        {"bufferView": 3, "componentType": FLOAT, "count": 3, "type": "VEC3",
         "sparse": {"count": 2, "indices": {"bufferView": 4, "componentType": USHORT},
                    "values": {"bufferView": 5}}},
        {"bufferView": 6, "componentType": UBYTE, "normalized": True, "count": 3,
         "type": "VEC4"},
        {"bufferView": 7, "componentType": FLOAT, "count": 4, "type": "VEC2"},
        {"componentType": FLOAT, "count": 3, "type": "VEC4",
         "sparse": {"count": 1, "indices": {"bufferView": 8, "componentType": USHORT},
                    "values": {"bufferView": 9}}},
    ]
    matrix = (np.array([[1, 0, 0, 2], [0, 0, -1, 1], [0, 1, 0, -3], [0, 0, 0, 1]],
                       np.float32).T.reshape(-1).tolist())
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"matrix": matrix, "children": [1], "mesh": 0},
            {"translation": [0.5, 0.0, 0.0], "rotation": [0.0, 0.38268343, 0.0, 0.9238795],
             "scale": [2.0, 1.0, 0.5], "mesh": 1},
            {"translation": [-1.0, 2.0, 0.0], "mesh": 0},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 5},
                             "indices": 2, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 3, "COLOR_0": 4, "TANGENT": 6},
                             "material": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicRoughnessTexture": {"index": 1},
                                      "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
                                      "metallicFactor": 0.25, "roughnessFactor": 0.75},
             "normalTexture": {"index": 1}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.1, 0.2, 0.3, 1.0]},
             "occlusionTexture": {"index": 0}},
        ],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": _uri(_png((250, 10, 10)), "image/png")},
                   {"bufferView": 2, "mimeType": "image/png"}],
        "buffers": [{"uri": "scene.bin", "byteLength": len(bin0)},
                    {"uri": _uri(bin1), "byteLength": len(bin1)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    path = folder / "scene.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def _assert_models_equal(got, want) -> None:
    assert len(got.meshes) == len(want.meshes)
    for g, w in zip(got.meshes, want.meshes):
        for f in dataclasses.fields(w.primitive):
            np.testing.assert_array_equal(getattr(g.primitive, f.name),
                                          getattr(w.primitive, f.name), err_msg=f.name)
            assert getattr(g.primitive, f.name).dtype == getattr(w.primitive, f.name).dtype
        for f in dataclasses.fields(w.material):
            np.testing.assert_array_equal(getattr(g.material, f.name),
                                          getattr(w.material, f.name), err_msg=f.name)
        assert g.gpu_mesh == w.gpu_mesh
    assert len(got.transforms) == len(want.transforms)
    for g, w in zip(got.transforms, want.transforms):
        np.testing.assert_array_equal(g, w)
    assert len(got.textures) == len(want.textures)
    for g, w in zip(got.textures, want.textures):
        np.testing.assert_array_equal(g, w)


def test_load_gltf_matches_jax(tmp_path):
    path = _write_rich_gltf(tmp_path)
    got, want = load_gltf(path), jax_load_gltf(path)
    _assert_models_equal(got, want)
    # What the document holds: three meshes (the matrix node's child first),
    # the sparse values in place, the colours normalized, two RGBA textures.
    assert len(got.meshes) == 3
    b = got.meshes[0].primitive
    assert (b.positions[[0, 2]] >= 5).all() and (b.positions[1] < 5).all()
    assert b.colors.max() <= 1.0 and b.colors.dtype == np.float32
    np.testing.assert_array_equal(b.tangents[1], [0.0, 1.0, 0.0, -1.0])
    assert not b.tangents[[0, 2]].any()
    np.testing.assert_array_equal(b.indices, [0, 1, 2])
    assert got.meshes[1].primitive.indices.tolist() == [0, 1, 2, 2, 3, 0]
    assert [t.shape for t in got.textures] == [(2, 3, 4), (2, 3, 4)]
    assert tuple(got.textures[1][0, 0]) == (10, 200, 30, 255)
    assert got.meshes[1].material.diffuse_map == 0
    assert got.meshes[1].material.normal_map == 1


def test_load_gltf_without_pil_matches_jax(tmp_path, monkeypatch):
    """Where PIL is missing, every image is a 1x1 opaque white one."""
    path = _write_rich_gltf(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got, want = load_gltf(path), jax_load_gltf(path)
    _assert_models_equal(got, want)
    assert all(t.shape == (1, 1, 4) and (t == 255).all() for t in got.textures)


def test_missing_texture_file_and_scene_list(tmp_path):
    """An image file that is not there gives the white 1x1 image; a document
    with no scenes loads empty; both as in the JAX package."""
    doc = {"images": [{"uri": "gone.png"}], "scenes": []}
    path = tmp_path / "empty.gltf"
    path.write_text(json.dumps(doc))
    got, want = load_gltf(str(path)), jax_load_gltf(str(path))
    _assert_models_equal(got, want)
    assert got.meshes == [] and got.textures[0].shape == (1, 1, 4)


def write_model_gltf(model, path, matrices=None) -> None:
    """A glTF of `model`'s meshes (positions, normals, uvs, indices and the
    material factors), one node each under `matrices` (else identity),
    its buffer in a .bin beside it."""
    blob, views, accessors, meshes, nodes, materials = b"", [], [], [], [], []
    for i, mesh in enumerate(model.meshes):
        prim = mesh.primitive
        attrs = {}
        for name, arr, kind in (("POSITION", prim.positions, "VEC3"),
                                ("NORMAL", prim.normals, "VEC3"),
                                ("TEXCOORD_0", prim.uvs, "VEC2"),
                                ("indices", prim.indices.astype(np.uint32), "SCALAR")):
            data = np.ascontiguousarray(arr).tobytes()
            views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5125 if name == "indices" else FLOAT,
                              "count": len(arr), "type": kind})
            attrs[name] = len(accessors) - 1
            blob += data
        m = mesh.material
        materials.append({"pbrMetallicRoughness": {
            "baseColorFactor": [float(x) for x in m.base_color_factor],
            "metallicFactor": float(m.metallic_factor),
            "roughnessFactor": float(m.roughness_factor)}})
        indices = attrs.pop("indices")
        meshes.append({"primitives": [{"attributes": attrs, "indices": indices,
                                       "material": i}]})
        matrix = np.eye(4, dtype=np.float32) if matrices is None else matrices[i]
        nodes.append({"mesh": i, "matrix": np.asarray(matrix, np.float32).T.reshape(-1)
                      .tolist()})
    bin_name = path.name.replace(".gltf", ".bin")
    (path.parent / bin_name).write_bytes(blob)
    path.write_text(json.dumps({
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes, "meshes": meshes,
        "materials": materials, "bufferViews": views, "accessors": accessors,
        "buffers": [{"uri": bin_name, "byteLength": len(blob)}]}))


def test_load_gltf_round_trips_a_procedural_model(tmp_path):
    sphere = ModelLoader.load_sphere(stacks=6, slices=8)
    path = tmp_path / "sphere.gltf"
    write_model_gltf(sphere, path)
    loaded = load_gltf(str(path))
    _assert_models_equal(loaded, jax_load_gltf(str(path)))
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(loaded.meshes[0].primitive, f),
                                      getattr(sphere.meshes[0].primitive, f))


@pytest.mark.parametrize("name", ["create_scene", "create_sponza_scene"])
def test_scene_with_sphere_asset_packs_like_jax(name, tmp_path, monkeypatch):
    """`create_scene` (and the Sponza scene) with RUST_RENDERER_TPU_ASSETS
    holding utopian/data/models/sphere.gltf: the spheres come from the asset,
    and the packed tables equal the JAX package's."""
    folder = tmp_path / "utopian" / "data" / "models"
    folder.mkdir(parents=True)
    write_model_gltf(ModelLoader.load_sphere(stacks=5, slices=7), folder / "sphere.gltf")
    monkeypatch.setenv("RUST_RENDERER_TPU_ASSETS", str(tmp_path))
    # The JAX package reads the variable when it is imported.
    monkeypatch.setattr(jax_scenes, "_ASSET_ROOTS", [str(tmp_path)])
    packs = []
    for package, builder in ((jax_rt, getattr(jax_scenes, name)),
                             (torch_rt, getattr(torch_models, name))):
        r = package.Renderer()
        builder(r, package.Camera([0, 0, 0], [0, 0, -1], fov_degrees=60.0, aspect_ratio=1.0))
        r.ensure_mc_material()
        packs.append(r)
    jax_scene, port = packs[0].pack(), packs[1].pack_numpy()
    for f in dataclasses.fields(jax_scene):
        np.testing.assert_array_equal(port[f.name], np.asarray(getattr(jax_scene, f.name)),
                                      err_msg=f.name)
    # The asset's 5x7 sphere, not the procedural default.
    sphere_tris = len(ModelLoader.load_sphere(stacks=5, slices=7).meshes[0].primitive
                      .indices) // 3
    last = packs[1].instances[-1].model.meshes[0].primitive
    assert len(last.indices) // 3 == sphere_tris

"""glTF 2.0 loader (pure Python/numpy, no external glTF library).

Behavioral rebuild of utopian/src/gltf_loader.rs:
- recursive node walk with parent transforms, children visited before the
  node's own mesh (gltf_loader.rs:47-60),
- per-primitive vertex assembly with defaults: uv (0,0), tangent (0,0,0,0),
  color (1,1,1,1) (gltf_loader.rs:62-99),
- PBR material extraction: base-color/normal/metallic-roughness/occlusion map
  indices with a u32::MAX default sentinel, factors, Lambertian default
  ray-trace type (gltf_loader.rs:101-146),
- rgb8 -> rgba8 image conversion (gltf_loader.rs:180-199).

Supports .gltf (JSON) with embedded data-URI buffers or external .bin files,
and images from file URIs or buffer views (decoded via PIL; an opaque white
1x1 image where PIL is missing). The port of the JAX package's
``scene/gltf_loader.py``.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import io
import json
import os
import urllib.parse

import numpy as np

from rust_renderer_tpu_torch.scene.primitive import Primitive
from rust_renderer_tpu_torch.utils import math3d

DEFAULT_TEXTURE_MAP = np.uint32(0xFFFFFFFF)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class MaterialType(enum.IntEnum):
    """Ray-trace material kinds (gltf_loader.rs:12-17)."""

    LAMBERTIAN = 0
    METAL = 1
    DIELECTRIC = 2
    DIFFUSE_LIGHT = 3


@dataclasses.dataclass
class Material:
    """Per-primitive material (gltf_loader.rs:21-33). Map indices refer to the
    model-local texture list; u32::MAX means 'use default texture'."""

    diffuse_map: int = int(DEFAULT_TEXTURE_MAP)
    normal_map: int = int(DEFAULT_TEXTURE_MAP)
    metallic_roughness_map: int = int(DEFAULT_TEXTURE_MAP)
    occlusion_map: int = int(DEFAULT_TEXTURE_MAP)
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    metallic_factor: float = 0.0
    roughness_factor: float = 0.5
    material_type: MaterialType = MaterialType.LAMBERTIAN
    material_property: float = 0.0  # metal: fuzz, dielectric: ior


@dataclasses.dataclass
class Mesh:
    primitive: Primitive
    material: Material
    gpu_mesh: int = 0  # index into the Renderer's global mesh table


@dataclasses.dataclass
class Model:
    """A loaded asset: meshes + per-mesh node transforms + textures
    (gltf_loader.rs:40-45). Textures are (H,W,4) uint8 arrays."""

    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    textures: list[np.ndarray] = dataclasses.field(default_factory=list)
    transforms: list[np.ndarray] = dataclasses.field(default_factory=list)


def _load_buffers(doc: dict, base_dir: str) -> list[bytes]:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            raise ValueError("GLB container buffers not supported here")
        if uri.startswith("data:"):
            _, b64 = uri.split(",", 1)
            buffers.append(base64.b64decode(b64))
        else:
            path = os.path.join(base_dir, urllib.parse.unquote(uri))
            with open(path, "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc: dict, buffers: list[bytes], accessor_index: int) -> np.ndarray:
    acc = doc["accessors"][accessor_index]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize
    tight = n_comp * itemsize

    if "bufferView" not in acc:
        data = np.zeros((count, n_comp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        raw = buffers[bv["buffer"]]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", tight)
        if stride == tight:
            data = np.frombuffer(raw, dtype, count=count * n_comp, offset=offset)
            data = data.reshape(count, n_comp)
        else:
            rows = np.frombuffer(raw, np.uint8, count=stride * (count - 1) + tight, offset=offset)
            idx = (np.arange(count)[:, None] * stride) + np.arange(tight)[None, :]
            data = rows[idx].copy().view(dtype).reshape(count, n_comp)

    if acc.get("sparse"):
        sp = acc["sparse"]
        sidx_dtype = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
        sbv = doc["bufferViews"][sp["indices"]["bufferView"]]
        soff = sbv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
        sidx = np.frombuffer(buffers[sbv["buffer"]], sidx_dtype, count=sp["count"], offset=soff)
        vbv = doc["bufferViews"][sp["values"]["bufferView"]]
        voff = vbv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
        vals = np.frombuffer(
            buffers[vbv["buffer"]], dtype, count=sp["count"] * n_comp, offset=voff
        ).reshape(sp["count"], n_comp)
        data = data.copy()
        data[sidx] = vals

    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        data = data.astype(np.float32) / float(info.max)
    return data


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major flat 16; our convention is m @ v.
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    t = node.get("translation", [0.0, 0.0, 0.0])
    r = node.get("rotation", [0.0, 0.0, 0.0, 1.0])
    s = node.get("scale", [1.0, 1.0, 1.0])
    return math3d.trs(t, r, s)


def _load_images(doc: dict, buffers: list[bytes], base_dir: str) -> list[np.ndarray]:
    try:
        from PIL import Image as PILImage
    except ImportError:
        PILImage = None
    images = []
    for img in doc.get("images", []):
        if "uri" in img and not img["uri"].startswith("data:"):
            path = os.path.join(base_dir, urllib.parse.unquote(img["uri"]))
            if not os.path.exists(path):
                # Tolerate missing texture files (e.g. un-fetched LFS blobs):
                # substitute opaque white, keep indices aligned.
                images.append(np.full((1, 1, 4), 255, np.uint8))
                continue
            with open(path, "rb") as f:
                blob = f.read()
        elif "uri" in img:
            _, b64 = img["uri"].split(",", 1)
            blob = base64.b64decode(b64)
        else:
            bv = doc["bufferViews"][img["bufferView"]]
            off = bv.get("byteOffset", 0)
            blob = buffers[bv["buffer"]][off : off + bv["byteLength"]]
        if PILImage is None:
            images.append(np.full((1, 1, 4), 255, np.uint8))
            continue
        with PILImage.open(io.BytesIO(blob)) as pim:
            # rgb8 -> rgba8 conversion (gltf_loader.rs:180-199); any other
            # format also lands on RGBA8.
            arr = np.asarray(pim.convert("RGBA"), np.uint8)
        images.append(arr)
    return images


def _texture_image_index(doc: dict, tex_index: int | None) -> int:
    """Map a glTF texture index to its image ('source') index; the reference
    registers textures by image order (gltf_loader.rs:189-216), and samplers
    are uniform (linear, repeat) so only the image matters."""
    if tex_index is None:
        return int(DEFAULT_TEXTURE_MAP)
    tex = doc["textures"][tex_index]
    return int(tex.get("source", int(DEFAULT_TEXTURE_MAP)))


def _load_node(
    doc: dict,
    buffers: list[bytes],
    node_index: int,
    model: Model,
    parent_transform: np.ndarray,
) -> None:
    node = doc["nodes"][node_index]
    node_transform = parent_transform @ _node_transform(node)

    # Children before own mesh, matching the reference's recursion order
    # (gltf_loader.rs:55-58) so gpu_mesh indices line up for parity tests.
    for child in node.get("children", []):
        _load_node(doc, buffers, child, model, node_transform)

    if "mesh" not in node:
        return
    mesh = doc["meshes"][node["mesh"]]
    for prim in mesh.get("primitives", []):
        attrs = prim["attributes"]
        positions = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
        count = len(positions)
        if "indices" in prim:
            indices = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
        else:
            indices = np.arange(count, dtype=np.uint32)
        normals = (
            _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            if "NORMAL" in attrs
            else np.tile(np.array([0.0, 1.0, 0.0], np.float32), (count, 1))
        )
        uvs = (
            _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
            if "TEXCOORD_0" in attrs
            else np.zeros((count, 2), np.float32)
        )
        tangents = (
            _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
            if "TANGENT" in attrs
            else np.zeros((count, 4), np.float32)
        )
        if "COLOR_0" in attrs:
            colors = _read_accessor(doc, buffers, attrs["COLOR_0"]).astype(np.float32)
            if colors.shape[1] == 3:
                colors = np.concatenate([colors, np.ones((count, 1), np.float32)], axis=1)
        else:
            colors = np.ones((count, 4), np.float32)

        material = Material()
        if "material" in prim:
            m = doc["materials"][prim["material"]]
            pbr = m.get("pbrMetallicRoughness", {})
            material.diffuse_map = _texture_image_index(
                doc, pbr.get("baseColorTexture", {}).get("index")
            )
            material.normal_map = _texture_image_index(
                doc, m.get("normalTexture", {}).get("index")
            )
            material.metallic_roughness_map = _texture_image_index(
                doc, pbr.get("metallicRoughnessTexture", {}).get("index")
            )
            material.occlusion_map = _texture_image_index(
                doc, m.get("occlusionTexture", {}).get("index")
            )
            material.base_color_factor = np.asarray(
                pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float32
            )
            material.metallic_factor = float(pbr.get("metallicFactor", 1.0))
            material.roughness_factor = float(pbr.get("roughnessFactor", 1.0))

        model.meshes.append(
            Mesh(
                primitive=Primitive(
                    positions=positions,
                    normals=normals,
                    uvs=uvs,
                    colors=colors,
                    tangents=tangents,
                    indices=indices,
                ),
                material=material,
            )
        )
        model.transforms.append(node_transform.astype(np.float32))


def load_gltf(path: str) -> Model:
    """Load a .gltf file into a Model (gltf_loader.rs:168-218)."""
    with open(path, "r") as f:
        doc = json.load(f)
    base_dir = os.path.dirname(path)
    buffers = _load_buffers(doc, base_dir)

    model = Model()
    model.textures = _load_images(doc, buffers, base_dir)

    scene_index = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    if scenes:
        for node_index in scenes[scene_index].get("nodes", []):
            _load_node(doc, buffers, node_index, model, np.eye(4, dtype=np.float32))
    return model

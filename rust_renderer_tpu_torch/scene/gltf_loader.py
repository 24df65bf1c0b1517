"""Material and model containers of the glTF loader.

The dataclasses of ``rust_renderer_tpu/scene/gltf_loader.py`` (the reference's
utopian/src/gltf_loader.rs types). The glTF parser itself is not ported yet;
the port's scenes are built from procedural models.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from rust_renderer_tpu_torch.scene.primitive import Primitive

DEFAULT_TEXTURE_MAP = np.uint32(0xFFFFFFFF)


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

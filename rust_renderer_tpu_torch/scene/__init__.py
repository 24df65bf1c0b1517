"""Scene assets: primitives, materials, glTF loading and procedural models
(host numpy)."""

from rust_renderer_tpu_torch.scene.primitive import Primitive, Vertex
from rust_renderer_tpu_torch.scene.gltf_loader import (
    DEFAULT_TEXTURE_MAP,
    Material,
    MaterialType,
    Mesh,
    Model,
    load_gltf,
)
from rust_renderer_tpu_torch.scene.model_loader import ModelLoader

__all__ = [
    "Primitive",
    "Vertex",
    "Material",
    "MaterialType",
    "Mesh",
    "Model",
    "DEFAULT_TEXTURE_MAP",
    "load_gltf",
    "ModelLoader",
]

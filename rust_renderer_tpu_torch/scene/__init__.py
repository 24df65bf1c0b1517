"""Scene assets: primitives, materials and procedural models (host numpy)."""

from rust_renderer_tpu_torch.scene.primitive import Primitive
from rust_renderer_tpu_torch.scene.gltf_loader import (
    DEFAULT_TEXTURE_MAP,
    Material,
    MaterialType,
    Mesh,
    Model,
)
from rust_renderer_tpu_torch.scene.model_loader import ModelLoader

__all__ = [
    "Primitive",
    "Material",
    "MaterialType",
    "Mesh",
    "Model",
    "DEFAULT_TEXTURE_MAP",
    "ModelLoader",
]

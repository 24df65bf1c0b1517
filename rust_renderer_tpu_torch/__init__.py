"""rust_renderer_tpu_torch — the PyTorch / CUDA port of rust_renderer_tpu.

A second package beside the JAX one, with the same module names. Plain code
is PyTorch tensor code; each TPU kernel of the JAX package becomes a kernel
written by hand for NVIDIA Hopper (``csrc/``), built from the checkout at
first use. The JAX package is the reference the port is tested against; the
port never imports it (nor jax).

Ported so far: the PATH_TRACED frame of the default scene (exact sky), with
kernel K1 (BVH traversal).
"""

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.graph import Graph, PassBuilder
from rust_renderer_tpu_torch.renderer import Renderer
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "StaticConfig",
    "RenderGraphMode",
    "Camera",
    "Renderer",
    "Graph",
    "PassBuilder",
]

"""rust_renderer_tpu_torch — the PyTorch / CUDA port of rust_renderer_tpu.

A second package beside the JAX one, with the same module names. Plain code
is PyTorch tensor code; each TPU kernel of the JAX package becomes a kernel
written by hand for NVIDIA Hopper (``csrc/``), built from the checkout at
first use. The JAX package is the reference the port is tested against; the
port never imports it (nor jax).

Ported so far: every frame mode of every scene builder, the device frame
loop, and the application with its entry point
(``python -m rust_renderer_tpu_torch.app.main``); not yet the multi-device
layer. ROADMAP.md keeps the list.
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

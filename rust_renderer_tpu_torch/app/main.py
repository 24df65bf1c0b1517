"""Application: scene setup and the frame loop (rebuild of prototype/src/main.rs).

Owns the Renderer + Graph + Camera + settings on one device, rebuilds the
render graph every frame (main.rs:487-517) and keeps the progressive-
accumulation protocol: total_samples grows by samples_per_frame each frame
and `reset_accumulation` starts it over (main.rs:400-469). Frames render
offscreen; `run` returns the last presented image as numpy.

Usage:
    app = Application(512, 512, device="cuda")
    app.create_scene()
    img = app.run(num_frames=16)
"""

from __future__ import annotations

import numpy as np
import torch

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.models import create_scene
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.renderer import Renderer
from rust_renderer_tpu_torch.renderers import build_path_tracing_render_graph
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import FpsTimer


def init_device(device) -> torch.device:
    """The device the app renders on. On CUDA, float32 products stay in full
    float32 (no TF32), as the JAX reference computes them."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no GPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


class Application:
    def __init__(
        self,
        width: int = 2000,
        height: int = 1100,
        mode: RenderGraphMode = RenderGraphMode.PATH_TRACED,
        cfg: StaticConfig | None = None,
        device="cpu",
    ):
        if mode != RenderGraphMode.PATH_TRACED:
            raise NotImplementedError(f"{mode}: only PATH_TRACED is ported")
        self.device = init_device(device)
        self.cfg = (cfg or StaticConfig()).replace(width=width, height=height)
        self.renderer = Renderer()
        self.camera = Camera(
            [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0],
            fov_degrees=60.0, aspect_ratio=width / height,
            z_near=0.01, z_far=1000.0, speed=0.2,
        )
        self.graph = Graph(self.device)
        # view.time is the wall clock since start (main.rs:465); it seeds
        # every random stream of the frame.
        self.fps_timer = FpsTimer()
        self.render_graph_mode = mode
        self.total_samples = 0
        self.scene = None
        self.scene_bvh = None
        self.sun_dir = np.array([0.0, 0.90631, 0.42262], np.float32)
        self.view = RenderSettings.default(sun_dir=self.sun_dir)
        self._pending_prev_pv = None

    # -- scene (main.rs:168-176) --------------------------------------------

    def create_scene(self, builder=create_scene) -> None:
        builder(self.renderer, self.camera)
        self._repack()

    def _repack(self) -> None:
        """Pack the scene tensors and (re)build the BVH (raytracing.rs:89-111)."""
        self.renderer.ensure_mc_material()
        self.scene = self.renderer.pack(self.device)
        self.scene_bvh = bvh_ops.build_scene_bvh(self.scene)

    def reset_accumulation(self) -> None:
        self.total_samples = 0

    # -- frame loop (main.rs:362-552) ----------------------------------------

    def _refresh_view(self) -> None:
        """main.rs:459-471."""
        w, h = self.cfg.width, self.cfg.height
        self.total_samples += self.cfg.samples_per_frame
        self.view = self.view.with_camera(self.camera, w, h).replace(
            total_samples=np.uint32(self.total_samples),
            time=np.float32(self.fps_timer.elapsed_seconds()),
            num_lights=np.int32(self.renderer.get_num_lights()),
            sun_dir=np.asarray(self.sun_dir, np.float32),
        )
        # THIS frame's matrices, handed over after the render, so the next
        # frame backprojects with matrices exactly one frame old
        # (main.rs:545-546).
        self._pending_prev_pv = (
            np.asarray(self.view.projection) @ np.asarray(self.view.view)
        ).astype(np.float32)

    def _build_graph(self) -> None:
        self.graph.new_frame()
        self.graph.clear()
        build_path_tracing_render_graph(
            self.graph, self.cfg, self.camera, self.scene_bvh, self.sun_dir,
            num_lights=self.renderer.get_num_lights(),
        )

    def render_frame(self) -> dict[str, torch.Tensor]:
        """One full frame; returns the resource dict."""
        self._refresh_view()
        self._build_graph()
        resources = self.graph.render(self.scene, self.view)
        # prev-frame matrix handoff for the next frame's temporal pass.
        self.view = self.view.replace(prev_frame_projection_view=self._pending_prev_pv)
        self.fps_timer.calculate()
        return resources

    def run(self, num_frames: int = 1) -> np.ndarray | None:
        """Render `num_frames` frames; returns the last presented image
        (H, W, 3) as numpy."""
        last = None
        for _ in range(num_frames):
            last = self.render_frame()["present_output"]
        return None if last is None else last.cpu().numpy()

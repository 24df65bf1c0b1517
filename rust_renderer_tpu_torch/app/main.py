"""Application: scene setup and the frame loop (rebuild of prototype/src/main.rs).

Owns the Renderer + Graph + Camera + settings on one device, rebuilds the
render graph of the active mode every frame (main.rs:487-517) and keeps the
progressive-accumulation protocol: total_samples grows by samples_per_frame
each frame and `reset_accumulation` starts it over (main.rs:400-469).
Frames render offscreen; `run` returns the last presented image as numpy.
`run_on_device(n)` renders n frames through `Graph.render_loop` (on CUDA,
replays of one captured CUDA graph of the frame; `graph.last_loop_form`
says how it ran) and returns the last presented image as a tensor on the
device.

It renders on the card unless the caller passes device="cpu" (there every
kernel wrapper takes its plain PyTorch version); with no GPU, "cuda" raises.

Usage:
    app = Application(512, 512, RenderGraphMode.RASTERIZED)
    app.create_scene()
    img = app.run(num_frames=16)
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.models import create_scene
from rust_renderer_tpu_torch.ops import bvh as bvh_ops
from rust_renderer_tpu_torch.renderer import Renderer
from rust_renderer_tpu_torch.ops.ibl import compute_environment
from rust_renderer_tpu_torch.renderers import (
    build_hybrid_render_graph,
    build_minimal_forward_render_graph,
    build_path_tracing_render_graph,
    build_render_graph,
)
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils import FpsTimer

log = logging.getLogger(__name__)


def _loop_view_update(view, k, aux):
    """Frame k's view in `Graph.render_loop` (JAX `app/main.py:42-57`):
    the accumulation counter advanced by k * spf, the clock by k * tstep,
    and, for k > 0, the previous frame's matrices set to the current P·V
    (the camera holds still inside a loop, so this is the host loop's
    one-frame-late handoff). aux["pv"] is that P·V as the host loop
    computes it (`Application._refresh_view`), so the frames carry the
    host loop's bits."""
    return view.replace(
        total_samples=view.total_samples + k.to(torch.int64) * aux["spf"],
        time=view.time + k.to(torch.float32) * aux["tstep"],
        prev_frame_projection_view=torch.where(
            k == 0, view.prev_frame_projection_view, aux["pv"]),
    )


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
        device="cuda",
    ):
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

    def _ensure_environment(self) -> None:
        """Capture the environment (cubemaps, irradiance, LUT) into the
        graph's persistent resources when a mode reads it and it is stale
        (the reference's lazily-updated env maps, ibl.rs:63-66)."""
        mode = self.render_graph_mode
        needs_env = mode == RenderGraphMode.RASTERIZED or (
            mode == RenderGraphMode.PATH_TRACED and self.cfg.sky_mode == "cubemap")
        if needs_env and self.renderer.need_environment_map_update:
            self.graph.state.update(compute_environment(self.cfg, self.sun_dir, self.device))
            self.renderer.need_environment_map_update = False

    def _build_graph(self) -> None:
        mode = self.render_graph_mode
        self.graph.new_frame()
        self.graph.clear()
        if mode == RenderGraphMode.PATH_TRACED:
            build_path_tracing_render_graph(
                self.graph, self.cfg, self.camera, self.scene_bvh, self.sun_dir,
                marching_cubes_enabled=bool(int(self.view.marching_cubes_enabled)),
                mc_material=self.renderer.ensure_mc_material(),
                num_lights=self.renderer.get_num_lights())
        elif mode == RenderGraphMode.RASTERIZED:
            build_render_graph(
                self.graph, self.cfg, self.camera, self.scene_bvh, self.sun_dir,
                shadows_enabled=bool(int(self.view.shadows_enabled)),
                marching_cubes_enabled=bool(int(self.view.marching_cubes_enabled)),
                raytracing_supported=bool(int(self.view.raytracing_supported)))
        elif mode == RenderGraphMode.MINIMAL:
            build_minimal_forward_render_graph(
                self.graph, self.cfg, self.camera, self.scene_bvh, self.sun_dir)
        else:
            build_hybrid_render_graph(self.graph)

    def render_frame(self) -> dict[str, torch.Tensor]:
        """One full frame; returns the resource dict."""
        self._refresh_view()
        self._ensure_environment()
        self._build_graph()
        resources = self.graph.render(self.scene, self.view)
        # prev-frame matrix handoff for the next frame's temporal pass.
        self.view = self.view.replace(prev_frame_projection_view=self._pending_prev_pv)
        self.fps_timer.calculate()
        return resources

    def run_on_device(self, num_frames: int = 1, tstep: float = 1.0 / 60.0):
        """Render `num_frames` frames through `Graph.render_loop` (JAX
        `app/main.py:238-295`): the view, environment and graph refreshed
        once, then frame k's view derived on the device (`_loop_view_update`,
        the clock advancing `tstep` a frame). The host counters are advanced
        to match, so `run` and `run_on_device` interleave. Returns the last
        frame's present_output as a tensor on the device (None where the
        graph has none).

        Where `Graph.device_loop_unsupported_reason` gives a reason, the
        frames run through the host loop (`render_frame`), as in the JAX
        package, and the reason is logged."""
        if num_frames < 1:
            raise ValueError(f"run_on_device: num_frames must be at least 1, got {num_frames}")
        self._refresh_view()
        self._ensure_environment()
        self._build_graph()
        reason = self.graph.device_loop_unsupported_reason()
        if reason is not None:
            log.info("run_on_device: %s; rendering through the host frame loop", reason)
            # render_frame counts each frame itself: undo _refresh_view's.
            self.total_samples -= self.cfg.samples_per_frame
            img = None
            for _ in range(num_frames):
                img = self.render_frame().get("present_output")
            return img
        aux = {"spf": np.uint32(self.cfg.samples_per_frame), "tstep": np.float32(tstep),
               "pv": self._pending_prev_pv}
        img = self.graph.render_loop(self.scene, self.view, num_frames,
                                     view_update=_loop_view_update, aux=aux)
        # Frames 2..N advanced the counter on the device; frame 1 was counted
        # by _refresh_view.
        self.total_samples += self.cfg.samples_per_frame * (num_frames - 1)
        self.view = self.view.replace(total_samples=np.uint32(self.total_samples),
                                      prev_frame_projection_view=self._pending_prev_pv)
        self.fps_timer.calculate()
        return img

    def run(self, num_frames: int = 1) -> np.ndarray | None:
        """Render `num_frames` frames; returns the last presented image
        (H, W, 3) as numpy."""
        last = None
        for _ in range(num_frames):
            last = self.render_frame().get("present_output")
        return None if last is None else last.cpu().numpy()

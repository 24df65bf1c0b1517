"""Application: scene setup, the frame loop, mode switching (rebuild of
prototype/src/main.rs; the port of the JAX package's ``app/main.py``).

Owns the Renderer + Graph + Camera + Input + settings on one device,
rebuilds the render graph of the active mode every frame (main.rs:487-517)
and keeps the progressive-accumulation protocol: total_samples grows by
samples_per_frame each frame, and a camera move, a changed setting, a mode
switch or a gizmo edit starts it over (main.rs:400-469). Hotkeys 1/2/3/4
switch the mode (main.rs:415-428), Q toggles the profiler (main.rs:450-453),
and an edited kernel module or CUDA source is reloaded through the
directory watcher (main.rs:430-448). Frames render offscreen; `run` presents
by copying the image to the host (with the HUD, when on) and returns it as
numpy, and can write it to disk. `run_on_device(n)` renders n frames
through `Graph.render_loop` (on CUDA, replays of one captured CUDA graph of
the frame; `graph.last_loop_form` says how it ran) and returns the last
presented image as a tensor on the device.

It renders on the card unless the caller passes device="cpu" (there every
kernel wrapper takes its plain PyTorch version); with no GPU, "cuda" raises.

Usage:
    app = Application(512, 512, RenderGraphMode.RASTERIZED)
    app.create_scene()
    img = app.run(num_frames=16, save_to="frame.png")

or from the shell (`--device cpu` renders on the CPU):
    python -m rust_renderer_tpu_torch.app.main --width 512 --height 512 --mode pt
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from rust_renderer_tpu_torch import models, native
from rust_renderer_tpu_torch.app.ui import Ui
from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.input import Input
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
from rust_renderer_tpu_torch.utils.image_io import save_png
from rust_renderer_tpu_torch.utils.profiler import PROFILER
from rust_renderer_tpu_torch.utils.watcher import DirectoryWatcher

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
        sanitize: bool = False,
        *,
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
        self.graph = Graph(device=self.device, sanitize=sanitize)
        self.input = Input()
        self.ui = Ui()
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
        self.saved_to: str | None = None  # the file the last run(save_to=) wrote
        self.watcher = DirectoryWatcher(os.path.dirname(os.path.dirname(__file__)))

    # -- scene (main.rs:168-176) --------------------------------------------

    def create_scene(self, builder=create_scene) -> None:
        with PROFILER.scope("create_scene"):
            builder(self.renderer, self.camera)
            self._repack()

    def _repack(self) -> None:
        """Pack the scene tensors and (re)build the BVH (raytracing.rs:89-111)."""
        self.renderer.ensure_mc_material()
        with PROFILER.scope("pack_scene"):
            self.scene = self.renderer.pack(device=self.device)
        with PROFILER.scope("build_bvh"):
            self.scene_bvh = bvh_ops.build_scene_bvh(self.scene)

    def set_instance_transform(self, instance: int, transform) -> None:
        """The gizmo move (main.rs:344-359): the transform edited, the scene
        repacked and its BVH rebuilt, the accumulation reset. The graph's
        captured loop holds the old scene's tensors, so the next
        `run_on_device` captures anew."""
        self.renderer.set_instance_transform(instance, transform)
        self._repack()
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.total_samples = 0

    # -- frame loop (main.rs:362-552) ----------------------------------------

    def _handle_hotkeys(self) -> None:
        mapping = {
            "1": RenderGraphMode.PATH_TRACED,
            "2": RenderGraphMode.HYBRID,
            "3": RenderGraphMode.RASTERIZED,
            "4": RenderGraphMode.MINIMAL,
        }
        for key, mode in mapping.items():
            if self.input.key_pressed(key) and self.render_graph_mode != mode:
                self.render_graph_mode = mode
                self.reset_accumulation()
        if self.input.key_pressed("q"):
            PROFILER.toggle()

    def _check_hot_reload(self) -> None:
        path = self.watcher.check_if_modification()
        if path is None:
            return
        self.reset_accumulation()
        if path.endswith((".cu", ".cuh")):
            # The libraries built from it load the edited code at their next launch.
            native.invalidate(path)
            self.graph.recompile()
        elif mod := DirectoryWatcher.module_name_for(path):
            self.graph.recompile_shader(mod)

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
            with PROFILER.scope("environment_update"):
                self.graph.state.update(
                    compute_environment(self.cfg, self.sun_dir, device=self.device))
            self.renderer.need_environment_map_update = False

    def _build_graph(self) -> None:
        mode = self.render_graph_mode
        with PROFILER.scope("build_graph"):
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
        """One full frame: hotkeys, hot reload, camera and settings (each may
        reset the accumulation), then the graph; returns the resource dict."""
        PROFILER.new_frame()
        with PROFILER.scope("frame"):
            self._handle_hotkeys()
            self._check_hot_reload()
            if self.camera.update(self.input):
                self.reset_accumulation()
            if self.ui.settings_changed(self.view, self.cfg):
                self.reset_accumulation()
            self._refresh_view()
            self._ensure_environment()
            self._build_graph()
            with PROFILER.scope("render"):
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
        PROFILER.new_frame()
        with PROFILER.scope("frame_loop"):
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
            with PROFILER.scope("render_loop"):
                img = self.graph.render_loop(self.scene, self.view, num_frames,
                                             view_update=_loop_view_update, aux=aux)
            # Frames 2..N advanced the counter on the device; frame 1 was
            # counted by _refresh_view.
            self.total_samples += self.cfg.samples_per_frame * (num_frames - 1)
            self.view = self.view.replace(total_samples=np.uint32(self.total_samples),
                                          prev_frame_projection_view=self._pending_prev_pv)
        self.fps_timer.calculate()
        return img

    def present(self, image: torch.Tensor) -> np.ndarray:
        """The presented frame: `image` copied to the host (a blocking read)
        with the HUD composited when the overlay is on, as the reference
        records its egui pass into the swapchain image (ui.rs:56-75)."""
        with PROFILER.scope("present"):
            return self.ui.compose(image.cpu().numpy(), self.view, self.cfg,
                                   self.render_graph_mode, self.fps_timer.fps,
                                   self.total_samples)

    def run(self, num_frames: int = 1, on_frame=None, save_to: str | None = None,
            present_every: int = 1) -> np.ndarray | None:
        """Pump `num_frames` frames (the winit loop analog,
        vulkan_base.rs:508-544); returns the last presented image (H, W, 3)
        as numpy.

        present_every is the frames-in-flight analog (vulkan_base.rs:389-424
        keeps 1-3 frames in flight): the host copies the image to numpy, the
        loop's only wait on the device, every Nth frame and after the last,
        so it records frame N+1 while the card renders frame N. Each
        presented frame goes to `on_frame(i, image)`. `save_to`: the last
        presented frame is written there as a PNG (a PPM where PIL is
        missing; `saved_to` names the file)."""
        last = last_dev = None
        presented = -1
        for i in range(num_frames):
            self.input.begin_frame()
            resources = self.render_frame()
            if "present_output" in resources:
                last_dev = resources["present_output"]
                if present_every > 0 and (i + 1) % present_every == 0:
                    last, presented = self.present(last_dev), i
                    if on_frame is not None:
                        on_frame(i, last)
        if last_dev is not None and presented != num_frames - 1:
            last = self.present(last_dev)
        if save_to and last is not None:
            self.saved_to = save_png(save_to, last)
        return last


SCENES = {
    "default": models.create_scene,
    "rtiow": models.create_rtiow_scene,
    "cornell": models.create_cornell_box_scene,
    "cubes": models.create_cube_scene,
}
MODES = {
    "pt": RenderGraphMode.PATH_TRACED,
    "hybrid": RenderGraphMode.HYBRID,
    "raster": RenderGraphMode.RASTERIZED,
    "minimal": RenderGraphMode.MINIMAL,
}


def main(argv: list[str] | None = None) -> int:
    """The offscreen app (the JAX package's `main`, with `--device`): renders
    `--frames` frames and writes the last to `--out`, or runs the terminal
    viewer; prints the profiler's report and the frame rate."""
    p = argparse.ArgumentParser(description="rust_renderer_tpu_torch offscreen app")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--mode", choices=list(MODES), default="pt")
    p.add_argument("--out", default="frame.png")
    p.add_argument("--scene", choices=list(SCENES), default="default")
    p.add_argument("--small", action="store_true",
                   help="shrink offscreen buffers (shadow/cubemap/LUT) for quick runs")
    p.add_argument("--sanitize", action="store_true",
                   help="NaN/Inf-check every pass output (the validation-layer analog)")
    p.add_argument("--interactive", action="store_true",
                   help="live terminal viewer with keyboard camera/mode controls")
    p.add_argument("--device", default="cuda",
                   help="the torch device to render on (default: the GPU; 'cpu' "
                        "runs every kernel's plain PyTorch version)")
    args = p.parse_args(argv)

    cfg = None
    if args.small:
        cfg = StaticConfig(
            shadow_map_size=256, cubemap_size=64, cubemap_mips=4,
            irradiance_size=16, brdf_lut_size=64, num_bounces=3,
        )
    app = Application(args.width, args.height, MODES[args.mode], cfg,
                      sanitize=args.sanitize, device=args.device)
    app.create_scene(SCENES[args.scene])
    if args.interactive:
        from rust_renderer_tpu_torch.app.viewer import run_interactive

        run_interactive(app, max_frames=args.frames if args.frames > 0 else None)
    else:
        app.run(args.frames, save_to=args.out)
    print(PROFILER.report())
    print(f"fps={app.fps_timer.fps:.2f} saved={app.saved_to}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Settings panel: the headless analog of the egui UI (prototype/src/ui.rs +
update_ui in prototype/src/main.rs:178-360).

The reference mutates `ViewUniformData` through egui widgets and resets
progressive accumulation whenever any path-tracing-relevant setting changes
(main.rs:400-413). Here the panel mutates the same fields programmatically
(scriptable / keyboard-driven) and reports change state the same way.
`U32Checkbox` (ui.rs:77-97) maps to flag toggles on int settings. The
port of the JAX package's ``app/ui.py``: the settings are host numpy values.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rust_renderer_tpu_torch.utils.hud import compose_hud

# Fields whose change resets accumulation (main.rs:400-413 watches the whole
# ViewUniformData block; camera moves and gizmo edits also reset).
_TRACKED = (
    "samples_per_frame",
    "num_bounces",
    "sun_dir",
    "sky_enabled",
    "sun_shadow_enabled",
    "lights_enabled",
    "max_num_lights_used",
    "temporal_reuse_enabled",
    "spatial_reuse_enabled",
    "accumulation_limit",
    "use_ris_light_sampling",
)


@dataclasses.dataclass
class UiState:
    show_profiler: bool = False  # toggled by Q (main.rs:450-453)
    gizmo_instance: int | None = None
    # Composite the settings HUD into the PRESENTED frame (ui.rs:56-75
    # paints egui into the swapchain image). Off by default so goldens and
    # benches never see it; the viewer toggles it with 'u'.
    overlay: bool = False


class Ui:
    def __init__(self) -> None:
        self.state = UiState()
        self._prev_snapshot: tuple | None = None

    def _snapshot(self, view, cfg) -> tuple:
        vals = []
        for f in _TRACKED:
            v = getattr(view, f, None)
            if v is None:
                v = getattr(cfg, f, None)
            if hasattr(v, "tolist"):
                # The app keeps its settings as host numpy values, so this
                # never waits on the device.
                v = tuple(np.asarray(v).reshape(-1).tolist())
            vals.append((f, v))
        return tuple(vals)

    def begin_frame(self) -> None:
        pass

    def settings_changed(self, view, cfg) -> bool:
        """True when any tracked setting differs from last frame —
        the accumulation-reset trigger (main.rs:400-413)."""
        snap = self._snapshot(view, cfg)
        changed = self._prev_snapshot is not None and snap != self._prev_snapshot
        self._prev_snapshot = snap
        return changed

    @staticmethod
    def toggle_flag(view, name: str):
        """U32Checkbox analog: flips an int flag on RenderSettings."""
        cur = int(getattr(view, name))
        return view.replace(**{name: np.int32(0 if cur else 1)})

    def hud_lines(self, view, cfg, mode, fps: float,
                  total_samples: int) -> list:
        """The settings-panel content (update_ui, main.rs:178-360), as text
        lines for the frame-composited HUD (utils/hud.py)."""

        def flag(name):
            return "ON" if int(getattr(view, name)) else "OFF"

        return [
            f"MODE: {getattr(mode, 'name', mode)}",
            f"FPS: {fps:.2f}",
            f"SAMPLES: {total_samples}",
            f"BOUNCES: {cfg.num_bounces}",
            f"LIGHTS: {int(np.asarray(view.num_lights))}"
            f" SKY: {flag('sky_enabled')}",
            f"SHADOWS: {flag('shadows_enabled')}"
            f" SSAO: {flag('ssao_enabled')}",
            f"FXAA: {flag('fxaa_enabled')}"
            f" IBL: {flag('ibl_enabled')}",
            f"TEMPORAL: {flag('temporal_reuse_enabled')}"
            f" SPATIAL: {flag('spatial_reuse_enabled')}",
        ]

    def compose(self, img, view, cfg, mode, fps: float,
                total_samples: int):
        """Composite the HUD into a presented numpy frame (no-op copy-free
        pass-through when the overlay is off)."""
        if not self.state.overlay or img is None:
            return img
        return compose_hud(
            img, self.hud_lines(view, cfg, mode, fps, total_samples))

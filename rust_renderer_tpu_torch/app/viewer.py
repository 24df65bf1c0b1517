"""Live terminal viewer + keyboard input source (the winit/egui analog).

The reference presents through a winit window with an egui settings panel
(prototype/src/main.rs:362-552, prototype/src/ui.rs:10-75). Headless
rendering has no swapchain, so presentation here is a terminal raster:
frames are downsampled and drawn as 24-bit ANSI half-blocks (two image rows
per character cell), with a HUD that renders the settings-panel state. The
keyboard comes from raw-mode stdin and pumps the same `Input` edge-detection
state the reference feeds from winit events (input.rs:28-70), so hotkeys,
camera flight, and live toggles all work interactively.

Controls (HUD shows live state):
  1/2/3/4   render graph mode (main.rs:415-428)
  w/a/s/d   camera (camera.rs dolly rig)
  q         profiler toggle (main.rs:450-453)
  n         settings panel composited into the frame (ui.rs:56-75 analog)
  h o x v b shadows / ssao / fxaa / sky / ibl
  t y u l   temporal reuse / spatial reuse / RIS light sampling / lights
  z c       fxaa edge-direction debug / CSM cascade-debug tint
  TAB       select next instance (gizmo target)
  I/K J/L U/O  move selected instance -z/+z, -x/+x, +y/-y (the egui gizmo
            analog, main.rs:344-359: transform edit + TLAS rebuild +
            accumulation reset)
  ESC       quit

The port of the JAX package's ``app/viewer.py``: each frame reaches the
host through one copy of the device tensor (`Application.present`).
"""

from __future__ import annotations

import select
import shutil
import sys
import time

import numpy as np

from rust_renderer_tpu_torch.app.ui import Ui

# key -> RenderSettings flag (the U32Checkbox rows of ui.rs:20-43)
TOGGLE_KEYS = {
    "h": "shadows_enabled",
    "o": "ssao_enabled",
    "x": "fxaa_enabled",
    "v": "sky_enabled",
    "b": "ibl_enabled",
    "t": "temporal_reuse_enabled",
    "y": "spatial_reuse_enabled",
    "u": "use_ris_light_sampling",
    "l": "lights_enabled",
    "z": "fxaa_debug",
    "c": "cascade_debug",
}

# How long a key is considered held after its last stdin byte: terminals
# deliver no key-up events, only autorepeat, so "down" = seen recently.
KEY_HOLD_SECONDS = 0.30


class StdinKeySource:
    """Non-blocking raw-mode stdin -> Input pump."""

    def __init__(self) -> None:
        self._fd = sys.stdin.fileno() if sys.stdin.isatty() else None
        self._saved = None
        self._last_seen: dict[str, float] = {}
        self.quit_requested = False

    def __enter__(self) -> "StdinKeySource":
        if self._fd is not None:
            import termios
            import tty

            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *_exc) -> None:
        if self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def pump(self, input_state) -> None:
        """Read pending bytes and refresh the Input down-map."""
        now = time.monotonic()
        while self._fd is not None:
            ready, _, _ = select.select([sys.stdin], [], [], 0)
            if not ready:
                break
            ch = sys.stdin.read(1)
            if not ch:
                break
            if ch == "\x1b":  # ESC — lone ESC quits; CSI/SS3 sequences
                # (arrow/function keys) are swallowed so their tail bytes
                # don't leak in as spurious key presses.
                ready, _, _ = select.select([sys.stdin], [], [], 0.01)
                if not ready:
                    self.quit_requested = True
                    continue
                nxt = sys.stdin.read(1)
                if nxt in ("[", "O"):
                    # Consume the sequence body: parameter bytes 0x30-0x3F,
                    # intermediates 0x20-0x2F, one final byte 0x40-0x7E.
                    while True:
                        ready, _, _ = select.select([sys.stdin], [], [], 0.01)
                        if not ready:
                            break
                        b = sys.stdin.read(1)
                        if not b or not ("\x20" <= b <= "\x3f"):
                            break
                # Alt+<key> (ESC then a plain byte) is ignored entirely.
                continue
            if ch == "\x03":  # Ctrl-C in cbreak mode
                self.quit_requested = True
                continue
            # Uppercase letters and TAB are one-shot events (gizmo nudges),
            # delivered via the pressed-edge path under their own names.
            key = "tab" if ch == "\t" else (
                "shift+" + ch.lower() if ch.isalpha() and ch.isupper()
                else ch.lower()
            )
            if key not in self._last_seen:
                input_state.set_key_down(key)
            self._last_seen[key] = now
        for key, seen in list(self._last_seen.items()):
            if now - seen > KEY_HOLD_SECONDS:
                input_state.set_key_up(key)
                del self._last_seen[key]
            else:
                input_state.set_key_down(key)


def frame_to_ansi(img: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) float [0,1] -> ANSI half-block string of cols x rows cells.

    Each character cell is '▀' with fg = upper pixel, bg = lower pixel:
    two image rows per terminal row — the closest thing to a swapchain a
    terminal offers.
    """
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(rows * 2) * h) // (rows * 2), h - 1)
    xs = np.minimum((np.arange(cols) * w) // cols, w - 1)
    small = img[np.ix_(ys, xs)]
    rgb = np.clip(small * 255.0, 0, 255).astype(np.uint8)
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for r in range(rows):
        parts = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def _hud(app) -> str:
    """The settings panel, rendered (ui.rs:10-75 analog)."""
    v = app.view
    flags = " ".join(
        f"{key}:{name.split('_')[0]}={'on' if int(getattr(v, name)) else 'off'}"
        for key, name in TOGGLE_KEYS.items()
    )
    gizmo = app.ui.state.gizmo_instance
    gizmo_s = f" gizmo=#{gizmo}" if gizmo is not None else ""
    return (
        f"mode={app.render_graph_mode.name} fps={app.fps_timer.fps:.2f} "
        f"samples={app.total_samples} lights={app.renderer.get_num_lights()}"
        f"{gizmo_s}\n"
        f"[1-4]=mode wasd=camera TAB/shift-IJKLUO=gizmo q=profiler "
        f"ESC=quit | {flags}"
    )


# shift+key -> instance translation delta (gizmo arrows)
GIZMO_KEYS = {
    "shift+i": (0.0, 0.0, -0.5),
    "shift+k": (0.0, 0.0, 0.5),
    "shift+j": (-0.5, 0.0, 0.0),
    "shift+l": (0.5, 0.0, 0.0),
    "shift+u": (0.0, 0.5, 0.0),
    "shift+o": (0.0, -0.5, 0.0),
}


def _handle_gizmo(app, state) -> None:
    """Instance-transform gizmo (main.rs:344-359): TAB selects, shifted
    IJKL/UO translate; each edit repacks + rebuilds the BVH + resets
    accumulation, exactly like the reference's gizmo drag."""
    n = len(app.renderer.instances)
    if n == 0:
        return
    if app.input.key_pressed("tab"):
        state["gizmo"] = (state.get("gizmo", -1) + 1) % n
        app.ui.state.gizmo_instance = state["gizmo"]
    sel = state.get("gizmo", -1)
    if sel < 0:
        return
    for key, (dx, dy, dz) in GIZMO_KEYS.items():
        if app.input.key_pressed(key):
            t = np.array(app.renderer.instances[sel].transform, np.float32)
            t[0, 3] += dx
            t[1, 3] += dy
            t[2, 3] += dz
            app.set_instance_transform(sel, t)


def run_interactive(app, max_frames: int | None = None) -> None:
    """The live frame loop (main.rs:362-552): pump keys, handle toggles,
    render, present to the terminal."""
    cols, term_rows = shutil.get_terminal_size((100, 40))
    view_rows = max(term_rows - 3, 4)  # leave room for the HUD
    sys.stdout.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
    frame = 0
    state: dict = {}
    try:
        with StdinKeySource() as keys:
            while max_frames is None or frame < max_frames:
                app.input.begin_frame()
                keys.pump(app.input)
                if keys.quit_requested:
                    break
                for key, flag in TOGGLE_KEYS.items():
                    if app.input.key_pressed(key):
                        app.view = Ui.toggle_flag(app.view, flag)
                        app.reset_accumulation()
                if app.input.key_pressed("n"):
                    # composite the settings panel INTO the presented frame
                    # (ui.rs:56-75 egui-into-swapchain analog)
                    app.ui.state.overlay = not app.ui.state.overlay
                _handle_gizmo(app, state)
                img = app.present(app.render_frame()["present_output"])
                sys.stdout.write("\x1b[H")  # home
                sys.stdout.write(frame_to_ansi(img, cols, view_rows))
                sys.stdout.write("\n\x1b[0K" + _hud(app).replace("\n", "\n\x1b[0K"))
                sys.stdout.flush()
                frame += 1
    finally:
        sys.stdout.write("\x1b[?25h\n")  # show cursor
        sys.stdout.flush()

"""FPS timer over 1-second windows (rebuild of utopian/src/fps_timer.rs)."""

from __future__ import annotations

import time


class FpsTimer:
    def __init__(self) -> None:
        self._start = time.perf_counter()
        self._window_start = self._start
        self._frames_in_window = 0
        self.fps = 0.0
        self.frame_ms = 0.0

    def calculate(self) -> None:
        """Call once per frame (fps_timer.rs:25-35)."""
        now = time.perf_counter()
        self._frames_in_window += 1
        elapsed = now - self._window_start
        if elapsed >= 1.0:
            self.fps = self._frames_in_window / elapsed
            self.frame_ms = 1000.0 / self.fps if self.fps > 0 else 0.0
            self._frames_in_window = 0
            self._window_start = now

    def elapsed_seconds(self) -> float:
        """Wall-clock since creation; feeds `view.time` (main.rs:465)."""
        return time.perf_counter() - self._start

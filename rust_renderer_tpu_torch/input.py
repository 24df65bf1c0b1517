"""Keyboard/mouse input state (headless analog of utopian/src/input.rs).

The reference tracks key-down maps with pressed-edge detection
(input.rs:28-70) plus mouse position/delta and right-mouse-button state fed
from winit events. Here the same state object is driven programmatically (by
the offscreen app loop, the terminal viewer or tests): rendering is
headless. A copy of the JAX package's ``input.py``.
"""

from __future__ import annotations


class Input:
    def __init__(self) -> None:
        self._down: set[str] = set()
        self._pressed: set[str] = set()  # edge-triggered: down this frame
        self.mouse_pos = (0.0, 0.0)
        self.mouse_delta = (0.0, 0.0)
        self.right_mouse_down = False

    def begin_frame(self) -> None:
        """Clear per-frame edges (input.rs:28-36)."""
        self._pressed.clear()
        self.mouse_delta = (0.0, 0.0)

    def set_key_down(self, key: str) -> None:
        key = key.lower()
        if key not in self._down:
            self._pressed.add(key)
        self._down.add(key)

    def set_key_up(self, key: str) -> None:
        self._down.discard(key.lower())

    def move_mouse(self, x: float, y: float) -> None:
        px, py = self.mouse_pos
        self.mouse_delta = (x - px, y - py)
        self.mouse_pos = (x, y)

    def key_down(self, key: str) -> bool:
        return key.lower() in self._down

    def key_pressed(self, key: str) -> bool:
        """True only on the frame the key went down (input.rs:64-70)."""
        return key.lower() in self._pressed

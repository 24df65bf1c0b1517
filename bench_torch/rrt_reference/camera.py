"""The viewer's host side: its input state, the first-person camera rig
(W/A/S/D along the view, the right mouse turning yaw and pitch at -0.3
degrees a pixel, position and angles smoothed by half each frame), and the
view's matrices (right-handed, depth in [0, 1])."""

from __future__ import annotations

import numpy as np


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_rh(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    f = _normalize(np.asarray(center, np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, np.float32)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m


def perspective_rh(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    h = np.cos(0.5 * fov_y) / np.sin(0.5 * fov_y)
    r = far / (near - far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2], m[2, 3], m[3, 2] = h / aspect, h, r, r * near, -1.0
    return m


def orthographic_rh(left, right, bottom, top, near, far) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = 1.0 / (near - far)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = near / (near - far)
    return m


class Input:
    """Keys held and pressed this frame, the mouse and its right button."""

    def __init__(self):
        self._down, self._pressed = set(), set()
        self.mouse_pos = (0.0, 0.0)
        self.mouse_delta = (0.0, 0.0)
        self.right_mouse_down = False

    def begin_frame(self) -> None:
        self._pressed.clear()
        self.mouse_delta = (0.0, 0.0)

    def set_key_down(self, key: str) -> None:
        if key.lower() not in self._down:
            self._pressed.add(key.lower())
        self._down.add(key.lower())

    def set_key_up(self, key: str) -> None:
        self._down.discard(key.lower())

    def move_mouse(self, x: float, y: float) -> None:
        self.mouse_delta = (x - self.mouse_pos[0], y - self.mouse_pos[1])
        self.mouse_pos = (x, y)

    def key_down(self, key: str) -> bool:
        return key in self._down


class Camera:
    """60 degrees vertical field of view, near 0.01, far 1000, speed 0.2."""

    def __init__(self, eye, target, aspect: float):
        self.fov, self.aspect, self.near, self.far, self.speed = 60.0, aspect, 0.01, 1000.0, 0.2
        self.pos = np.asarray(eye, np.float32).copy()
        fwd = np.asarray(target, np.float32) - self.pos
        fwd = fwd / np.linalg.norm(fwd)
        self.yaw = float(np.arctan2(-fwd[0], -fwd[2]))
        self.pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))
        self.smooth_pos, self.smooth_yaw, self.smooth_pitch = self.pos.copy(), self.yaw, self.pitch

    @staticmethod
    def _forward(yaw: float, pitch: float) -> np.ndarray:
        cp = np.cos(pitch)
        return np.array([-np.sin(yaw) * cp, np.sin(pitch), -np.cos(yaw) * cp], np.float32)

    def update(self, inp: Input) -> None:
        fwd = self._forward(self.smooth_yaw, self.smooth_pitch)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
        rn = np.linalg.norm(right)
        right = right / rn if rn > 0 else right
        move = np.zeros(3, np.float32)
        for key, step in (("w", self.speed * fwd), ("s", -(self.speed * fwd)),
                          ("a", -(self.speed * right)), ("d", self.speed * right)):
            if inp.key_down(key):
                move += step
        self.pos += move
        if inp.right_mouse_down:
            dx, dy = inp.mouse_delta
            self.yaw += np.radians(-0.3 * dx)
            self.pitch = float(np.clip(self.pitch + np.radians(-0.3 * dy), -1.55, 1.55))
        self.smooth_pos = self.smooth_pos * 0.5 + self.pos * 0.5
        self.smooth_yaw = self.smooth_yaw * 0.5 + self.yaw * 0.5
        self.smooth_pitch = self.smooth_pitch * 0.5 + self.pitch * 0.5

    def view(self) -> np.ndarray:
        p = self.smooth_pos
        return look_at_rh(p, p + self._forward(self.smooth_yaw, self.smooth_pitch),
                          np.array([0.0, 1.0, 0.0], np.float32))

    def projection(self) -> np.ndarray:
        return perspective_rh(np.radians(self.fov), self.aspect, self.near, self.far)

    def uniforms(self) -> dict:
        view, proj = self.view(), self.projection()
        return {"view": view, "projection": proj,
                "inverse_view": np.linalg.inv(view).astype(np.float32),
                "inverse_projection": np.linalg.inv(proj).astype(np.float32),
                "eye": self.smooth_pos.copy()}

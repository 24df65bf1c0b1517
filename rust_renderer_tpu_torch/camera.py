"""First-person camera with smoothed position/rotation rig.

API-parity rebuild of the reference camera (utopian/src/camera.rs:15-133),
which wraps a dolly rig (Position + YawPitch + Smooth). We keep the same
public surface: ``new/update/get_view/get_projection/get_position/get_forward/
set_position_target`` plus near/far accessors, WASD + right-mouse-drag controls
(camera.rs:57-88) and a RH look-at view + RH [0,1]-depth perspective
(camera.rs:90-107).
"""

from __future__ import annotations

import numpy as np

from rust_renderer_tpu_torch.utils import math3d


class Camera:
    def __init__(
        self,
        pos,
        target,
        fov_degrees: float = 60.0,
        aspect_ratio: float = 2000.0 / 1100.0,
        z_near: float = 0.01,
        # 1000, NOT 20000: the reference app's far plane
        # (prototype/src/main.rs:44-52). The cascade frustum fit inherits
        # this range — a 20x-too-far plane made every CSM cascade cover km
        # of air and rasterized whole scenes into a sub-pixel speck
        # (all-ones shadow maps; found via the cascade golden, round 3).
        z_far: float = 1000.0,
        speed: float = 0.2,
    ):
        self.fov_degrees = float(fov_degrees)
        self.aspect_ratio = float(aspect_ratio)
        self.z_near = float(z_near)
        self.z_far = float(z_far)
        self.speed = float(speed)

        # Rig state: raw (driver) + smoothed (final transform).
        self._pos = np.asarray(pos, np.float32).copy()
        self._yaw, self._pitch = self._lookat_yaw_pitch(self._pos, np.asarray(target, np.float32))
        self._smooth_pos = self._pos.copy()
        self._smooth_yaw = self._yaw
        self._smooth_pitch = self._pitch
        # dolly Smooth::new_position_rotation(1.0, 1.0) — exponential smoothing
        # with ~1s half-response; per-frame blend factor at 60fps equivalent.
        self._smoothing = 0.5

    # -- rotation helpers ---------------------------------------------------

    @staticmethod
    def _lookat_yaw_pitch(pos: np.ndarray, target: np.ndarray) -> tuple[float, float]:
        """Yaw/pitch equivalent of Camera::get_lookat_rotation (camera.rs:43-55)."""
        fwd = target - pos
        n = np.linalg.norm(fwd)
        if n == 0:
            return 0.0, 0.0
        fwd = fwd / n
        yaw = float(np.arctan2(-fwd[0], -fwd[2]))  # yaw=0 faces -Z
        pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))
        return yaw, pitch

    def _forward_from(self, yaw: float, pitch: float) -> np.ndarray:
        cp = np.cos(pitch)
        return np.array(
            [-np.sin(yaw) * cp, np.sin(pitch), -np.cos(yaw) * cp], np.float32
        )

    # -- public API (parity with camera.rs) ---------------------------------

    def update(self, input_state) -> bool:
        """WASD movement + RMB-drag rotation (camera.rs:57-88).

        Returns True if the view changed (used by the app to reset progressive
        accumulation, main.rs:455-457).
        """
        movement = np.zeros(3, np.float32)
        fwd = self.get_forward()
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
        rn = np.linalg.norm(right)
        right = right / rn if rn > 0 else right
        if input_state.key_down("w"):
            movement += self.speed * fwd
        if input_state.key_down("s"):
            movement -= self.speed * fwd
        if input_state.key_down("a"):
            movement -= self.speed * right
        if input_state.key_down("d"):
            movement += self.speed * right

        self._pos += movement

        view_changed = False
        if input_state.right_mouse_down:
            dx, dy = input_state.mouse_delta
            # -0.3 deg per pixel, mirroring rotate_yaw_pitch(-0.3*dx, -0.3*dy)
            self._yaw += np.radians(-0.3 * dx)
            self._pitch += np.radians(-0.3 * dy)
            self._pitch = float(np.clip(self._pitch, -1.55, 1.55))
            view_changed = dx != 0.0 or dy != 0.0

        # Smooth rig update (camera.rs:86: camera_rig.update(1.0)).
        a = self._smoothing
        self._smooth_pos = self._smooth_pos * (1 - a) + self._pos * a
        self._smooth_yaw = self._smooth_yaw * (1 - a) + self._yaw * a
        self._smooth_pitch = self._smooth_pitch * (1 - a) + self._pitch * a

        return bool(np.any(movement != 0.0)) or view_changed

    def get_view(self) -> np.ndarray:
        pos = self._smooth_pos
        fwd = self._forward_from(self._smooth_yaw, self._smooth_pitch)
        return math3d.look_at_rh(pos, pos + fwd, np.array([0.0, 1.0, 0.0], np.float32))

    def get_projection(self) -> np.ndarray:
        return math3d.perspective_rh(
            np.radians(self.fov_degrees), self.aspect_ratio, self.z_near, self.z_far
        )

    def get_position(self) -> np.ndarray:
        return self._smooth_pos.copy()

    def get_forward(self) -> np.ndarray:
        return self._forward_from(self._smooth_yaw, self._smooth_pitch)

    def set_position_target(self, position, target) -> None:
        self._pos = np.asarray(position, np.float32).copy()
        self._yaw, self._pitch = self._lookat_yaw_pitch(
            self._pos, np.asarray(target, np.float32)
        )
        self._smooth_pos = self._pos.copy()
        self._smooth_yaw, self._smooth_pitch = self._yaw, self._pitch

    def get_near_plane(self) -> float:
        return self.z_near

    def get_far_plane(self) -> float:
        return self.z_far

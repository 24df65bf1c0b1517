"""Small 3D math helpers (host-side, numpy float32).

Conventions follow the reference's glam usage: right-handed view space,
clip-space depth in [0, 1] (Vulkan convention; glam's Mat4::perspective_rh /
orthographic_rh used at utopian/src/camera.rs:98-107 and
utopian/src/renderers/shadow.rs:96-106). Matrices are (4,4) numpy arrays
applied as ``m @ v`` to column vectors.
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (glam::Mat4::look_at_rh semantics)."""
    eye = np.asarray(eye, np.float32)
    f = normalize(np.asarray(center, np.float32) - eye)  # forward
    s = normalize(np.cross(f, np.asarray(up, np.float32)))  # right
    u = np.cross(s, f)  # true up
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_rh(fov_y_radians: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """RH perspective with [0,1] depth (glam::Mat4::perspective_rh)."""
    sin_fov = np.sin(0.5 * fov_y_radians)
    cos_fov = np.cos(0.5 * fov_y_radians)
    h = cos_fov / sin_fov
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def orthographic_rh(left, right, bottom, top, near, far) -> np.ndarray:
    """RH orthographic with [0,1] depth (glam::Mat4::orthographic_rh)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = 1.0 / (near - far)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = near / (near - far)
    return m


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    s = np.asarray(s, np.float32)
    if s.ndim == 0:
        s = np.full(3, float(s), np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) to 3x3 rotation matrix (glTF convention)."""
    x, y, z, w = np.asarray(q, np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def trs(t, r_quat, s) -> np.ndarray:
    """Compose translation * rotation * scale (glTF node transform order)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_mat3(r_quat) * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to (N,3) points."""
    p = pts @ m[:3, :3].T + m[:3, 3]
    return p.astype(np.float32)


def transform_dirs(m: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Apply a 4x4's rotation/scale to (N,3) direction vectors."""
    return (dirs @ m[:3, :3].T).astype(np.float32)


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Apply inverse-transpose rotation to (N,3) normals and renormalize."""
    it = np.linalg.inv(m[:3, :3]).T
    n = normals @ it.T
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)

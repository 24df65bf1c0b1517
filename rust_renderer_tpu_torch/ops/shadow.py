"""Cascaded shadow maps: split math, cascade fitting, PCF lookup (the port
of ``rust_renderer_tpu/ops/shadow.py``).

Host-side cascade math of utopian/src/renderers/shadow.rs (the GPU Gems 3
ch.10 log/uniform split with lambda 0.927, one orthographic projection per
cascade fitted to the bounding sphere of its frustum slice, radius snapped
to 1/16) and the lookup of utopian/shaders/include/shadow_mapping.glsl
(cascade by view-space depth, 3x3 PCF, bias 0.0005, shadow factor 0.3).
"""

from __future__ import annotations

import numpy as np
import torch

from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.rays import apply_rows
from rust_renderer_tpu_torch.utils import math3d

CASCADE_COUNT = 4
CASCADE_SPLIT_LAMBDA = 0.927
SHADOW_BIAS = 0.0005
SHADOW_FACTOR = 0.3

_DEBUG_COLORS = ((1.0, 0.25, 0.25), (0.25, 1.0, 0.25), (0.25, 0.25, 1.0), (1.0, 1.0, 0.25))


def cascade_splits(near: float, far: float, count: int = CASCADE_COUNT,
                   split_lambda: float = CASCADE_SPLIT_LAMBDA) -> np.ndarray:
    """Normalized split positions in (0,1] (shadow.rs:36-46)."""
    clip_range = far - near
    ratio = far / near
    out = np.empty(count, np.float32)
    for i in range(count):
        p = (i + 1) / count
        log = near * ratio**p
        uniform = near + clip_range * p
        d = split_lambda * (log - uniform) + uniform
        out[i] = (d - near) / clip_range
    return out


def cascade_matrices(view: np.ndarray, projection: np.ndarray, near: float, far: float,
                     sun_dir: np.ndarray, count: int = CASCADE_COUNT):
    """Per-cascade light view-projection matrices (count, 4, 4) and split
    depths (count,) (shadow.rs:49-131), in numpy on the host."""
    splits = cascade_splits(near, far, count)
    clip_range = far - near
    corners_ndc = np.array(
        [[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0],
         [-1, 1, 1], [1, 1, 1], [1, -1, 1], [-1, -1, 1]], np.float32)
    inv_cam = np.linalg.inv(projection @ view)
    corners = []
    for c in corners_ndc:
        h = inv_cam @ np.append(c, 1.0)
        corners.append(h[:3] / h[3])
    corners = np.stack(corners)

    matrices = np.zeros((count, 4, 4), np.float32)
    split_depths = np.zeros(count, np.float32)
    last_split = 0.0
    for i in range(count):
        split = float(splits[i])
        fc = corners.copy()
        for k in range(4):
            dist = fc[k + 4] - fc[k]
            fc[k + 4] = fc[k] + dist * split
            fc[k] = fc[k] + dist * last_split
        center = fc.mean(0)
        radius = float(np.max(np.linalg.norm(fc - center, axis=-1)))
        radius = np.ceil(radius * 16.0) / 16.0
        max_extents = np.array([radius] * 3, np.float32)
        min_extents = -max_extents
        light_view = math3d.look_at_rh(
            center - sun_dir * min_extents[2], center, np.array([0.0, 1.0, 0.0]))
        light_ortho = math3d.orthographic_rh(
            min_extents[0], max_extents[0], min_extents[1], max_extents[1],
            -(max_extents[2] - min_extents[2]), max_extents[2] - min_extents[2])
        matrices[i] = light_ortho @ light_view
        split_depths[i] = near + split * clip_range
        last_split = split
    return matrices, split_depths


def calculate_shadow(position, view_matrix, shadow_map, cascade_view_proj,
                     cascade_split_depths):
    """Per-pixel CSM factor (shadow_mapping.glsl:8-54).

    position (H, W, 3) world; shadow_map (C, S, S); cascade_view_proj
    (C, 4, 4); cascade_split_depths (C,). Cascade by view-space z, 3x3 PCF
    with clamped taps, lit outside the light's depth range. Returns
    (shadow (H, W), cascade (H, W) int64)."""
    n_cascades, size = shadow_map.shape[0], shadow_map.shape[1]
    view_z = apply_rows(position, view_matrix[2:3])[..., 0]
    cascade = torch.zeros(position.shape[:-1], dtype=torch.int64, device=position.device)
    for i in range(n_cascades - 1):
        cascade = torch.where(view_z < -cascade_split_depths[i], i + 1, cascade)

    lsp = torch.zeros(position.shape, dtype=torch.float32, device=position.device)
    lsw = torch.zeros(position.shape[:-1], dtype=torch.float32, device=position.device)
    for i in range(n_cascades):
        m = cascade_view_proj[i]
        sel = cascade == i
        lsp = torch.where(sel[..., None], apply_rows(position, m[:3]), lsp)
        lsw = torch.where(sel, apply_rows(position, m[3:4])[..., 0], lsw)
    proj = lsp / torch.clamp_min(lsw.abs(), 1e-9)[..., None] * torch.sign(lsw)[..., None]
    uv = proj[..., :2] * 0.5 + 0.5
    depth_ref = proj[..., 2]
    in_range = (depth_ref <= 1.0) & (depth_ref > -1.0)

    x0 = torch.floor(uv[..., 0] * size).to(torch.int64)
    y0 = torch.floor((1.0 - uv[..., 1]) * size).to(torch.int64)  # FLIP_UV_Y
    flat = shadow_map.reshape(-1)
    shadow = torch.zeros(position.shape[:-1], dtype=torch.float32, device=position.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx = (x0 + dx).clamp(0, size - 1)
            cy = (y0 + dy).clamp(0, size - 1)
            closest = flat[(cascade * size + cy) * size + cx]
            lit = torch.where(depth_ref - SHADOW_BIAS > closest, SHADOW_FACTOR, 1.0)
            shadow = shadow + torch.where(in_range, lit, 1.0)
    return shadow / 9.0, cascade


def cascade_debug_color(cascade: torch.Tensor) -> torch.Tensor:
    """shadow_mapping.glsl:56-68: one tint per cascade, (..., 3)."""
    colors = device_constant(_DEBUG_COLORS, cascade.device)
    return colors[cascade.clamp(0, 3)]

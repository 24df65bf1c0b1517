"""Cascaded shadow maps: the cascades fitted on the host, their depth
rasterized, and the 3 x 3 percentage-closer lookup.

The split between cascades mixes logarithmic and uniform splits with
lambda 0.927; each cascade is an orthographic view along the sun that
holds the bounding sphere of its slice of the frustum, its radius rounded
up to 1/16. A texel's depth is the least depth, in [0, 1], of the
triangles that cover its centre (both windings, the part in front of the
near plane), 1 where none does. A pixel is lit (1) or shadowed (0.3) by
each of the nine texels around its own, with a bias of 0.0005; outside
its cascade's depth range it is lit."""

from __future__ import annotations

import numpy as np
import torch

from rrt_reference.camera import look_at_rh, orthographic_rh

LAMBDA, BIAS, SHADOWED = 0.927, 0.0005, 0.3
_PAIRS = 1 << 25  # (triangle, texel) pairs rasterized at a time


def cascades(view, projection, near: float, far: float, sun, count: int):
    """(count, 4, 4) light view-projections and the split depths (count,)."""
    rng = far - near
    ratio = far / near
    splits = np.empty(count, np.float32)
    for i in range(count):
        p = (i + 1) / count
        log, uniform = near * ratio ** p, near + rng * p
        splits[i] = (LAMBDA * (log - uniform) + uniform - near) / rng
    ndc = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0],
                    [-1, 1, 1], [1, 1, 1], [1, -1, 1], [-1, -1, 1]], np.float32)
    inv = np.linalg.inv(projection @ view)
    corners = []
    for c in ndc:
        h = inv @ np.append(c, 1.0)
        corners.append(h[:3] / h[3])
    corners = np.stack(corners)
    mats = np.zeros((count, 4, 4), np.float32)
    depths = np.zeros(count, np.float32)
    last = 0.0
    for i in range(count):
        split = float(splits[i])
        fc = corners.copy()
        for k in range(4):
            dist = fc[k + 4] - fc[k]
            fc[k + 4] = fc[k] + dist * split
            fc[k] = fc[k] + dist * last
        center = fc.mean(0)
        radius = float(np.max(np.linalg.norm(fc - center, axis=-1)))
        radius = np.ceil(radius * 16.0) / 16.0
        ext = np.array([radius] * 3, np.float32)
        light_view = look_at_rh(center - sun * -ext[2], center, np.array([0.0, 1.0, 0.0]))
        ortho = orthographic_rh(-ext[0], ext[0], -ext[1], ext[1],
                                -(ext[2] + ext[2]), ext[2] + ext[2])
        mats[i] = ortho @ light_view
        depths[i] = near + split * rng
        last = split
    return mats, depths


def depth_map(v: torch.Tensor, mvp: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size) depth of the triangles `v` (T, 3, 3) seen through the
    orthographic `mvp`."""
    dev = v.device
    homo = torch.cat([v.reshape(-1, 3), torch.ones(v.shape[0] * 3, 1, device=dev)], dim=1)
    clip = (homo @ mvp.T).view(-1, 3, 4)
    ndc = clip[..., :3] / clip[..., 3:4]
    sx = (ndc[..., 0] * 0.5 + 0.5) * size
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * size
    z = ndc[..., 2]
    x0, x1, x2 = sx.unbind(1)
    y0, y1, y2 = sy.unbind(1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    lo_x = torch.floor(sx.amin(1) - 0.5).clamp(0, size - 1).long()
    hi_x = torch.ceil(sx.amax(1) - 0.5).clamp(0, size - 1).long()
    lo_y = torch.floor(sy.amin(1) - 0.5).clamp(0, size - 1).long()
    hi_y = torch.ceil(sy.amax(1) - 0.5).clamp(0, size - 1).long()
    keep = (area.abs() > 1e-12) & (z.amax(1) >= 0.0) & (z.amin(1) <= 1.0) \
        & (sx.amax(1) >= 0) & (sx.amin(1) <= size) & (sy.amax(1) >= 0) & (sy.amin(1) <= size)
    tri = torch.nonzero(keep).squeeze(1)
    w = (hi_x - lo_x + 1)[tri]
    count = w * (hi_y - lo_y + 1)[tri]
    depth = torch.ones(size * size, device=dev)
    ends = torch.cumsum(count, 0)
    start = 0
    while start < tri.numel():
        first = int(ends[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(ends, first + _PAIRS, right=True)), start + 1)
        n = count[start:stop]
        owner = torch.repeat_interleave(torch.arange(start, stop, device=dev), n)
        local = torch.arange(int(n.sum()), device=dev) - (ends[owner] - count[owner] - first)
        t = tri[owner]
        px = lo_x[t] + local % w[owner]
        py = lo_y[t] + local // w[owner]
        fx, fy = px.float() + 0.5, py.float() + 0.5
        a, ax0, ay0 = area[t], x0[t], y0[t]
        inv_area = 1.0 / a
        l1 = ((fx - ax0) * (y2[t] - ay0) - (x2[t] - ax0) * (fy - ay0)) * inv_area
        l2 = ((x1[t] - ax0) * (fy - ay0) - (fx - ax0) * (y1[t] - ay0)) * inv_area
        l0 = 1.0 - l1 - l2
        zz = l0 * z[t, 0] + l1 * z[t, 1] + l2 * z[t, 2]
        inside = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (zz >= 0.0)
        zz = torch.where(inside, zz, torch.ones_like(zz))
        depth.scatter_reduce_(0, py * size + px, zz, reduce="amin")
        start = stop
    return depth.view(size, size)


def lookup(position, view, maps, mats, depths):
    """(H, W) shadow factor of world positions (H, W, 3)."""
    n, size = maps.shape[0], maps.shape[1]
    view_z = position @ view[2, :3] + view[2, 3]
    cascade = torch.zeros(view_z.shape, dtype=torch.int64, device=position.device)
    for i in range(n - 1):
        cascade = torch.where(view_z < -depths[i], torch.full_like(cascade, i + 1), cascade)
    lsp = torch.zeros(position.shape, device=position.device)
    lsw = torch.zeros(view_z.shape, device=position.device)
    for i in range(n):
        m = mats[i]
        sel = cascade == i
        lsp = torch.where(sel[..., None], position @ m[:3, :3].T + m[:3, 3], lsp)
        lsw = torch.where(sel, position @ m[3, :3] + m[3, 3], lsw)
    proj = lsp / torch.clamp(lsw.abs(), min=1e-9)[..., None] * torch.sign(lsw)[..., None]
    depth_ref = proj[..., 2]
    in_range = (depth_ref <= 1.0) & (depth_ref > -1.0)
    x0 = torch.floor((proj[..., 0] * 0.5 + 0.5) * size).long()
    y0 = torch.floor((1.0 - (proj[..., 1] * 0.5 + 0.5)) * size).long()
    flat = maps.reshape(-1)
    total = torch.zeros(view_z.shape, device=position.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx = (x0 + dx).clamp(0, size - 1)
            cy = (y0 + dy).clamp(0, size - 1)
            closest = flat[(cascade * size + cy) * size + cx]
            lit = torch.where(depth_ref - BIAS > closest, SHADOWED, 1.0)
            total = total + torch.where(in_range, lit, torch.ones_like(lit))
    return total / 9.0

"""Marching cubes over the reference's animated SDF (the port of
``rust_renderer_tpu/ops/marching_cubes.py``;
utopian/shaders/marching_cubes/marching_cubes.comp).

Every voxel owns MAX_TRIS_PER_VOXEL triangle slots; unused slots are
collapsed to the origin (degenerate, they rasterize to nothing).
`vertex_count` is the reference's DrawIndirectCommand.vertexCount. The
triangle table (P. Bourke's public-domain table) is read by path from the
JAX package's ``ops/mc_tables.bin``. The extraction's constants (the
tables, corner offsets, the SDF's centres) are device tensors made once per
device and value, so a frame copies nothing from the host.
"""

from __future__ import annotations

import functools
import os
import zlib
from typing import NamedTuple

import numpy as np
import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops.constants import device_constant

TABLES_PATH = os.path.join(native.REPO_DIR, "rust_renderer_tpu", "ops", "mc_tables.bin")
MAX_TRIS_PER_VOXEL = 5
# Edge -> (corner a, corner b), Bourke numbering; corner offsets follow
# renderers/marching_cubes.rs:25-34.
_EDGE_CORNERS = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
                 (0, 4), (1, 5), (2, 6), (3, 7))
_CORNER_OFFSETS = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.float32)


@functools.lru_cache(maxsize=None)
def tables() -> tuple[np.ndarray, np.ndarray]:
    """(tri_table (256, 16) int32, triangles per case (256,) int32)."""
    with open(TABLES_PATH, "rb") as f:
        tri = np.frombuffer(zlib.decompress(f.read()), np.int8).reshape(256, 16)
    tri = tri.astype(np.int32)
    return tri, ((tri >= 0).sum(1) // 3).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`tables()` on `device`, made once."""
    tri, count = tables()
    return torch.tensor(tri, device=device), torch.tensor(count, device=device)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def default_density(pos: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """marching_cubes.comp density(): a solid (-1) with a torus at
    (10,20,10), a box at (10,10,10) and a sphere at (10,26,10) pulsing with
    |sin(0.3 t)| carved out by max(-sdf, d)."""
    vec = lambda *v: device_constant(v, pos.device)
    d = torch.full(pos.shape[:-1], -1.0, dtype=torch.float32, device=pos.device)
    p = pos - vec(10.0, 20.0, 10.0)
    # (x, z) by a strided slice, copied contiguous as the list index did
    # (a list index is copied to the device as a tensor first)
    q = torch.stack([_norm(p[..., 0::2].contiguous()) - 5.0, p[..., 1]], dim=-1)
    d = torch.maximum(-(_norm(q) - 3.0), d)
    p = (pos - vec(10.0, 10.0, 10.0)).abs() - vec(5.0, 5.0, 5.0)
    box = _norm(torch.clamp_min(p, 0.0)) + torch.clamp_max(
        torch.maximum(p[..., 0], torch.maximum(p[..., 1], p[..., 2])), 0.0)
    d = torch.maximum(-box, d)
    r = 8.0 * torch.abs(torch.sin(time * 0.3))
    return torch.maximum(-(_norm(pos - vec(10.0, 26.0, 10.0)) - r), d)


class MarchingCubesResult(NamedTuple):
    positions: torch.Tensor  # (T, 3, 3) triangle vertices (degenerate = unused)
    normals: torch.Tensor  # (T, 3, 3) per-vertex gradient normals
    valid: torch.Tensor  # (T,) bool
    vertex_count: torch.Tensor  # scalar int32


def marching_cubes(density_fn=default_density, grid: int = 32, voxel_size: float = 1.0,
                   iso_level: float = 0.0, time=0.0, flat_normals: bool = False, *,
                   device=None) -> MarchingCubesResult:
    """Extract the isosurface: grid^3 * MAX_TRIS_PER_VOXEL slots, slot-major
    (all voxels' first triangle, then all second ones, ...), on the device of
    `time` when it is a tensor, else on `device`, which must then be given."""
    if device is None and not torch.is_tensor(time):
        raise ValueError("marching_cubes needs a device, or a time tensor on one")
    time = torch.as_tensor(time, dtype=torch.float32, device=device)
    dev = time.device
    tri_table, tri_count = _device_tables(dev)

    n1 = grid + 1
    ii = torch.arange(n1, dtype=torch.float32, device=dev) * voxel_size
    lattice = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), dim=-1)
    dens = density_fn(lattice, time)  # (n1, n1, n1)

    vi = torch.arange(grid, device=dev)
    vx, vy, vz = (a.reshape(-1) for a in torch.meshgrid(vi, vi, vi, indexing="ij"))
    offsets = _CORNER_OFFSETS.astype(np.int64)
    corner_d = torch.stack([dens[vx + cx, vy + cy, vz + cz] for cx, cy, cz in offsets], -1)
    case = torch.zeros(corner_d.shape[0], dtype=torch.int64, device=dev)
    for i in range(8):
        case = case | torch.where(corner_d[:, i] < iso_level, 1 << i, 0)

    base = torch.stack([vx, vy, vz], dim=-1).to(torch.float32) * voxel_size
    corner = device_constant(tuple(map(tuple, (_CORNER_OFFSETS * voxel_size).tolist())), dev)
    edge_pos = []
    for a, b in _EDGE_CORNERS:
        pa, pb = base + corner[a], base + corner[b]
        va, vb = corner_d[:, a], corner_d[:, b]
        t = (iso_level - va) / torch.where((vb - va).abs() < 1e-12, 1e-12, vb - va)
        edge_pos.append(pa + (pb - pa) * torch.clamp(t, 0.0, 1.0)[:, None])
    edge_pos = torch.stack(edge_pos, dim=1)  # (V, 12, 3)

    entries = tri_table[case]  # (V, 16)
    rows = torch.arange(entries.shape[0], device=dev)
    tris, valids = [], []
    for s in range(MAX_TRIS_PER_VOXEL):
        e = entries[:, 3 * s:3 * s + 3]
        ok = e[:, 0] >= 0
        tri = edge_pos[rows[:, None], e.clamp_min(0)]  # (V, 3, 3)
        tris.append(torch.where(ok[:, None, None], tri, 0.0))
        valids.append(ok)
    positions = torch.cat(tris)
    valid = torch.cat(valids)

    if flat_normals:
        face_n = torch.linalg.cross(positions[:, 1] - positions[:, 0],
                                    positions[:, 2] - positions[:, 0])
        face_n = face_n / torch.clamp_min(_norm(face_n)[..., None], 1e-12)
        normals = face_n[:, None, :].expand(-1, 3, -1)
    else:
        flat_v = positions.reshape(-1, 3)
        grads = []
        for axis in range(3):
            off = device_constant(tuple(float(i == axis) for i in range(3)), dev)
            grads.append(density_fn(flat_v + off, time) - density_fn(flat_v - off, time))
        grad = torch.stack(grads, dim=-1)
        normals = (-grad / torch.clamp_min(_norm(grad)[..., None], 1e-12)).reshape(
            positions.shape)
    vertex_count = 3 * tri_count[case].sum()
    return MarchingCubesResult(positions=positions, normals=normals, valid=valid,
                               vertex_count=vertex_count.to(torch.int32))


def compact(result: MarchingCubesResult, capacity: int):
    """Prefix-sum compaction of the valid triangles into a buffer of
    `capacity` (the reference's atomicAdd append, in slot order). Returns
    (positions (capacity, 3, 3), normals, count), count the valid triangles
    kept as a () int32 tensor; unfilled rows are zero."""
    valid = result.valid
    idx = torch.cumsum(valid.to(torch.int64), 0) - 1
    idx = torch.where(valid & (idx < capacity), idx, capacity)  # the overflow row
    out = []
    for x in (result.positions, result.normals):
        buf = x.new_zeros((capacity + 1,) + tuple(x.shape[1:]))
        buf[idx] = x  # row `capacity` takes the invalid and overflowing rows
        out.append(buf[:capacity])
    count = torch.clamp_max(valid.sum(), capacity).to(torch.int32)
    return out[0], out[1], count

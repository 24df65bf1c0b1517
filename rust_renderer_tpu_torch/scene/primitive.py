"""Vertex / Primitive: host-side geometry containers.

Mirrors utopian/src/primitive.rs (per-vertex pos, normal, uv, color,
tangent) as struct-of-arrays numpy, packed later into device pools by the
Renderer, instead of interleaved GPU vertex buffers; there is no
fixed-function vertex fetch to feed, and SoA is what vectorized kernels want.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Vertex:
    """Scalar convenience constructor (primitive.rs:27-37)."""

    pos: np.ndarray
    normal: np.ndarray
    uv: np.ndarray
    color: np.ndarray
    tangent: np.ndarray

    @staticmethod
    def new(x: float, y: float, z: float) -> "Vertex":
        return Vertex(pos=np.array([x, y, z], np.float32), normal=np.zeros(3, np.float32),
                      uv=np.zeros(2, np.float32), color=np.ones(4, np.float32),
                      tangent=np.zeros(4, np.float32))


@dataclasses.dataclass
class Primitive:
    """SoA geometry for one mesh primitive (primitive.rs:19-70).

    positions: (V,3) f32; normals: (V,3); uvs: (V,2); colors: (V,4);
    tangents: (V,4) (w = handedness); indices: (I,) u32, triangle list.
    """

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    colors: np.ndarray
    tangents: np.ndarray
    indices: np.ndarray

    def __post_init__(self) -> None:
        v = len(self.positions)
        assert self.normals.shape == (v, 3)
        assert self.uvs.shape == (v, 2)
        assert self.colors.shape == (v, 4)
        assert self.tangents.shape == (v, 4)
        assert self.indices.ndim == 1 and self.indices.size % 3 == 0

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return self.indices.size // 3

    @staticmethod
    def from_vertices(indices, vertices: list[Vertex]) -> "Primitive":
        stack = lambda field, n: np.stack(
            [getattr(v, field)[:n] for v in vertices]).astype(np.float32)
        return Primitive(positions=stack("pos", 3), normals=stack("normal", 3),
                         uvs=stack("uv", 2), colors=stack("color", 4),
                         tangents=stack("tangent", 4), indices=np.asarray(indices, np.uint32))

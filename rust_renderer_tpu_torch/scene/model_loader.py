"""Procedural models (rebuild of utopian/src/model_loader.rs)."""

from __future__ import annotations

import numpy as np

from rust_renderer_tpu_torch.scene.gltf_loader import Material, Mesh, Model
from rust_renderer_tpu_torch.scene.primitive import Primitive


def _soa(verts: list[tuple], indices: list[int]) -> Primitive:
    """verts: list of (x,y,z, nx,ny,nz, u,v) (model_loader.rs:17-35)."""
    a = np.asarray(verts, np.float32)
    n = len(verts)
    return Primitive(
        positions=a[:, 0:3].copy(),
        normals=a[:, 3:6].copy(),
        uvs=a[:, 6:8].copy(),
        colors=np.ones((n, 4), np.float32),
        tangents=np.zeros((n, 4), np.float32),
        indices=np.asarray(indices, np.uint32),
    )


class ModelLoader:
    @staticmethod
    def load_cube() -> Model:
        """Hand-built 24-vertex cube (model_loader.rs:67-155). Winding and the
        intentionally flipped top/bottom normals of the reference are kept."""
        indices: list[int] = []

        def tri(a, b, c):
            indices.extend([a, b, c])

        # Front / Back / Top / Bottom / Left / Right (model_loader.rs:79-99)
        tri(2, 0, 1); tri(0, 2, 3)
        tri(4, 6, 5); tri(6, 4, 7)
        tri(10, 8, 9); tri(8, 10, 11)
        tri(12, 14, 13); tri(14, 12, 15)
        tri(16, 18, 17); tri(18, 16, 19)
        tri(22, 20, 21); tri(20, 22, 23)

        verts = [
            # Front (+Z)
            (-0.5, -0.5, 0.5, 0.0, 0.0, 1.0, 0.0, 1.0),
            (0.5, -0.5, 0.5, 0.0, 0.0, 1.0, 1.0, 1.0),
            (0.5, 0.5, 0.5, 0.0, 0.0, 1.0, 1.0, 0.0),
            (-0.5, 0.5, 0.5, 0.0, 0.0, 1.0, 0.0, 0.0),
            # Back (-Z)
            (-0.5, -0.5, -0.5, 0.0, 0.0, -1.0, 0.0, 1.0),
            (0.5, -0.5, -0.5, 0.0, 0.0, -1.0, 1.0, 1.0),
            (0.5, 0.5, -0.5, 0.0, 0.0, -1.0, 1.0, 0.0),
            (-0.5, 0.5, -0.5, 0.0, 0.0, -1.0, 0.0, 0.0),
            # Top (reference uses -Y normal here, model_loader.rs:113-117)
            (-0.5, -0.5, -0.5, 0.0, -1.0, 0.0, 0.0, 1.0),
            (0.5, -0.5, -0.5, 0.0, -1.0, 0.0, 1.0, 1.0),
            (0.5, -0.5, 0.5, 0.0, -1.0, 0.0, 1.0, 0.0),
            (-0.5, -0.5, 0.5, 0.0, -1.0, 0.0, 0.0, 0.0),
            # Bottom (+Y, model_loader.rs:119-123)
            (-0.5, 0.5, -0.5, 0.0, 1.0, 0.0, 0.0, 1.0),
            (0.5, 0.5, -0.5, 0.0, 1.0, 0.0, 1.0, 1.0),
            (0.5, 0.5, 0.5, 0.0, 1.0, 0.0, 1.0, 0.0),
            (-0.5, 0.5, 0.5, 0.0, 1.0, 0.0, 0.0, 0.0),
            # Left (-X)
            (-0.5, -0.5, -0.5, -1.0, 0.0, 0.0, 0.0, 1.0),
            (-0.5, 0.5, -0.5, -1.0, 0.0, 0.0, 1.0, 1.0),
            (-0.5, 0.5, 0.5, -1.0, 0.0, 0.0, 1.0, 0.0),
            (-0.5, -0.5, 0.5, -1.0, 0.0, 0.0, 0.0, 0.0),
            # Right (+X)
            (0.5, -0.5, -0.5, 1.0, 0.0, 0.0, 0.0, 1.0),
            (0.5, 0.5, -0.5, 1.0, 0.0, 0.0, 1.0, 1.0),
            (0.5, 0.5, 0.5, 1.0, 0.0, 0.0, 1.0, 0.0),
            (0.5, -0.5, 0.5, 1.0, 0.0, 0.0, 0.0, 0.0),
        ]
        return Model(
            meshes=[Mesh(primitive=_soa(verts, indices), material=Material())],
            transforms=[np.eye(4, dtype=np.float32)],
        )

    @staticmethod
    def load_sphere(stacks: int = 32, slices: int = 64, radius: float = 1.0) -> Model:
        """UV sphere; the analog of utopian/data/models/sphere.gltf for tests
        and the RTIOW scene when asset loading is not wanted."""
        phis = np.linspace(0.0, np.pi, stacks + 1)
        thetas = np.linspace(0.0, 2.0 * np.pi, slices + 1)
        pp, tt = np.meshgrid(phis, thetas, indexing="ij")
        x = np.sin(pp) * np.cos(tt)
        y = np.cos(pp)
        z = np.sin(pp) * np.sin(tt)
        pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
        normals = pos.copy()
        uv = np.stack([tt / (2 * np.pi), pp / np.pi], -1).reshape(-1, 2).astype(np.float32)

        idx = []
        for i in range(stacks):
            for j in range(slices):
                a = i * (slices + 1) + j
                b = a + slices + 1
                idx.extend([a, b, a + 1, a + 1, b, b + 1])
        prim = Primitive(
            positions=pos * radius,
            normals=normals,
            uvs=uv,
            colors=np.ones((len(pos), 4), np.float32),
            tangents=np.zeros((len(pos), 4), np.float32),
            indices=np.asarray(idx, np.uint32),
        )
        return Model(
            meshes=[Mesh(primitive=prim, material=Material())],
            transforms=[np.eye(4, dtype=np.float32)],
        )

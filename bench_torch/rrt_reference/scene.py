"""The scenes the benchmark renders, built on the host from the renderer's
scene definitions (the procedural Sponza stand-in at Sponza's triangle
count, and the cube grid), flattened to world-space triangle tables.

Every mesh gets a material of its own, in the order the meshes are added;
texture 0 is white, 1 a flat normal map, 2 the default metallic-roughness
map (roughness 1, metallic 0), and a model's own textures follow. One more
material, for the animated isosurface, closes the table."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TEXTURE_SIZE = 512


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


def _cube():
    """The 24-vertex unit cube: (positions, normals, uvs, indices). Its
    top face carries a -Y normal and its bottom face +Y."""
    faces = [  # (vertices as (x, y, z, nx, ny, nz, u, v))
        [(-.5, -.5, .5, 0, 0, 1, 0, 1), (.5, -.5, .5, 0, 0, 1, 1, 1),
         (.5, .5, .5, 0, 0, 1, 1, 0), (-.5, .5, .5, 0, 0, 1, 0, 0)],
        [(-.5, -.5, -.5, 0, 0, -1, 0, 1), (.5, -.5, -.5, 0, 0, -1, 1, 1),
         (.5, .5, -.5, 0, 0, -1, 1, 0), (-.5, .5, -.5, 0, 0, -1, 0, 0)],
        [(-.5, -.5, -.5, 0, -1, 0, 0, 1), (.5, -.5, -.5, 0, -1, 0, 1, 1),
         (.5, -.5, .5, 0, -1, 0, 1, 0), (-.5, -.5, .5, 0, -1, 0, 0, 0)],
        [(-.5, .5, -.5, 0, 1, 0, 0, 1), (.5, .5, -.5, 0, 1, 0, 1, 1),
         (.5, .5, .5, 0, 1, 0, 1, 0), (-.5, .5, .5, 0, 1, 0, 0, 0)],
        [(-.5, -.5, -.5, -1, 0, 0, 0, 1), (-.5, .5, -.5, -1, 0, 0, 1, 1),
         (-.5, .5, .5, -1, 0, 0, 1, 0), (-.5, -.5, .5, -1, 0, 0, 0, 0)],
        [(.5, -.5, -.5, 1, 0, 0, 0, 1), (.5, .5, -.5, 1, 0, 0, 1, 1),
         (.5, .5, .5, 1, 0, 0, 1, 0), (.5, -.5, .5, 1, 0, 0, 0, 0)],
    ]
    a = np.asarray([v for f in faces for v in f], np.float32)
    # Per face: front, back (flipped), top, bottom (flipped), left, right (flipped).
    pattern = [(2, 0, 1, 0, 2, 3), (0, 2, 1, 2, 0, 3), (2, 0, 1, 0, 2, 3),
               (0, 2, 1, 2, 0, 3), (0, 2, 1, 2, 0, 3), (2, 0, 1, 0, 2, 3)]
    idx = [4 * f + k for f, p in enumerate(pattern) for k in p]
    return a[:, 0:3].copy(), a[:, 3:6].copy(), a[:, 6:8].copy(), np.asarray(idx, np.int64)


def _sphere(stacks: int, slices: int):
    """A UV sphere of radius 1: (positions, normals, uvs, indices)."""
    phis = np.linspace(0.0, np.pi, stacks + 1)
    thetas = np.linspace(0.0, 2.0 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phis, thetas, indexing="ij")
    pos = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp), np.sin(pp) * np.sin(tt)],
                   -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), pp / np.pi], -1).reshape(-1, 2).astype(np.float32)
    i = np.arange(stacks)[:, None]
    j = np.arange(slices)[None, :]
    a = (i * (slices + 1) + j).reshape(-1)
    b = a + slices + 1
    idx = np.stack([a, b, a + 1, a + 1, b, b + 1], -1).reshape(-1)
    return pos, pos.copy(), uv, idx.astype(np.int64)


class _Builder:
    def __init__(self):
        white = np.full((TEXTURE_SIZE, TEXTURE_SIZE, 4), 255, np.uint8)
        normal = white.copy()
        normal[..., 0:2] = 128
        mr = np.zeros_like(white)
        mr[..., 1] = 255
        mr[..., 3] = 255
        self.textures = [white, normal, mr]
        self.materials = []  # (diffuse map, base colour (4), metallic, roughness, rt type)
        self.meshes = []  # (positions, normals, uvs, indices, material)
        self.lights = []
        self.eye = self.target = None

    def add(self, prim, transform, base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.5,
            rt_type=0, texture=None):
        diffuse = 0
        if texture is not None:
            diffuse = len(self.textures)
            self.textures.append(texture)
        self.materials.append((diffuse, np.asarray(base_color, np.float32), 0.0,
                               float(roughness), int(rt_type)))
        pos, nrm, uv, idx = prim
        m = np.asarray(transform, np.float32)
        world = (pos @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        it = np.linalg.inv(m[:3, :3]).T
        n = nrm @ it.T
        n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)).astype(np.float32)
        self.meshes.append((world, n, uv, idx, len(self.materials) - 1))

    def light(self, position):
        self.lights.append(np.asarray(position, np.float32))


def _atrium(b: _Builder, columns, sphere_detail, clutter_count, clutter_detail,
            column_slices):
    rng = np.random.default_rng(42)
    yy, xx = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    checker = np.zeros((512, 512, 4), np.uint8)
    even = ((yy // 64) + (xx // 64)) % 2 == 0
    checker[even] = [200, 190, 170, 255]
    checker[~even] = [90, 80, 70, 255]
    b.add(_cube(), translation([0.0, -0.1, 0.0]) @ scale([30.0, 0.2, 14.0]),
          roughness=0.9, texture=checker)
    for tx, tz, sx, sz in [(0.0, -7.0, 30.0, 0.4), (0.0, 7.0, 30.0, 0.4),
                           (-15.0, 0.0, 0.4, 14.0), (15.0, 0.0, 0.4, 14.0)]:
        b.add(_cube(), translation([tx, 3.0, tz]) @ scale([sx, 6.0, sz]),
              base_color=(0.75, 0.7, 0.62, 1.0))
    for i in range(columns):
        x = -12.0 + i * (24.0 / max(columns - 1, 1))
        for z in (-4.0, 4.0):
            b.add(_sphere(sphere_detail, column_slices or sphere_detail),
                  translation([x, 2.0, z]) @ scale([0.5, 2.2, 0.5]),
                  base_color=(0.8, 0.78, 0.72, 1.0), roughness=0.8)
            b.add(_cube(), translation([x, 4.4, z]) @ scale([1.2, 0.3, 1.2]),
                  base_color=(0.7, 0.68, 0.62, 1.0))
    for _ in range(clutter_count):
        p = [rng.uniform(-10, 10), 0.45, rng.uniform(-3, 3)]
        color = (rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9), 1.0)
        rt_type = int(rng.integers(0, 3))
        rng.uniform(0.0, 1.5)  # the fuzz or index of refraction; no raster pass reads it
        b.add(_sphere(clutter_detail, clutter_detail), translation(p) @ scale(0.45),
              base_color=color, rt_type=rt_type)


def create_sponza_scale_scene(b: _Builder) -> None:
    """The procedural atrium tessellated to Sponza's ~260k triangles, with
    ten point lights."""
    b.eye, b.target = [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]
    _atrium(b, columns=12, sphere_detail=48, clutter_count=48, clutter_detail=20,
            column_slices=96)
    for i in range(10):
        b.light([-9.0 + 2.0 * i, 2.0 + (i % 3), 4.0 - (i % 5) * 2.0])


def create_cube_scene(b: _Builder) -> None:
    """A large floor and a 30 x 10 grid of boxes, no lights."""
    b.eye, b.target = [-2.5, 3.0, -2.5], [10.0, 1.0, 10.0]
    b.add(_cube(), scale([10000.0, 0.1, 10000.0]))
    for x in range(30):
        for z in range(10):
            b.add(_cube(), translation([x * 2.0, 0.0, z * 2.0]) @ scale([1.0, 2.0, 1.0]))


@dataclasses.dataclass
class Scene:
    """World-space triangle tables on one device."""

    v: torch.Tensor  # (T, 3, 3) triangle corners
    n: torch.Tensor  # (T, 3, 3) corner normals
    uv: torch.Tensor  # (T, 3, 2) corner texture coordinates
    material: torch.Tensor  # (T,) int64
    mat_diffuse: torch.Tensor  # (M,) int64 texture of each material
    mat_base_color: torch.Tensor  # (M, 4)
    mat_metallic: torch.Tensor  # (M,)
    mat_roughness: torch.Tensor  # (M,)
    mat_rt_type: torch.Tensor  # (M,) int64: 1 = metal
    lights: torch.Tensor  # (L, 3) point-light positions, colour white
    textures: torch.Tensor  # (N, S, S, 4) uint8
    eye: list
    target: list

    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])


def build(name: str, device) -> Scene:
    """The scene of builder `name` on `device`."""
    b = _Builder()
    {"create_sponza_scale_scene": create_sponza_scale_scene,
     "create_cube_scene": create_cube_scene}[name](b)
    b.materials.append((0, np.array([0.0, 1.0, 0.0, 1.0], np.float32), 0.0, 1.0, 0))
    tri = [(w[i], n[i], uv[i], np.full(len(i), mat, np.int64))
           for w, n, uv, idx, mat in b.meshes for i in [idx.reshape(-1, 3)]]
    cat = lambda k: np.concatenate([t[k] for t in tri])
    dev = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                      device=device)
    mats = b.materials
    return Scene(
        v=dev(cat(0)), n=dev(cat(1)), uv=dev(cat(2)), material=dev(cat(3), torch.int64),
        mat_diffuse=dev([m[0] for m in mats], torch.int64),
        mat_base_color=dev(np.stack([m[1] for m in mats])),
        mat_metallic=dev([m[2] for m in mats]), mat_roughness=dev([m[3] for m in mats]),
        mat_rt_type=dev([m[4] for m in mats], torch.int64),
        lights=dev(np.stack(b.lights) if b.lights else np.zeros((0, 3), np.float32)),
        textures=dev(np.stack(b.textures), torch.uint8), eye=b.eye, target=b.target)

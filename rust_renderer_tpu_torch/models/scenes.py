"""Scene definitions (rebuild of prototype/src/scenes.rs), procedural branch.

The port of the default scene of ``rust_renderer_tpu/models/scenes.py``: the
glTF loader is not ported yet, so every builder here takes the procedural
branch that the JAX package takes when the upstream assets are absent, with
the same random draws. A builder raises if the asset directory named by
RUST_RENDERER_TPU_ASSETS holds the real asset, since the JAX package would
then load a different scene.
"""

from __future__ import annotations

import os

import numpy as np

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.renderer import Renderer
from rust_renderer_tpu_torch.scene import Material, MaterialType, ModelLoader
from rust_renderer_tpu_torch.utils import math3d


def _refuse_asset(rel: str) -> None:
    root = os.environ.get("RUST_RENDERER_TPU_ASSETS", "")
    if root and os.path.exists(os.path.join(root, rel)):
        raise NotImplementedError(
            f"{rel} exists under {root}: glTF assets are not ported yet, "
            "so this scene would differ from the JAX package's")


def _load_sphere_model():
    _refuse_asset("utopian/data/models/sphere.gltf")
    return ModelLoader.load_sphere()


def create_scene(renderer: Renderer, camera: Camera) -> None:
    """Default scene (scenes.rs:3-30): a sphere parked at infinity (gizmo
    target), 10 point lights on a 20-unit grid, then the Sponza scene."""
    sphere = _load_sphere_model()
    big = np.finfo(np.float32).max
    renderer.add_model(sphere, math3d.translation([big, big, big]))

    num_lights = 10
    for i in range(num_lights):
        renderer.add_light(
            position=[(i // 30) * 20.0, 3.5, (i % 30) * 20.0],
            color=[1.0, 1.0, 1.0],
            range_=1.0,
        )

    create_sponza_scene(renderer, camera)


def create_sponza_scene(renderer: Renderer, camera: Camera) -> None:
    """scenes.rs:102-150: Sponza (here its procedural stand-in) + one metal
    and one dielectric sphere."""
    camera.set_position_target([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0])
    _refuse_asset("prototype/data/models/Sponza/glTF/Sponza.bin")
    create_atrium_standin(renderer)

    metal_sphere = _load_sphere_model()
    metal_sphere.meshes[0].material.material_type = MaterialType.METAL
    dielectric_sphere = _load_sphere_model()
    dielectric_sphere.meshes[0].material.material_type = MaterialType.DIELECTRIC
    dielectric_sphere.meshes[0].material.material_property = 1.5

    size = 0.6
    renderer.add_model(
        metal_sphere, math3d.translation([-3.0, 2.65, 0.7]) @ math3d.scale(size)
    )
    renderer.add_model(
        dielectric_sphere, math3d.translation([-3.0, 0.65, 0.7]) @ math3d.scale(size)
    )


def create_atrium_standin(renderer: Renderer, columns: int = 6,
                          sphere_detail: int = 24,
                          clutter_count: int = 12,
                          clutter_detail: int = 16,
                          column_slices: int = 0) -> None:
    """Procedural Sponza stand-in: a colonnaded atrium (floor, walls, two rows
    of columns, checker-textured floor, clutter spheres)."""
    rng = np.random.default_rng(42)

    # Checker floor texture.
    tile = 64
    checker = np.zeros((512, 512, 4), np.uint8)
    yy, xx = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    mask = ((yy // tile) + (xx // tile)) % 2 == 0
    checker[mask] = [200, 190, 170, 255]
    checker[~mask] = [90, 80, 70, 255]

    floor = ModelLoader.load_cube()
    floor.textures = [checker]
    floor.meshes[0].material.diffuse_map = 0
    floor.meshes[0].material.roughness_factor = 0.9
    renderer.add_model(floor, math3d.translation([0.0, -0.1, 0.0]) @ math3d.scale([30.0, 0.2, 14.0]))

    # Walls.
    for (tx, tz, sx, sz) in [(0.0, -7.0, 30.0, 0.4), (0.0, 7.0, 30.0, 0.4),
                             (-15.0, 0.0, 0.4, 14.0), (15.0, 0.0, 0.4, 14.0)]:
        wall = ModelLoader.load_cube()
        wall.meshes[0].material.base_color_factor = np.array([0.75, 0.7, 0.62, 1.0], np.float32)
        renderer.add_model(
            wall, math3d.translation([tx, 3.0, tz]) @ math3d.scale([sx, 6.0, sz])
        )

    # Two rows of columns (cylinders approximated by scaled spheres + boxes).
    for i in range(columns):
        x = -12.0 + i * (24.0 / max(columns - 1, 1))
        for z in (-4.0, 4.0):
            col = ModelLoader.load_sphere(
                stacks=sphere_detail, slices=column_slices or sphere_detail
            )
            col.meshes[0].material.base_color_factor = np.array(
                [0.8, 0.78, 0.72, 1.0], np.float32
            )
            col.meshes[0].material.roughness_factor = 0.8
            renderer.add_model(
                col, math3d.translation([x, 2.0, z]) @ math3d.scale([0.5, 2.2, 0.5])
            )
            cap = ModelLoader.load_cube()
            cap.meshes[0].material.base_color_factor = np.array(
                [0.7, 0.68, 0.62, 1.0], np.float32
            )
            renderer.add_model(
                cap, math3d.translation([x, 4.4, z]) @ math3d.scale([1.2, 0.3, 1.2])
            )

    # Scattered clutter spheres with varied materials.
    for _ in range(clutter_count):
        p = [rng.uniform(-10, 10), 0.45, rng.uniform(-3, 3)]
        m = Material(
            base_color_factor=np.array(
                [rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9), 1.0],
                np.float32,
            ),
            material_type=MaterialType(int(rng.integers(0, 3))),
            material_property=float(rng.uniform(0.0, 1.5)),
        )
        s = ModelLoader.load_sphere(stacks=clutter_detail, slices=clutter_detail)
        s.meshes[0].material = m
        renderer.add_model(s, math3d.translation(p) @ math3d.scale(0.45))

"""Scene definitions (rebuild of prototype/src/scenes.rs).

The port of the builders of ``rust_renderer_tpu/models/scenes.py``. A
builder loads an upstream glTF asset (Sponza, the Cornell box, FlightHelmet,
the sphere, MetalRoughSpheres) from the asset directory named by
RUST_RENDERER_TPU_ASSETS where it is there, and otherwise takes the JAX
package's procedural branch, with the same random draws.
"""

from __future__ import annotations

import os

import numpy as np

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.renderer import Renderer
from rust_renderer_tpu_torch.scene import Material, MaterialType, ModelLoader, load_gltf
from rust_renderer_tpu_torch.utils import math3d


def _find_asset(rel: str) -> str | None:
    """The path of asset `rel` (relative to the upstream checkout) under the
    directory RUST_RENDERER_TPU_ASSETS names, read when called; None where
    it is not there."""
    root = os.environ.get("RUST_RENDERER_TPU_ASSETS", "")
    if root:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            return path
    return None


def _load_sphere_model():
    path = _find_asset("utopian/data/models/sphere.gltf")
    if path:
        return load_gltf(path)
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
    """scenes.rs:102-150: Sponza + one metal and one dielectric sphere."""
    camera.set_position_target([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0])
    sponza_path = _find_asset("prototype/data/models/Sponza/glTF/Sponza.gltf")
    sponza_bin = _find_asset("prototype/data/models/Sponza/glTF/Sponza.bin")
    if sponza_path and sponza_bin:
        renderer.add_model(load_gltf(sponza_path), np.eye(4, dtype=np.float32))
    else:
        # The upstream checkout ships Sponza.gltf without its (LFS) .bin:
        # a procedural atrium stands in.
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


def create_cornell_box_scene(renderer: Renderer, camera: Camera) -> None:
    """scenes.rs:58-100: the Cornell box glTF, a DIFFUSE_LIGHT cube and the
    FlightHelmet glTF; without the assets, the light cube alone."""
    camera.set_position_target([0.0, 0.9, 2.0], [0.0, 0.5, 0.0])
    box_path = _find_asset("prototype/data/models/CornellBox-Original.gltf")
    if box_path:
        renderer.add_model(load_gltf(box_path), np.eye(4, dtype=np.float32))
    light = ModelLoader.load_cube()
    light.meshes[0].material.material_type = MaterialType.DIFFUSE_LIGHT
    renderer.add_model(
        light, math3d.translation([0.0, 1.95, 0.0]) @ math3d.scale([0.50, 0.05, 0.35])
    )
    helmet_path = _find_asset("prototype/data/models/FlightHelmet/glTF/FlightHelmet.gltf")
    if helmet_path:
        renderer.add_model(load_gltf(helmet_path), math3d.translation([-0.33, 0.4, 0.3]))


def create_cornell_standin_scene(renderer: Renderer, camera: Camera) -> None:
    """Self-contained Cornell box for the diffuse-light golden gate: the
    asset-dependent halves of create_cornell_box_scene replaced by
    procedural wall slabs and two boxes, with the same camera and the same
    DIFFUSE_LIGHT cube. Open toward the camera."""
    camera.set_position_target([0.0, 0.9, 2.0], [0.0, 0.5, 0.0])

    def slab(color, t, s):
        m = ModelLoader.load_cube()
        m.meshes[0].material.base_color_factor = np.array(
            [color[0], color[1], color[2], 1.0], np.float32)
        renderer.add_model(m, math3d.translation(t) @ math3d.scale(s))

    white, red, green = (0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15)
    slab(white, [0.0, -0.05, 0.0], [2.2, 0.1, 2.2])    # floor
    slab(white, [0.0, 2.05, 0.0], [2.2, 0.1, 2.2])     # ceiling
    slab(white, [0.0, 1.0, -1.05], [2.2, 2.2, 0.1])    # back
    slab(red, [-1.05, 1.0, 0.0], [0.1, 2.2, 2.2])      # left
    slab(green, [1.05, 1.0, 0.0], [0.1, 2.2, 2.2])     # right

    light = ModelLoader.load_cube()
    light.meshes[0].material.material_type = MaterialType.DIFFUSE_LIGHT
    renderer.add_model(
        light, math3d.translation([0.0, 1.95, 0.0]) @ math3d.scale([0.50, 0.05, 0.35])
    )

    slab(white, [-0.38, 0.55, -0.35], [0.55, 1.1, 0.55])  # tall box
    slab(white, [0.42, 0.28, 0.25], [0.56, 0.56, 0.56])   # short box


def create_metal_rough_spheres(renderer: Renderer, camera: Camera) -> None:
    """scenes.rs:32-56: the MetalRoughSpheres glTF; without it, nothing."""
    camera.set_position_target([0.0, 0.9, 2.0], [0.0, 0.5, 0.0])
    path = _find_asset("prototype/data/models/MetalRoughSpheresNoTextures/glTF/"
                       "MetalRoughSpheresNoTextures.gltf")
    if path:
        transform = (math3d.translation([-10.0, 15.0, 2.5]) @ math3d.rotation_y(np.pi / 2.0)
                     @ math3d.scale(1000.0))
        renderer.add_model(load_gltf(path), transform)


def create_cube_scene(renderer: Renderer, camera: Camera) -> None:
    """scenes.rs:152-189: a giant floor and a 30x10 grid of cubes."""
    camera.set_position_target([-2.5, 3.0, -2.5], [10.0, 1.0, 10.0])
    floor = ModelLoader.load_cube()
    renderer.add_model(floor, math3d.scale([10000.0, 0.1, 10000.0]))
    for x in range(30):
        for z in range(10):
            cube = ModelLoader.load_cube()
            renderer.add_model(
                cube,
                math3d.translation([x * 2.0, 0.0, z * 2.0]) @ math3d.scale([1.0, 2.0, 1.0]),
            )


def create_restir_many_lights_scene(renderer: Renderer, camera: Camera,
                                    num_lights: int = 128) -> None:
    """The bench's 128-light scene (its config 4): `num_lights` point lights
    at two heights through the atrium, placed with `default_rng(4)`, then
    the Sponza scene."""
    camera.set_position_target([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0])
    rng = np.random.default_rng(4)
    for i in range(num_lights):
        renderer.add_light(
            position=[-11.0 + (i % 16) * 1.5,
                      1.0 + (i // 64) * 2.5 + rng.uniform(0.0, 0.5),
                      -5.0 + ((i // 16) % 4) * 3.0],
            color=list(0.5 + 0.5 * rng.uniform(size=3)),
            range_=1.0,
        )
    create_sponza_scene(renderer, camera)


def create_rtiow_scene(renderer: Renderer, camera: Camera) -> None:
    """The bench's config 1: the Ray Tracing in One Weekend scene of four
    analytic spheres (diffuse ground and centre, glass, metal)."""
    camera.set_position_target([0.0, 1.0, 4.0], [0.0, 0.5, -1.0])

    ground = Material(
        base_color_factor=np.array([0.5, 0.5, 0.5, 1.0], np.float32),
        material_type=MaterialType.LAMBERTIAN,
    )
    center = Material(
        base_color_factor=np.array([0.1, 0.2, 0.5, 1.0], np.float32),
        material_type=MaterialType.LAMBERTIAN,
    )
    glass = Material(material_type=MaterialType.DIELECTRIC, material_property=1.5)
    metal = Material(material_type=MaterialType.METAL, material_property=0.0)

    renderer.add_sphere([0.0, -100.5, -1.0], 100.0, material=ground)
    renderer.add_sphere([0.0, 0.5, -1.0], 0.5, material=center)
    renderer.add_sphere([-1.1, 0.5, -1.0], 0.5, material=glass)
    renderer.add_sphere([1.1, 0.5, -1.0], 0.5, material=metal)


def create_sponza_scale_scene(renderer: Renderer, camera: Camera) -> None:
    """The Sponza-scale scene (the JAX package's models/scenes.py:167-183):
    the procedural atrium tessellated to about 260k triangles, the real
    Sponza's count (scenes.rs:102-150), with 10 point lights."""
    camera.set_position_target([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0])
    # 24 columns x 9,216 tris + 48 clutter spheres x 800 + boxes ~= 260k tris.
    create_atrium_standin(
        renderer, columns=12, sphere_detail=48, column_slices=96,
        clutter_count=48, clutter_detail=20,
    )
    for i in range(10):
        renderer.add_light(
            position=[-9.0 + 2.0 * i, 2.0 + (i % 3), 4.0 - (i % 5) * 2.0],
            color=[1.0, 1.0, 1.0],
        )


def create_sponza_scale_mc_scene(renderer: Renderer, camera: Camera) -> None:
    """The Sponza-scale scene framed for the animated marching-cubes
    isosurface (bench config 5): the camera inside the atrium at (2, 3, 1),
    looking up over the +z wall at (10, 12, 10), toward the surface's box
    and torus in the [0,32]^3 domain (the pulsing sphere above them stays
    behind the torus). From the Sponza viewpoint the wall hides the
    surface."""
    create_sponza_scale_scene(renderer, camera)
    camera.set_position_target([2.0, 3.0, 1.0], [10.0, 12.0, 10.0])


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

"""Scene registry: models, materials, lights and textures packed into tensors.

The port of ``rust_renderer_tpu/renderer.py`` (the reference's
utopian/src/renderer.rs + bindless.rs). Models register meshes, materials and
textures and get integer handles; `Renderer.pack(device=...)` concatenates the
world-space vertex pools and the struct-of-array material and light tables
into a `PackedScene` of tensors on one device.

Raytrace properties follow GpuMaterial.raytrace_properties (renderer.rs:20-36):
type 0 = lambertian, 1 = metal, 2 = dielectric, 3 = diffuse light; property =
fuzz (metal) or index of refraction (dielectric).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from rust_renderer_tpu_torch.scene.gltf_loader import DEFAULT_TEXTURE_MAP, Model
from rust_renderer_tpu_torch.utils import math3d

log = logging.getLogger(__name__)

MAX_NUM_GPU_MATERIALS = 1024
MAX_NUM_GPU_MESHES = 1024
MAX_NUM_GPU_LIGHTS = 1024

# Texture-array tile size: every bindless texture is resampled to this square.
TEXTURE_TILE = 512


@dataclasses.dataclass
class ModelInstance:
    """renderer.rs:15-18."""

    model: Model
    transform: np.ndarray  # (4,4)


@dataclasses.dataclass
class PackedScene:
    """The scene as tensors on one device (field names of the JAX package's
    PackedScene). Geometry is pre-transformed to world space."""

    # Vertex pools (V, ·) float32, world space.
    positions: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    colors: torch.Tensor
    tangents: torch.Tensor
    # Triangles: (T, 3) int32 into pools; (T,) int32 gpu-mesh id.
    indices: torch.Tensor
    tri_mesh: torch.Tensor
    # Mesh table (M,): material id per gpu mesh.
    mesh_material: torch.Tensor
    # Material table (K, ·) — GpuMaterial SoA (renderer.rs:20-36).
    mat_diffuse_map: torch.Tensor
    mat_normal_map: torch.Tensor
    mat_mr_map: torch.Tensor
    mat_occlusion_map: torch.Tensor
    mat_base_color: torch.Tensor
    mat_metallic: torch.Tensor
    mat_roughness: torch.Tensor
    mat_rt_type: torch.Tensor
    mat_rt_prop: torch.Tensor
    # Light table (L, ·) — GpuLight SoA (renderer.rs:46-59).
    light_color: torch.Tensor
    light_pos: torch.Tensor
    light_range: torch.Tensor
    light_dir: torch.Tensor
    light_spot: torch.Tensor
    light_att: torch.Tensor
    light_type: torch.Tensor
    light_intensity: torch.Tensor
    # Bindless texture array: (N, TEXTURE_TILE, TEXTURE_TILE, 4) uint8.
    textures: torch.Tensor
    # Analytic spheres: (S, 3) centers, (S,) radii, (S,) material ids.
    sphere_center: torch.Tensor
    sphere_radius: torch.Tensor
    sphere_material: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]


def _resample_texture(img: np.ndarray, size: int = TEXTURE_TILE) -> np.ndarray:
    """Nearest-texel resample to size x size (the JAX package's fallback when
    PIL is absent; the procedural scenes' textures are already 512²)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    ys = (np.arange(size) * img.shape[0] // size).clip(0, img.shape[0] - 1)
    xs = (np.arange(size) * img.shape[1] // size).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def _default_textures() -> list[np.ndarray]:
    """Default white / flat-normal / metallic-roughness / black textures
    (renderer.rs:202-220)."""
    white = np.full((TEXTURE_TILE, TEXTURE_TILE, 4), 255, np.uint8)
    flat_normal = np.empty_like(white)
    flat_normal[..., 0] = 128
    flat_normal[..., 1] = 128
    flat_normal[..., 2] = 255
    flat_normal[..., 3] = 255
    default_mr = np.zeros_like(white)
    default_mr[..., 1] = 255  # roughness (g) = 1.0
    default_mr[..., 3] = 255  # metallic (b) = 0.0
    black = np.zeros_like(white)
    black[..., 3] = 255
    return [white, flat_normal, default_mr, black]


def _material_row(diffuse_map, normal_map, mr_map, occlusion_map, base_color,
                  metallic, roughness, rt_type, rt_prop) -> dict:
    return dict(
        diffuse_map=int(diffuse_map), normal_map=int(normal_map),
        metallic_roughness_map=int(mr_map), occlusion_map=int(occlusion_map),
        base_color_factor=np.asarray(base_color, np.float32),
        metallic_factor=float(metallic), roughness_factor=float(roughness),
        rt_type=int(rt_type), rt_prop=float(rt_prop),
    )


class Renderer:
    """Owns the scene registry and assigns bindless indices on add
    (renderer.rs:123-299)."""

    def __init__(self) -> None:
        self.instances: list[ModelInstance] = []
        self.gpu_materials: list[dict] = []
        self.gpu_meshes: list[dict] = []
        self.gpu_lights: list[dict] = []
        self.textures: list[np.ndarray] = []
        self.spheres: list[dict] = []
        self._mesh_instance: list[tuple[int, int]] = []  # gpu_mesh -> (instance, mesh i)
        self._mc_material_index: int | None = None
        # The captured environment (ops/ibl.py) is recomputed lazily when
        # set (ibl.rs:63-66).
        self.need_environment_map_update = True

        # Default textures get bindless indices 0..2 (renderer.rs:202-220).
        defaults = _default_textures()
        self.default_diffuse_map_index = self.add_bindless_texture(defaults[0])
        self.default_normal_map_index = self.add_bindless_texture(defaults[1])
        self.default_metallic_roughness_map_index = self.add_bindless_texture(
            defaults[2])
        self.default_occlusion_map_index = self.default_diffuse_map_index

    def _default_maps(self) -> tuple[int, int, int, int]:
        return (self.default_diffuse_map_index, self.default_normal_map_index,
                self.default_metallic_roughness_map_index,
                self.default_occlusion_map_index)

    # -- registration (mirrors renderer.rs:222-410) --------------------------

    def add_bindless_texture(self, img: np.ndarray) -> int:
        index = len(self.textures)
        self.textures.append(_resample_texture(np.ascontiguousarray(img)))
        return index

    def add_model(self, model: Model, transform: np.ndarray) -> int:
        """Registers every mesh, remapping model-local texture indices to
        bindless ones (renderer.rs:222-299). Returns the instance index."""
        instance_index = len(self.instances)
        texture_remap = [self.add_bindless_texture(t) for t in model.textures]

        def remap(local: int, default: int) -> int:
            if np.uint32(local) == DEFAULT_TEXTURE_MAP:
                return default
            return texture_remap[local]

        for mesh_i, mesh in enumerate(model.meshes):
            m = mesh.material
            material_index = len(self.gpu_materials)
            self.gpu_materials.append(_material_row(
                remap(m.diffuse_map, self.default_diffuse_map_index),
                remap(m.normal_map, self.default_normal_map_index),
                remap(m.metallic_roughness_map,
                      self.default_metallic_roughness_map_index),
                remap(m.occlusion_map, self.default_occlusion_map_index),
                m.base_color_factor, m.metallic_factor, m.roughness_factor,
                m.material_type, m.material_property,
            ))
            gpu_mesh_index = len(self.gpu_meshes)
            self.gpu_meshes.append(dict(material=material_index))
            mesh.gpu_mesh = gpu_mesh_index
            self._mesh_instance.append((instance_index, mesh_i))

        self.instances.append(
            ModelInstance(model=model, transform=np.asarray(transform, np.float32)))
        self.need_environment_map_update = True
        return instance_index

    def add_light(self, position, color, range_: float = 1.0) -> int:
        """Point light with the reference's defaults: attenuation (0,0,0.1),
        intensity (1,1,1), type 1 (renderer.rs:391-410)."""
        c = np.asarray(color, np.float32)
        self.gpu_lights.append(dict(
            color=np.array([c[0], c[1], c[2], 0.0], np.float32),
            position=np.asarray(position, np.float32),
            range=float(range_),
            direction=np.zeros(3, np.float32),
            spot=0.0,
            attenuation=np.array([0.0, 0.0, 0.1], np.float32),
            light_type=1.0,
            intensity=np.ones(3, np.float32),
        ))
        return len(self.gpu_lights) - 1

    def add_sphere(self, center, radius: float, material_index: int | None = None,
                   material=None) -> int:
        """Analytic sphere primitive. If `material` is given it is appended to
        the material table; else `material_index` must name an existing one."""
        if material is not None:
            material_index = len(self.gpu_materials)
            self.gpu_materials.append(_material_row(
                *self._default_maps(), material.base_color_factor,
                material.metallic_factor, material.roughness_factor,
                material.material_type, material.material_property,
            ))
        if material_index is None:
            raise ValueError("add_sphere needs a material or a material_index")
        self.spheres.append(dict(center=np.asarray(center, np.float32),
                                 radius=float(radius),
                                 material=int(material_index)))
        return len(self.spheres) - 1

    def get_num_lights(self) -> int:
        return len(self.gpu_lights)

    def ensure_mc_material(self, color=(0.0, 1.0, 0.0, 1.0)) -> int:
        """Lambertian material of the marching-cubes isosurface
        (renderers/marching_cubes.rs:63-135). Idempotent."""
        if self._mc_material_index is None:
            self._mc_material_index = len(self.gpu_materials)
            self.gpu_materials.append(_material_row(
                *self._default_maps(), color, 0.0, 1.0, 0, 0.0))
        return self._mc_material_index

    def set_instance_transform(self, instance_index: int, transform: np.ndarray) -> None:
        """The gizmo move (prototype/src/main.rs:344-359): the next pack()
        rebuilds the world-space pools (the TLAS-rebuild equivalent)."""
        self.instances[instance_index].transform = np.asarray(transform, np.float32)

    # -- packing --------------------------------------------------------------

    def pack_numpy(self) -> dict[str, np.ndarray]:
        """The PackedScene fields as host numpy arrays."""
        pos_list, nrm_list, uv_list, col_list, tan_list = [], [], [], [], []
        idx_list, tri_mesh_list = [], []
        v_offset = 0
        for gpu_mesh_id, (inst_i, mesh_i) in enumerate(self._mesh_instance):
            inst = self.instances[inst_i]
            mesh = inst.model.meshes[mesh_i]
            world = inst.transform @ inst.model.transforms[mesh_i]
            prim = mesh.primitive
            pos_list.append(math3d.transform_points(world, prim.positions))
            nrm_list.append(math3d.transform_normals(world, prim.normals))
            uv_list.append(prim.uvs)
            col_list.append(prim.colors)
            tan = prim.tangents.copy()
            tan[:, :3] = math3d.transform_dirs(world, tan[:, :3])
            tan_list.append(tan)
            tri = prim.indices.reshape(-1, 3).astype(np.int32) + v_offset
            idx_list.append(tri)
            tri_mesh_list.append(np.full(len(tri), gpu_mesh_id, np.int32))
            v_offset += prim.num_vertices

        def cat(lst, empty_shape, dtype=np.float32):
            if lst:
                return np.concatenate(lst, axis=0).astype(dtype)
            return np.zeros(empty_shape, dtype)

        mats = self.gpu_materials or [
            _material_row(0, 1, 2, 0, np.ones(4, np.float32), 0.0, 0.5, 0, 0.0)
        ]
        lights = self.gpu_lights or [dict(
            color=np.zeros(4, np.float32), position=np.zeros(3, np.float32),
            range=0.0, direction=np.zeros(3, np.float32), spot=0.0,
            attenuation=np.array([0.0, 0.0, 0.1], np.float32), light_type=1.0,
            intensity=np.zeros(3, np.float32),
        )]
        spheres = self.spheres

        def col(rows, key, dtype):
            return np.array([r[key] for r in rows], dtype)

        def stack(rows, key):
            return np.stack([r[key] for r in rows]).astype(np.float32)

        tex = np.stack(self.textures) if self.textures else np.zeros(
            (1, TEXTURE_TILE, TEXTURE_TILE, 4), np.uint8)
        return dict(
            positions=cat(pos_list, (0, 3)),
            normals=cat(nrm_list, (0, 3)),
            uvs=cat(uv_list, (0, 2)),
            colors=cat(col_list, (0, 4)),
            tangents=cat(tan_list, (0, 4)),
            indices=cat(idx_list, (0, 3), np.int32),
            tri_mesh=cat(tri_mesh_list, (0,), np.int32),
            mesh_material=np.array(
                [m["material"] for m in self.gpu_meshes] or [0], np.int32),
            mat_diffuse_map=col(mats, "diffuse_map", np.int32),
            mat_normal_map=col(mats, "normal_map", np.int32),
            mat_mr_map=col(mats, "metallic_roughness_map", np.int32),
            mat_occlusion_map=col(mats, "occlusion_map", np.int32),
            mat_base_color=stack(mats, "base_color_factor"),
            mat_metallic=col(mats, "metallic_factor", np.float32),
            mat_roughness=col(mats, "roughness_factor", np.float32),
            mat_rt_type=col(mats, "rt_type", np.int32),
            mat_rt_prop=col(mats, "rt_prop", np.float32),
            light_color=stack(lights, "color"),
            light_pos=stack(lights, "position"),
            light_range=col(lights, "range", np.float32),
            light_dir=stack(lights, "direction"),
            light_spot=col(lights, "spot", np.float32),
            light_att=stack(lights, "attenuation"),
            light_type=col(lights, "light_type", np.float32),
            light_intensity=stack(lights, "intensity"),
            textures=tex,
            sphere_center=(stack(spheres, "center") if spheres
                           else np.zeros((0, 3), np.float32)),
            sphere_radius=col(spheres, "radius", np.float32),
            sphere_material=col(spheres, "material", np.int32),
        )

    def pack(self, *, device="cuda") -> PackedScene:
        """Build the scene tensors on `device`: host numpy concat + one copy
        per field."""
        log.info(
            "pack: %d instances, %d meshes, %d materials, %d lights, %d textures",
            len(self.instances), len(self.gpu_meshes), len(self.gpu_materials),
            len(self.gpu_lights), len(self.textures),
        )
        from rust_renderer_tpu_torch.convert import packed_scene_from_numpy

        return packed_scene_from_numpy(self.pack_numpy(), device)

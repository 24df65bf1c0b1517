"""The deferred composite (utopian/shaders/deferred/deferred.frag; the body of
the deferred pass, renderers/passes.py::setup_deferred_pass).

Per pixel of the gbuffer planes: the material decoded, Cook-Torrance over the
sun and the scene's lights below `view.num_lights`, the ambient term (IBL
when ibl_enabled, else 0.03 x base colour x occlusion), RT reflections on
metal when raytracing_supported, the shadow factor (the cascades when
shadows_enabled, else the RT shadows clamped to >= 0.3 when
raytracing_supported, else 1), the cascade debug tint and SSAO; alpha 1.

`deferred_composite` takes, for CPU tensors, the plain body
(`deferred_composite_plain`, the composition of ops/pbr.py and
ops/shadow.py that the CPU tests hold the JAX package to) and, for CUDA
tensors, the deferred kernel (``csrc/deferred.cu``: the same float32
operations in the same order, one thread a pixel, one launch a call), or
raises. `DEFERRED_LAUNCHES` counts the kernel's launches and the pixels they
shaded; nothing else changes it.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from rust_renderer_tpu_torch.ops import pbr as pbr_ops
from rust_renderer_tpu_torch.ops import shadow as shadow_ops
from rust_renderer_tpu_torch.ops import traversal

# The kernel's launches and the pixels they shaded.
DEFERRED_LAUNCHES: collections.Counter = collections.Counter()  # "launches", "pixels"

# Compile-time limits of csrc/deferred.cu.
MAX_LEVELS = 16
MAX_CASCADES = 8


def deferred_composite(scene, view, position, normal, albedo, pbr, rt_reflections,
                       rt_shadows, ssao, shadow_map, cascade_vp, cascade_splits,
                       irradiance_map, specular_map: list, brdf_lut) -> torch.Tensor:
    """The pass's `deferred_output`, (rows, W, 4), from the (rows, W, 4)
    gbuffer planes `position`, `normal`, `albedo`, `pbr` and
    `rt_reflections` and the (rows, W) `rt_shadows` and `ssao`; the (C, S,
    S) `shadow_map` with its (C, 4, 4) `cascade_vp` and (C,) `cascade_splits`;
    the (6, S, S, 3) `irradiance_map`, the list of (6, s, s, 3)
    `specular_map` levels and the (S, S, 2) `brdf_lut`. CPU tensors take the
    plain body, CUDA tensors the kernel."""
    dev = position.device
    args = (scene, view, position, normal, albedo, pbr, rt_reflections, rt_shadows, ssao,
            shadow_map, cascade_vp, cascade_splits, irradiance_map, specular_map, brdf_lut)
    if dev.type == "cpu":
        return deferred_composite_plain(*args)
    if dev.type == "cuda":
        return deferred_shade_cuda(*args)
    raise ValueError(f"no deferred composite for device {dev}")


def deferred_composite_plain(scene, view, position, normal, albedo, pbr, rt_reflections,
                             rt_shadows, ssao, shadow_map, cascade_vp, cascade_splits,
                             irradiance_map, specular_map: list, brdf_lut) -> torch.Tensor:
    """`deferred_composite`'s plain version: the eager tensor code, the
    function the kernel computes."""
    pixel = pbr_ops.material_pixel(scene, position[..., :3], normal[..., :3],
                                   albedo[..., :3], pbr)
    lo = pbr_ops.shade_all_lights(pixel, scene, view)
    ambient_flat = 0.03 * pixel.base_color * pbr[..., 2:3]
    ambient_ibl = pbr_ops.image_based_lighting(pixel, view.eye_pos, irradiance_map,
                                               specular_map, brdf_lut)
    color = torch.where(view.ibl_enabled == 1, ambient_ibl, ambient_flat) + lo

    # RT reflections replace metal materials (deferred.frag:92-95).
    material = pbr[..., 3].to(torch.int64).clamp(0, scene.mat_roughness.shape[0] - 1)
    is_metal = (view.raytracing_supported == 1) & (scene.mat_rt_type[material] == 1)
    color = torch.where(is_metal[..., None], rt_reflections[..., :3], color)

    # CSM when enabled, else RT shadows (deferred.frag:97-111).
    csm, cascade = shadow_ops.calculate_shadow(position[..., :3], view.view, shadow_map,
                                               cascade_vp, cascade_splits)
    rt_sh = torch.clamp_min(rt_shadows, 0.3)
    shadow = torch.where(view.shadows_enabled == 1, csm,
                         torch.where(view.raytracing_supported == 1, rt_sh, 1.0))
    color = color * shadow[..., None]
    # CASCADE_DEBUG tint (deferred.frag:104-107) as a runtime toggle.
    tint = (view.shadows_enabled == 1) & (view.cascade_debug == 1)
    color = torch.where(tint, color * shadow_ops.cascade_debug_color(cascade), color)
    color = color * torch.where(view.ssao_enabled == 1, ssao, 1.0)[..., None]
    return torch.cat([color, torch.ones_like(color[..., :1])], -1)


class _Args(ctypes.Structure):
    """csrc/deferred.cu's `DeferredArgs`, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "position", "normal", "albedo", "pbr", "reflections", "rt_shadows", "ssao", "out",
        "eye_pos", "sun_dir", "view_matrix", "num_lights", "ibl_enabled", "shadows_enabled",
        "raytracing_supported", "cascade_debug", "ssao_enabled", "cascade_vp",
        "cascade_splits", "shadow_map", "mat_base_color", "mat_metallic", "mat_roughness",
        "mat_rt_type", "light_color", "light_pos", "light_dir", "light_type", "light_att",
        "light_spot", "irradiance", "brdf_lut")]
    _fields_ += [("specular", ctypes.c_void_p * MAX_LEVELS),
                 ("specular_size", ctypes.c_int * MAX_LEVELS)]
    _fields_ += [(name, ctypes.c_int) for name in (
        "rows", "width", "n_materials", "n_lights", "n_cascades", "shadow_size",
        "irradiance_size", "lut_size", "n_levels")]


def _on_device(name: str, x: torch.Tensor, dtype, shape, dev, flat: bool = False):
    """x as the kernel reads it in place: a contiguous tensor of `dtype` on
    `dev` of `shape` (with `flat`, of its number of elements, viewed as
    `shape`). A wrong type, device, shape or layout raises: nothing is
    copied."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"the deferred kernel reads {name} from a tensor on {dev}, "
                         f"got {type(x).__name__}")
    traversal._check(name, x, dtype, x.shape if flat else shape, dev)
    if x.numel() != math.prod(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {math.prod(shape)} "
                         "elements")
    return x.view(shape)


def deferred_shade_cuda(scene, view, position, normal, albedo, pbr, rt_reflections,
                        rt_shadows, ssao, shadow_map, cascade_vp, cascade_splits,
                        irradiance_map, specular_map: list, brdf_lut) -> torch.Tensor:
    """Launch the deferred kernel (``csrc/deferred.cu``) on CUDA planes;
    `deferred_composite`'s arguments. The view's fields, the cascades and
    the scene's tables are read from device memory, so a captured launch
    replays with the values they hold then."""
    dev = position.device
    f32, i32 = torch.float32, torch.int32
    rows, width = position.shape[0], position.shape[1]
    n_cascades, size = shadow_map.shape[0], shadow_map.shape[-1]
    n_materials, n_lights = scene.mat_roughness.shape[0], scene.light_pos.shape[0]
    if rows * width >= 2 ** 31:
        raise ValueError(f"{rows} x {width} pixels exceed one deferred kernel launch")
    if not 1 <= n_cascades <= MAX_CASCADES:
        raise ValueError(f"the deferred kernel takes 1 to {MAX_CASCADES} cascades, "
                         f"got {n_cascades}")
    if not 1 <= len(specular_map) <= MAX_LEVELS:
        raise ValueError(f"the deferred kernel takes 1 to {MAX_LEVELS} specular levels, "
                         f"got {len(specular_map)}")
    if n_materials < 1:
        raise ValueError("the deferred kernel needs at least one material")
    plane4 = lambda name, x: _on_device(name, x, f32, (rows, width, 4), dev)
    plane1 = lambda name, x: _on_device(name, x, f32, (rows, width), dev)
    vec = lambda name, x, n: _on_device(name, x, f32, (n,), dev, flat=True)
    flag = lambda name: _on_device(name, getattr(view, name), i32, (1,), dev, flat=True)
    cube = lambda name, x: _on_device(name, x, f32, (6, x.shape[1], x.shape[1], 3), dev)
    t = dict(
        position=plane4("position", position), normal=plane4("normal", normal),
        albedo=plane4("albedo", albedo), pbr=plane4("pbr", pbr),
        reflections=plane4("rt_reflections", rt_reflections),
        rt_shadows=plane1("rt_shadows", rt_shadows), ssao=plane1("ssao", ssao),
        eye_pos=vec("eye_pos", view.eye_pos, 3), sun_dir=vec("sun_dir", view.sun_dir, 3),
        view_matrix=vec("view", view.view, 16),
        **{name: flag(name) for name in ("num_lights", "ibl_enabled", "shadows_enabled",
                                         "raytracing_supported", "cascade_debug",
                                         "ssao_enabled")},
        cascade_vp=vec("cascade_vp", cascade_vp, 16 * n_cascades),
        cascade_splits=vec("cascade_splits", cascade_splits, n_cascades),
        shadow_map=_on_device("shadow_map", shadow_map, f32, (n_cascades, size, size), dev),
        mat_base_color=_on_device("mat_base_color", scene.mat_base_color, f32,
                                  (n_materials, 4), dev),
        mat_metallic=vec("mat_metallic", scene.mat_metallic, n_materials),
        mat_roughness=vec("mat_roughness", scene.mat_roughness, n_materials),
        mat_rt_type=_on_device("mat_rt_type", scene.mat_rt_type, i32, (n_materials,), dev),
        light_color=_on_device("light_color", scene.light_color, f32, (n_lights, 4), dev),
        light_pos=_on_device("light_pos", scene.light_pos, f32, (n_lights, 3), dev),
        light_dir=_on_device("light_dir", scene.light_dir, f32, (n_lights, 3), dev),
        light_type=vec("light_type", scene.light_type, n_lights),
        light_att=_on_device("light_att", scene.light_att, f32, (n_lights, 3), dev),
        light_spot=vec("light_spot", scene.light_spot, n_lights),
        irradiance=cube("irradiance_map", irradiance_map),
        brdf_lut=_on_device("brdf_lut", brdf_lut, f32,
                            (brdf_lut.shape[0], brdf_lut.shape[0], 2), dev),
    )
    levels = [cube(f"specular_map[{m}]", s) for m, s in enumerate(specular_map)]
    out = torch.empty((rows, width, 4), dtype=f32, device=dev)
    for name in ("position", "normal", "albedo", "pbr", "reflections"):
        if t[name].data_ptr() % 16:
            raise ValueError(f"the deferred kernel reads {name} as float4: it must be "
                             "16-byte aligned")
    if t["brdf_lut"].data_ptr() % 8:
        raise ValueError("the deferred kernel reads brdf_lut as float2: it must be 8-byte "
                         "aligned")
    if rows and width:
        lib = traversal.library("deferred_shade")
        if lib.deferred_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError(f"csrc/deferred.cu's DeferredArgs holds "
                               f"{lib.deferred_args_size()} bytes, _Args "
                               f"{ctypes.sizeof(_Args)}")
        args = _Args(**{name: x.data_ptr() for name, x in t.items()}, out=out.data_ptr(),
                     rows=rows, width=width, n_materials=n_materials, n_lights=n_lights,
                     n_cascades=n_cascades, shadow_size=size,
                     irradiance_size=t["irradiance"].shape[1],
                     lut_size=t["brdf_lut"].shape[0], n_levels=len(levels))
        for m, level in enumerate(levels):
            args.specular[m] = level.data_ptr()
            args.specular_size[m] = level.shape[1]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.deferred_shade(ctypes.addressof(args), stream)
        traversal._raise_on(err, "the deferred kernel")
        DEFERRED_LAUNCHES["launches"] += 1
        DEFERRED_LAUNCHES["pixels"] += rows * width
    return out

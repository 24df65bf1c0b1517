"""Render settings and per-frame view uniforms.

The port of ``rust_renderer_tpu/settings.py``. `StaticConfig` holds what
changes the shape of a frame (resolution, bounce count, samples per frame);
`RenderSettings` holds the per-frame view data and the runtime toggles that
every pass reads, field for field as in the reference's ``ViewUniformData``.

`RenderSettings` lives on the host as numpy values, so change tracking never
waits on the device; `RenderSettings.to(device)` makes the tensor copy that a
frame's passes read.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch


class RenderGraphMode(enum.Enum):
    """Render graph modes (reference: prototype/src/main.rs:5-11)."""

    PATH_TRACED = 0
    HYBRID = 1
    RASTERIZED = 2
    MINIMAL = 3


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Frame-shape configuration (the JAX package's field names).

    `compact_window`, `compact_window_any`, `compact_order`, `seed_rows` and
    `split_pt_program` are kept so that configurations carry over, and do
    nothing here: they schedule work on the TPU, and the port's results are
    exact without them.
    """

    width: int = 2000
    height: int = 1100
    samples_per_frame: int = 1
    num_bounces: int = 5
    shadow_map_size: int = 4096
    shadow_cascade_count: int = 4
    cubemap_size: int = 512
    cubemap_mips: int = 8
    irradiance_size: int = 64
    brdf_lut_size: int = 512
    mc_grid: int = 32
    ris_candidates: int = 32
    spatial_neighbors: int = 5
    spatial_radius: int = 30
    max_num_lights: int = 1024
    # "exact" integrates the atmosphere per miss ray (reference.rmiss); the
    # captured-cubemap sky ("cubemap") is not ported yet.
    sky_mode: str = "exact"
    compact_window: int = 64
    compact_window_any: int = 128
    compact_order: str = "morton"
    seed_rows: int = 4
    split_pt_program: bool = False

    def replace(self, **kw: Any) -> "StaticConfig":
        return dataclasses.replace(self, **kw)


# numpy dtype of a host field -> dtype of its tensor. uint32 counters become
# int64, which holds every uint32 value and has all the arithmetic torch
# offers for integers.
_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int64): torch.int64,
}


def to_tensor(value, device) -> torch.Tensor:
    """One host value (numpy array or scalar) as a tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    return torch.as_tensor(arr, dtype=_TORCH_DTYPE[arr.dtype], device=device)


@dataclasses.dataclass
class RenderSettings:
    """Per-frame view data + runtime feature toggles (renderer.rs:84-120).

    Matrices apply as ``m @ v`` to column vectors. Toggles are int32 scalars.
    """

    view: Any
    projection: Any
    inverse_view: Any
    inverse_projection: Any
    prev_frame_projection_view: Any

    eye_pos: Any  # (3,)
    sun_dir: Any  # (3,)
    total_samples: Any  # u32 scalar: progressive accumulation counter
    time: Any  # f32 scalar
    num_lights: Any  # i32 scalar

    shadows_enabled: Any
    ssao_enabled: Any
    fxaa_enabled: Any
    cubemap_enabled: Any
    ibl_enabled: Any
    sky_enabled: Any
    sun_shadow_enabled: Any
    lights_enabled: Any
    max_num_lights_used: Any
    marching_cubes_enabled: Any
    temporal_reuse_enabled: Any
    spatial_reuse_enabled: Any
    rebuild_tlas: Any
    accumulation_limit: Any
    use_ris_light_sampling: Any
    raytracing_supported: Any
    fxaa_debug: Any = np.int32(0)
    cascade_debug: Any = np.int32(0)

    @staticmethod
    def default(
        view: np.ndarray | None = None,
        projection: np.ndarray | None = None,
        eye_pos=(0.0, 0.0, 0.0),
        sun_dir=(0.0, 0.90631, 0.42262),
        num_lights: int = 0,
    ) -> "RenderSettings":
        """Defaults mirroring prototype/src/main.rs:55-86."""
        eye4 = np.eye(4, dtype=np.float32)
        view = np.asarray(view, np.float32) if view is not None else eye4
        projection = (
            np.asarray(projection, np.float32) if projection is not None else eye4
        )
        flag = np.int32
        return RenderSettings(
            view=view,
            projection=projection,
            inverse_view=np.linalg.inv(view).astype(np.float32),
            inverse_projection=np.linalg.inv(projection).astype(np.float32),
            prev_frame_projection_view=(projection @ view).astype(np.float32),
            eye_pos=np.asarray(eye_pos, np.float32),
            sun_dir=np.asarray(sun_dir, np.float32),
            total_samples=np.uint32(0),
            time=np.float32(0.0),
            num_lights=np.int32(num_lights),
            shadows_enabled=flag(1),
            ssao_enabled=flag(1),
            fxaa_enabled=flag(1),
            cubemap_enabled=flag(1),
            ibl_enabled=flag(1),
            sky_enabled=flag(1),
            sun_shadow_enabled=flag(1),
            lights_enabled=flag(1),
            max_num_lights_used=np.int32(1024),
            marching_cubes_enabled=flag(0),
            temporal_reuse_enabled=flag(1),
            spatial_reuse_enabled=flag(1),
            rebuild_tlas=flag(0),
            accumulation_limit=np.int32(999999),
            use_ris_light_sampling=flag(0),
            raytracing_supported=flag(1),
        )

    def with_camera(self, camera, width: int, height: int) -> "RenderSettings":
        """Refresh view matrices from a Camera (mirrors main.rs:459-471)."""
        view = camera.get_view()
        proj = camera.get_projection()
        return dataclasses.replace(
            self,
            view=view,
            projection=proj,
            inverse_view=np.linalg.inv(view).astype(np.float32),
            inverse_projection=np.linalg.inv(proj).astype(np.float32),
            eye_pos=np.asarray(camera.get_position(), np.float32),
        )

    def replace(self, **kw: Any) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "RenderSettings":
        """Every field as a tensor on `device` (the per-frame upload)."""
        return RenderSettings(**{
            f.name: to_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(RenderSettings)
        })

"""Reference path tracer as a wavefront (the port of ``ops/pathtrace.py``).

Rebuild of pathtrace_reference/reference.rgen + .rchit + .rmiss: per-pixel
PCG streams seeded by (pixel, total_samples + time*10000) (reference.rgen:24),
jittered pinhole rays (:30-38), a bounce loop with throughput accumulation
(:42-126), next-event estimation for the sun (:63-79) and a point light chosen
uniformly or from the ReSTIR reservoir (:80-125), and the progressive
accumulation protocol with linear->sRGB output (:130-144).

Every bounce intersects the whole (H, W) front; masks replace thread
divergence, and finished lanes get a zero direction, which the traversal
retires on entry. A lane whose scattered direction is zero or not finite
ends at that bounce, absorbed: no miss shader sees it (the sky of a zero
direction is NaN). The JAX package sends such a lane on, so this is the
port's one departure from it.

Each frame adds to two device counters of the profiler: `pt/rays`, the
rays traced (the sum `rays_traced` holds, exact in int64; its peak the
largest front of one traversal), and `pt/ended`, the lanes the rule above
ends.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rust_renderer_tpu_torch.ops import atmosphere, intersect, materials, mc_bvh
from rust_renderer_tpu_torch.ops import rays as rayops
from rust_renderer_tpu_torch.ops import restir as restirops
from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.ops.colors import linear_to_srgb
from rust_renderer_tpu_torch.utils.profiler import PROFILER


class PathTraceResult(NamedTuple):
    output: torch.Tensor  # (H, W, 3) f32 sRGB — the reference's output_image
    accumulation: torch.Tensor  # (H, W, 3) f32 linear — accumulation_image
    # Rays traced this frame: closest-hit rays with live directions plus two
    # NEE rays per lane still active after each bounce (f32 count).
    rays_traced: torch.Tensor


def frame_seed(view) -> torch.Tensor:
    """(total_samples + time * 10000) as int32, the per-frame RNG seed."""
    return (view.total_samples.to(torch.float32) + view.time * 10000.0).to(torch.int32)


def pixel_grid(height: int, width: int, device,
               row_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(py, px) int32 pixel coordinates of an (H, W) image, or of the
    (H, W) row band that starts at image row `row_offset`."""
    py = torch.arange(row_offset, row_offset + height, dtype=torch.int32,
                      device=device)[:, None].expand(height, width)
    px = torch.arange(width, dtype=torch.int32, device=device)[None, :].expand(height, width)
    return py, px


def _nee(scene, view, any_hit, rng_state, origin, throughput, active,
         radiance, reservoirs, px, full_width):
    """Next-event estimation: sun (reference.rgen:63-79) + one point light
    (reference.rgen:80-125). Both visibility queries run as ONE any-hit
    traversal over a doubled front, sun rays above light rays, with a
    per-ray t_max for the distance-limited light rays."""
    shape = rng_state.shape
    sun_dir = rayops.normalize(view.sun_dir)

    # Light selection: uniform, or the reservoir's (reference.rgen:86-109).
    use_reservoir = (px > full_width // 2) & (view.use_ris_light_sampling == 1)
    rng_state, uni_idx, uni_pdf = restirops.sample_light_uniform(
        rng_state, view.num_lights, view.max_num_lights_used)
    uni_weight = 1.0 / uni_pdf
    if reservoirs is not None:
        total_weights = torch.where(use_reservoir, reservoirs.W_sum, 1.0)
        light_index = torch.where(use_reservoir, reservoirs.Y, uni_idx)
        light_weight = torch.where(use_reservoir, reservoirs.W_X, uni_weight)
    else:
        total_weights = torch.ones(shape, dtype=torch.float32, device=origin.device)
        light_index = uni_idx
        light_weight = torch.broadcast_to(uni_weight, shape)

    valid = (total_weights != 0.0) & (light_index >= 0)
    safe_index = light_index.clamp(0, scene.light_pos.shape[0] - 1)
    lrows = restirops.select_light_rows(scene, safe_index.reshape(-1)).reshape(shape + (6,))
    to_light = lrows[..., :3] - origin
    distance_to_light = rayops.length(to_light)
    light_dir = to_light / torch.clamp_min(distance_to_light, 1e-12)[..., None]

    # One occlusion query over [sun rays; light rays]. Dead lanes, and light
    # rays whose contribution is already known zero, get zero directions.
    sun_live = (active & (view.sun_shadow_enabled == 1))[..., None]
    light_live = (active & valid & (view.lights_enabled == 1))[..., None]
    o2 = torch.cat([origin, origin], dim=0)
    d2 = torch.cat([
        torch.where(sun_live, torch.broadcast_to(sun_dir, origin.shape), 0.0),
        torch.where(light_live, light_dir, 0.0),
    ], dim=0)
    tmax2 = torch.cat([torch.full(shape, 1e4, dtype=torch.float32, device=origin.device),
                       distance_to_light * (1.0 - 1e-4)], dim=0)
    occluded2 = any_hit(scene, o2, d2, 1e-3, tmax2)
    n = shape[0]
    sun_occluded = occluded2[:n]
    light_occluded = occluded2[n:]

    # Sun contribution (reference.rgen:70-79).
    sun_visible = active & ~sun_occluded & (view.sun_shadow_enabled == 1)
    radiance = radiance + torch.where(sun_visible[..., None], throughput, 0.0)

    # Light contribution (reference.rgen:111-125); p_hat from the rows above.
    lum = 0.2126 * lrows[..., 3] + 0.7152 * lrows[..., 4] + 0.0722 * lrows[..., 5]
    d2l = distance_to_light * distance_to_light
    p_hat = torch.where(light_index < 0, 0.0, lum / torch.clamp_min(d2l, 1e-12))
    contrib = (p_hat * light_weight)[..., None] * throughput
    take = active & valid & ~light_occluded & (view.lights_enabled == 1)
    return rng_state, radiance + torch.where(take[..., None], contrib, 0.0)


def path_trace(scene, view, cfg, accumulation: torch.Tensor,
               reservoirs: restirops.Reservoir | None = None,
               closest_hit: Callable = intersect.closest_hit_bruteforce,
               any_hit: Callable | None = None, row_offset: int = 0,
               full_size: tuple[int, int] | None = None,
               sky_fn: Callable | None = None, dynamic=None) -> PathTraceResult:
    """One frame of the reference path tracer over the full image, or over
    one row band of it.

    accumulation: (H, W, 3) f32 linear accumulation of the previous frames.
    reservoirs: spatial-reuse output for reservoir NEE (None = uniform only).
    closest_hit / any_hit: the scene's hit queries (ops/bvh.py); any_hit
    defaults to closest_hit's hit flag.
    row_offset / full_size: `accumulation` is the band of image rows
    [row_offset, row_offset + H) of a (full_height, full_width) image
    (parallel/tiles.py): pixel coordinates, camera mapping and RNG seeds are
    the image's, so the bands of a frame are the rows of the whole frame.
    sky_fn(origin, unit direction, view): the miss radiance; None
    integrates the atmosphere per miss ray.
    dynamic: an ``ops/mc_bvh.py`` DynamicScene (the animated marching-cubes
    isosurface), traced beside the scene by both queries; its hits shade
    with the MC normals and material.
    """
    if any_hit is None:
        def any_hit(s, o, d, t_min=1e-3, t_max=1e4):
            return closest_hit(s, o, d, t_min, t_max).is_hit

    if dynamic is not None:
        closest_hit = mc_bvh.combine_closest_hit(closest_hit, dynamic)
        any_hit = mc_bvh.combine_any_hit(any_hit, dynamic)
    height, width = accumulation.shape[:2]
    full_height, full_width = (height, width) if full_size is None else full_size
    dev = accumulation.device
    py, px = pixel_grid(height, width, dev, row_offset)
    rng_state = rngmod.init_rng(px, py, full_width, frame_seed(view))
    sun_dir = rayops.normalize(view.sun_dir)

    pixel_color = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    rays_traced = torch.zeros((), dtype=torch.float32, device=dev)
    front_max = torch.zeros((), dtype=torch.int64, device=dev)
    ended_lanes = torch.zeros((), dtype=torch.int64, device=dev)

    for _s in range(cfg.samples_per_frame):
        rng_state, jx = rngmod.random_float(rng_state)
        rng_state, jy = rngmod.random_float(rng_state)
        origin, direction = rayops.generate_camera_rays(
            view.inverse_view, view.inverse_projection,
            px.to(torch.float32) + jx, py.to(torch.float32) + jy, full_width, full_height)

        radiance = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        throughput = torch.ones((height, width, 3), dtype=torch.float32, device=dev)
        active = torch.ones((height, width), dtype=torch.bool, device=dev)
        rays_traced = torch.zeros((), dtype=torch.float32, device=dev)
        rays_count = torch.zeros((), dtype=torch.int64, device=dev)

        for _bounce in range(cfg.num_bounces):
            live = rayops.dot(direction, direction) > 0.0
            rays_traced = rays_traced + live.to(torch.float32).sum()
            front = live.sum()
            rays_count = rays_count + front
            front_max = torch.maximum(front_max, front)
            hit = closest_hit(scene, origin, direction)
            missed = ~hit.is_hit

            # Miss shader (reference.rmiss): the furnace test's constant
            # white, the atmosphere sky, clamped, or the captured environment.
            if cfg.furnace_test:
                sky = torch.ones((height, width, 3), dtype=torch.float32, device=dev)
            elif sky_fn is not None:
                sky = sky_fn(origin, rayops.normalize(direction), view)
            else:
                sky = atmosphere.sky_radiance(origin, rayops.normalize(direction),
                                              sun_dir, view.sky_enabled)

            surf = intersect.surface_at_hit(scene, hit, origin, direction)
            if dynamic is not None:
                surf = mc_bvh.surface_patch(dynamic, hit, direction, surf)
            rng_state, sc = materials.scatter(scene, surf.material, direction,
                                              surf.normal, surf.uv, rng_state)

            hit_color = torch.where(missed[..., None], sky, sc.color)
            throughput = torch.where(active[..., None], throughput * hit_color, throughput)

            # Sky or absorbed (diffuse light): terminate, adding throughput
            # (reference.rgen:52-57).
            terminated = active & (missed | ~sc.is_scattered)
            radiance = radiance + torch.where(terminated[..., None], throughput, 0.0)
            active = active & ~terminated

            # A zero or non-finite scattered direction ends the lane here,
            # adding nothing.
            ended = active & ((sc.direction == 0.0).all(dim=-1)
                              | ~torch.isfinite(sc.direction).all(dim=-1))
            ended_lanes = ended_lanes + ended.sum()
            active = active & ~ended

            # Advance (reference.rgen:59-61); finished lanes get a zero
            # direction, which the traversal retires on entry.
            new_origin = rayops.offset_ray(surf.position, surf.normal)
            origin = torch.where(active[..., None], new_origin, origin)
            direction = torch.where(active[..., None], sc.direction, 0.0)

            rng_state, radiance = _nee(scene, view, any_hit, rng_state, origin,
                                       throughput, active, radiance, reservoirs,
                                       px, full_width)
            rays_traced = rays_traced + 2.0 * active.to(torch.float32).sum()
            front = 2 * active.sum()
            rays_count = rays_count + front
            front_max = torch.maximum(front_max, front)

        pixel_color = pixel_color + radiance

    # Progressive accumulation (reference.rgen:130-144).
    first_frame = view.total_samples == cfg.samples_per_frame
    accumulated = torch.where(first_frame, 0.0, accumulation)
    limit = view.accumulation_limit.to(torch.int64)
    within = view.total_samples <= limit
    accumulated = torch.where(within, accumulated + pixel_color, accumulated)
    denom = torch.minimum(view.total_samples, limit).to(torch.float32)
    out = linear_to_srgb(accumulated / torch.clamp_min(denom, 1.0))
    PROFILER.count("pt/rays", rays_count, front_max)
    PROFILER.count("pt/ended", ended_lanes, ended_lanes)
    return PathTraceResult(output=out, accumulation=accumulated,
                           rays_traced=rays_traced)

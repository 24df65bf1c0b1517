"""The flagship path-traced frame over row bands: the BVH gbuffer hit
positions, the whole ReSTIR chain and the reference path tracer with
reservoir NEE (the PT graph of renderers/__init__.py), each rank on its
own band of the image with the scene and BVH tables whole.

Two steps read other ranks' rows, and only they communicate:
- temporal reuse backprojects into the PREVIOUS frame's spatial
  reservoirs at any pixel (camera motion bounds no row), so the four
  previous planes are gathered to full height (16 B a pixel);
- spatial reuse reads neighbours up to `cfg.spatial_radius` rows away,
  across band edges, so the temporal planes are gathered too (a halo of
  that many rows would do; the gather is the simplest correct form).
Everything else is per pixel and stays on the band. Pixel coordinates, RNG
streams and the camera mapping are the image's, so the n-rank frame's rows
are the one-rank frame's (tests/test_torch_parallel.py).
"""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.ops import pathtrace as pathtrace_ops
from rust_renderer_tpu_torch.ops import rays as rayops
from rust_renderer_tpu_torch.ops import restir as restir_ops
from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.parallel import tiles


def _gather_reservoir(r: restir_ops.Reservoir, group) -> restir_ops.Reservoir:
    """The four planes of every rank's band, stacked to full height."""
    return restir_ops.Reservoir(*(tiles.gather_rows(p, group) for p in r))


def flagship_step(scene, view, cfg, accum: torch.Tensor, prev_spatial: restir_ops.Reservoir,
                  closest_hit, any_hit, sky_fn=None, group=None,
                  full_size: tuple[int, int] | None = None):
    """One flagship PT frame over this rank's row band.

    accum: (band, W, 3); prev_spatial: the previous frame's spatial
    reservoir planes (band, W). group=None is the unsharded chain on one
    process; with a group, this rank's band of a (band * n, W) image
    (`full_size` where given). Returns (output, accumulation, spatial): the
    band's image, accumulation and spatial planes, which feed the next
    frame's temporal pass. Unsharded, with the PT graph's hit queries, it
    is the PT graph's frame bit for bit (build_path_tracing_render_graph:
    the same operations in the same order)."""
    h, w = accum.shape[:2]
    if group is not None:
        index, n = tiles.group_rank(group)
        fh, fw = (h * n, w) if full_size is None else full_size
        row_offset = index * h
    else:
        fh, fw = (h, w) if full_size is None else full_size
        row_offset = 0

    # RNG seeded by image pixel coordinates (renderers/__init__.py _rng_for).
    py, px = pathtrace_ops.pixel_grid(h, w, accum.device, row_offset)
    state0 = rngmod.init_rng(px, py, fw, pathtrace_ops.frame_seed(view))

    # 1. gbuffer hit positions: unjittered primary rays; misses get the
    # (1, 1, 1) clear position.
    o, d = rayops.generate_camera_rays(view.inverse_view, view.inverse_projection,
                                       px.to(torch.float32) + 0.5,
                                       py.to(torch.float32) + 0.5, fw, fh)
    hit = closest_hit(scene, o, d)
    hit_pos = torch.where(hit.is_hit[..., None], o + hit.t[..., None] * d, 1.0)

    # 2-3. reset + initial RIS; p_hat rides along pass to pass.
    _, initial, p_hat_i = restir_ops.initial_ris_pass(
        scene, state0, hit_pos, view.num_lights, view.max_num_lights_used,
        cfg.ris_candidates, return_p_hat=True)

    # 4. temporal reuse against the gathered previous spatial planes.
    prev_full = prev_spatial if group is None else _gather_reservoir(prev_spatial, group)
    state_t = (state0 * 9781 + 1) & rngmod.MASK32
    _, temporal, p_hat_t = restir_ops.temporal_reuse_pass(
        scene, state_t, hit_pos, initial, prev_full, view.prev_frame_projection_view,
        view.temporal_reuse_enabled, full_height=fh, p_hat_initial=p_hat_i,
        return_p_hat=True)

    # 5. spatial reuse with neighbours from the gathered temporal planes.
    temporal_full = None if group is None else _gather_reservoir(temporal, group)
    state_s = (state0 * 6271 + 1) & rngmod.MASK32
    _, spatial = restir_ops.spatial_reuse_pass(
        scene, state_s, hit_pos, temporal, view.spatial_reuse_enabled,
        cfg.spatial_neighbors, cfg.spatial_radius, temporal_full=temporal_full,
        row_offset=row_offset, p_hat_temporal=p_hat_t)

    # 6. reference PT with reservoir NEE.
    result = pathtrace_ops.path_trace(
        scene, view, cfg, accum, reservoirs=spatial, closest_hit=closest_hit,
        any_hit=any_hit, row_offset=row_offset, full_size=(fh, fw), sky_fn=sky_fn)
    return result.output, result.accumulation, spatial


def render_flagship_tiled(scene, view, cfg, accum: torch.Tensor,
                          prev_spatial: restir_ops.Reservoir, closest_hit, any_hit,
                          group=None, sky_fn=None, axis: str = "tiles"):
    """The flagship frame with the image's rows split over `group` (the
    world group by default): accum (band, W, 3) and prev_spatial's planes
    (band, W) are this rank's bands (`shard_flagship_inputs`). Returns
    this rank's (output, accumulation, spatial) bands."""
    tiles.check_axis("render_flagship_tiled", axis)
    group = group if group is not None else torch.distributed.group.WORLD
    _, n = tiles.group_rank(group)
    rows, width = accum.shape[:2]
    return flagship_step(scene, view, cfg, accum, prev_spatial, closest_hit, any_hit,
                         sky_fn=sky_fn, group=group, full_size=(rows * n, width))


def shard_flagship_inputs(group, accum: torch.Tensor, reservoirs: restir_ops.Reservoir,
                          axis: str = "tiles"):
    """This rank's band of the whole-frame state: accum (H, W, 3) and the
    reservoir planes (H, W), H divisible by the group's size."""
    tiles.check_axis("shard_flagship_inputs", axis)
    return (tiles.shard_rows(accum, group),
            restir_ops.Reservoir(*(tiles.shard_rows(p, group) for p in reservoirs)))

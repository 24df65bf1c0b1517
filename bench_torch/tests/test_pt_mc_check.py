"""The check of `pt_mc_sponza_1080p.still` on the CPU at a tiny size: its
limit file names every number the check compares, the bf16 control fails
it, and a run whose isosurface is broken underneath comes out not correct.
The scene is a small atrium with ten lights (the Sponza-sized scene's
builder at a smaller tessellation, on both sides), the camera where the
surface's pulsing sphere fills much of the frame.

The faults an isosurface can have beyond the path-traced frame's: the
surface extracted at the previous frame's time (a clock one frame late),
the any-hit walk of the surface's tree dropped (shadow rays pass through
it), and its gradient normals left unturned toward the incident ray."""

import pytest
import torch

from harness import check, cli, manifest, session
from rrt_reference import pathtraced_mc, rt_materials, scene as ref_scenes

CELL = "pt_mc_sponza_1080p.still"
TINY = {"width": 32, "height": 18, "static_config": {"num_bounces": 2, "mc_grid": 16}}
SEED = 2 ** 32 + 46  # checks unit 1
ATRIUM = {"columns": 2, "sphere_detail": 8, "clutter_count": 12, "clutter_detail": 6,
          "column_slices": 8}
# Level with the sphere, from beyond the atrium's -x wall: the sphere, the
# torus below it and the box, above the atrium.
EYE, TARGET = [-14.0, 24.0, -6.0], [10.0, 22.0, 10.0]
LIGHTS = [[-9.0 + 2.0 * i, 2.0 + (i % 3), 4.0 - (i % 5) * 2.0] for i in range(10)]


@pytest.fixture(autouse=True)
def small_atrium(monkeypatch):
    from rust_renderer_tpu_torch import models

    def program(renderer, camera):
        camera.set_position_target(EYE, TARGET)
        models.create_atrium_standin(renderer, **ATRIUM)
        for p in LIGHTS:
            renderer.add_light(position=p, color=[1.0, 1.0, 1.0])

    def reference(b):
        b.eye, b.target = EYE, TARGET
        ref_scenes._atrium(b, **ATRIUM)
        for p in LIGHTS:
            b.light(p)

    monkeypatch.setattr(models, "create_sponza_scale_mc_scene", program)
    monkeypatch.setattr(ref_scenes, "create_sponza_scale_scene", reference)
    monkeypatch.setitem(pathtraced_mc.VIEWS, "create_sponza_scale_mc_scene",
                        ("create_sponza_scale_scene", EYE, TARGET))
    monkeypatch.setitem(rt_materials.ATRIUMS, "create_sponza_scale_scene",
                        (ATRIUM["columns"], ATRIUM["clutter_count"]))


def _run(controls=()):
    cell = manifest.load_cell(CELL)
    units = max(session.check_units(SEED, cell.traffic)) + 1
    with torch.no_grad():
        return cli.run(cell, SEED, 0.0, False, "cpu", size=TINY, units=units, controls=controls)


def _over(res) -> list:
    return sorted(k for k, c in res["checks"].items() if c["value"] > c["limit"])


def test_the_limit_file_names_every_compared_number_and_bf16_fails():
    res = _run(controls=("bf16",))
    assert res["correct"], res["checks"]
    compared = set(res["checks"]) - {"failed_frames", "units_unchecked"}
    limits = manifest.load_cell(CELL).limits
    assert set(limits) == compared
    assert check.judge(res["controls"]["bf16"], limits, 0, 0)[0] is False


def test_the_surface_a_frame_late_fails(monkeypatch):
    from rust_renderer_tpu_torch.ops import marching_cubes

    extract = marching_cubes.marching_cubes
    step = manifest.load_cell(CELL).traffic["clock_step_s"]

    def late(*args, time=0.0, **kw):
        return extract(*args, time=time - step, **kw)

    monkeypatch.setattr(marching_cubes, "marching_cubes", late)
    res = _run()
    assert not res["correct"]
    # The sphere a frame smaller or larger: the frame's samples and the
    # g-buffer's positions, which the reservoirs weigh lights by, move; the
    # presented image, their mean over the unit's samples, moves less.
    assert {"accumulation_image_off", "spatial_reuse_reservoirs_W_sum_off"} <= set(
        _over(res)), _over(res)


def test_shadow_rays_through_the_surface_fail(monkeypatch):
    from rust_renderer_tpu_torch.ops import mc_bvh

    monkeypatch.setattr(mc_bvh, "combine_any_hit", lambda base_any, dyn: base_any)
    res = _run()
    assert not res["correct"]
    assert {"image_off", "accumulation_image_off"} <= set(_over(res)), _over(res)


def test_unturned_normals_fail(monkeypatch):
    from rust_renderer_tpu_torch.ops import intersect, mc_bvh

    patch = mc_bvh.surface_patch

    def unturned(dyn, hit, direction, surf):
        out = patch(dyn, hit, direction, surf)
        on = (hit.kind == intersect.HIT_DYNAMIC)[..., None]
        return out._replace(normal=torch.where(on, out.geo_normal, out.normal))

    monkeypatch.setattr(mc_bvh, "surface_patch", unturned)
    res = _run()
    assert not res["correct"]
    assert {"image_off", "accumulation_image_off"} <= set(_over(res)), _over(res)

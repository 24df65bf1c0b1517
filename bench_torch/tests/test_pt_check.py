"""The check of `pt_sponza_1080p.still` on the CPU at a tiny size: its limit
file names every number the check compares for a path-traced run, and a run
whose frames are broken underneath comes out not correct. The scene is a
small atrium with ten lights and all three scattering materials (the
Sponza-sized scene's builder at a smaller tessellation, on both sides), so
that the ReSTIR chain runs and its reservoirs are compared.

The faults a path-traced cell can have beyond a raster cell's: random
streams seeded for another frame (here one frame ahead), and state lost
between frames (the spatial reservoirs zeroed before the unit)."""

import dataclasses

import pytest
import torch

from harness import check, cli, manifest, session
from rrt_reference import pathtraced, rt_materials, scene as ref_scenes

CELL = "pt_sponza_1080p.still"
TINY = {"width": 32, "height": 18, "static_config": {"num_bounces": 2}}
SEED = 2 ** 32 + 46  # checks unit 1
ATRIUM = {"columns": 2, "sphere_detail": 8, "clutter_count": 12, "clutter_detail": 6,
          "column_slices": 8}
EYE, TARGET = [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]
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

    monkeypatch.setattr(models, "create_sponza_scale_scene", program)
    monkeypatch.setattr(ref_scenes, "create_sponza_scale_scene", reference)
    monkeypatch.setitem(rt_materials.ATRIUMS, "create_sponza_scale_scene",
                        (ATRIUM["columns"], ATRIUM["clutter_count"]))


def _run(cell=None, controls=()):
    cell = cell or manifest.load_cell(CELL)
    units = max(session.check_units(SEED, cell.traffic)) + 1
    with torch.no_grad():
        return cli.run(cell, SEED, 0.0, False, "cpu", size=TINY, units=units, controls=controls)


def _over(res) -> list:
    return sorted(k for k, c in res["checks"].items() if c["value"] > c["limit"])


def test_the_limit_file_names_every_compared_number():
    cell = manifest.load_cell(CELL)
    res = _run(cell)
    assert res["correct"], res["checks"]
    compared = set(res["checks"]) - {"failed_frames", "units_unchecked"}
    names = ["image", "accumulation_image"] + [f"spatial_reuse_reservoirs_{k}"
                                                for k in pathtraced.RESERVOIR]
    assert compared == {f"{n}_{s}" for n in names for s in ("off", "gap")} | {"pt_rays_gap"}
    assert set(cell.limits) == compared


def test_the_bf16_control_fails_the_limits():
    res = _run(controls=("bf16",))
    values = res["controls"]["bf16"]
    assert check.judge(values, manifest.load_cell(CELL).limits, 0, 0)[0] is False


def test_random_streams_one_frame_ahead_fail(monkeypatch):
    from rust_renderer_tpu_torch.ops import pathtrace

    seed = pathtrace.frame_seed
    monkeypatch.setattr(pathtrace, "frame_seed", lambda view: seed(
        dataclasses.replace(view, total_samples=view.total_samples + 1)))
    res = _run()
    assert not res["correct"]
    assert {"image_off", "accumulation_image_off", "spatial_reuse_reservoirs_Y_off"} <= set(
        _over(res))


def test_reservoirs_zeroed_before_the_unit_fail(monkeypatch):
    """The program loses its spatial reservoirs at the checked unit's start,
    after the harness copied them: the reference renders from what the
    program should have had, and the reservoirs disagree. The image does
    not read them (RIS light sampling is off by default)."""
    unit = session.Program.unit
    checked = session.check_units(SEED, manifest.load_cell(CELL).traffic)
    calls = []

    def zeroing(self, warm_up=False):
        if not warm_up:
            calls.append(1)
            if len(calls) - 1 in checked:
                for k in pathtraced.RESERVOIR:
                    self.app.graph.state[f"spatial_reuse_reservoirs_{k}"].zero_()
        return unit(self, warm_up)

    monkeypatch.setattr(session.Program, "unit", zeroing)
    res = _run()
    assert not res["correct"]
    over = _over(res)
    assert over and all(k.startswith("spatial_reuse_reservoirs_") for k in over), over
